#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dct_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. The card (``nvidia-smi`` name and power limit) and the build of
   ``dct_tpu_torch/csrc/pool_mask.cu`` with nvcc for sm_90a.
2. Each of the four CUDA kernels at the shapes ENet's main path gives it
   (8 images at 256²), in fp32 and bf16, held bit-equal to its plain PyTorch
   version on tie-dense integer-valued inputs (the unpool pair through masks
   the pool makes from them), with one NaN window in the pool's forward, a
   NaN in y and a NaN and an inf in g at masked-out corners; all four also
   at ragged shapes (spans off 16 bytes, odd w·c) and from pointers off 16
   bytes, which run the kernels' scalar edge path, at 4096 channels (over
   48 KB of shared memory a block in fp32) and at more row pairs than a
   grid has rows. Then each is timed with CUDA events beside its byte
   bound, one PyTorch library call that computes the same function and a
   ``copy_`` that moves as many bytes; a near-empty kernel is timed the
   same way: the launch floor.
3. Two full-width ENets (4 classes) take 3 co-training iterations in fp32
   (jsd, adv, augmentation on; TF32 off) on a synthetic 1674×256×256 uint8
   dataset; losses must be finite and the kernel counters must show 24
   forward and 24 backward launches per iteration. One train-mode forward
   and input gradient on the card is held against the same net in float64
   on the CPU.
4. ``bench.py``'s workload in bf16 (K=2, 4+4 images, 256², jsd + FGSM,
   augmentation): warm-up, then 30 timed iterations → images/s; then 3
   iterations under ``torch.profiler``, whose table of device and host
   time by op goes to ``chiprun_out/profile_bf16.txt``.

It ends with the ``kernels`` JSON line and, last, one JSON object
``{"ok": true, "device": {...}}``. It exits non-zero, with no result, when
no CUDA device is present or the ``dct_tpu_torch`` package is not beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
N_IMG = 8                      # images per ENet forward at the FGSM steps
# (kernel, NHWC input shape at the main path, where ENet launches it)
POOL_SHAPES = [((N_IMG, 128, 128, 14), "bottleneck_1_0"),
               ((N_IMG, 64, 64, 64), "bottleneck_2_0")]
UNPOOL_SHAPES = [((N_IMG, 32, 32, 64), "bottleneck_4_0"),
                 ((N_IMG, 64, 64, 14), "bottleneck_5_0")]
# full-resolution shapes (the pool's input, the unpool's mask and output)
# whose spans are not whole 16-byte vectors (pooled w·c odd in the fourth;
# the fifth runs channel pairs with a head and a tail); one pooled column of
# 4096 channels (over 48 KB of shared memory a pool block in fp32); 65,538
# row pairs, more than a grid has rows
RAGGED_POOL_SHAPES = [(1, 2, 2, 1), (3, 6, 10, 3), (2, 130, 34, 14), (2, 6, 14, 5),
                      (2, 6, 10, 4), (1, 2, 4, 4096), (2, 65538, 4, 2)]
REPLACES = {
    "pool_mask_fwd": "dct_tpu/ops/pallas_pool.py:52 (max_pool_2x2_with_mask_pallas, pallas_call :61)",
    "pool_mask_bwd": "dct_tpu/ops/pallas_pool.py:52 (autodiff of max_pool_2x2_with_mask_pallas)",
    "unpool_fwd": "dct_tpu/ops/pallas_pool.py:82 (mask_unpool_2x2_pallas, pallas_call :89)",
    "unpool_bwd": "dct_tpu/ops/pallas_pool.py:82 (autodiff of mask_unpool_2x2_pallas)",
}
SOURCE = "dct_tpu_torch/csrc/pool_mask.cu"
OUT_DIR = Path("chiprun_out")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def same(a, b) -> bool:
    """Equal values, NaN where the other is NaN (-0.0 equals 0.0)."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs_err(a, b) -> float:
    import torch
    d = (a.float() - b.float()).abs()
    return float(torch.nan_to_num(d, nan=0.0).max())


def device_ms(fn, arg_sets, reps: int = 20) -> float:
    """Device time of one ``fn(*args)`` call, from CUDA events around ``reps``
    calls enqueued behind a sleep kernel (so host launch overhead is hidden)
    and cycling through ``arg_sets`` (so the working set exceeds L2)."""
    import torch
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[0])                         # host time to enqueue one call
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # ≥ 50 ms, and twice the enqueue time of all reps, at the ~2 GHz clock
    torch.cuda._sleep(int(1e8 + 2 * 2e9 * reps * enqueue_s))
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_pool_exact(torch, pk, plain, ints, shape, dtype, errs,
                     offset=0) -> None:
    """pool_mask_fwd (with and without a NaN window) and pool_mask_bwd
    bit-equal to the plain versions on one tie-dense input. ``offset``
    elements in front of x in its buffer move its pointer off 16 bytes."""
    n, hh, ww, c = shape
    buf = ints((offset + math.prod(shape),), 0, 4, dtype)   # dense in ties
    x = buf[offset:].view(shape)
    x_nan = buf.clone()[offset:].view(shape)
    x_nan[0, 0, 1, 0] = float("nan")
    what = f"{shape} {dtype}" + (f" at offset {offset}" if offset else "")
    for xx in (x, x_nan):
        pk_out = pk.max_pool_2x2_with_mask_kernel(xx)
        pl_out = plain.max_pool_2x2_with_mask(xx)
        for a, b in zip(pk_out, pl_out):
            if not same(a, b):
                raise AssertionError(f"pool_mask_fwd {what} differs")
            errs["pool_mask_fwd"] = max(errs["pool_mask_fwd"], max_abs_err(a, b))
    if float(pk_out[1][0, 1, 1, 0]) != 1.0:
        raise AssertionError("a NaN window must set its mask at (1,1)")
    g = ints((n, hh // 2, ww // 2, c), -3, 4, dtype)
    grads = []
    for fn in (pk.max_pool_2x2_with_mask_kernel, plain.max_pool_2x2_with_mask):
        xr = buf.clone()[offset:].view(shape).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xr)[0], xr, g)[0])
    if not same(*grads):
        raise AssertionError(f"pool_mask_bwd {what} differs")
    errs["pool_mask_bwd"] = max(errs["pool_mask_bwd"], max_abs_err(*grads))


def check_unpool_exact(torch, pk, plain, ints, shape, dtype, errs,
                       offset=0) -> None:
    """unpool_fwd (with and without a NaN in y) and unpool_bwd (with and
    without a NaN and an inf in g at masked-out corners) bit-equal to the
    plain versions, through the mask the pool makes from a tie-dense input
    of the full-resolution ``shape``. ``offset`` elements in front of y, the
    mask and g in their buffers move their pointers off 16 bytes."""
    n, hh, ww, c = shape
    small = (n, hh // 2, ww // 2, c)

    def placed(t):
        """t's values, ``offset`` elements into a buffer of their own."""
        buf = torch.empty(offset + t.numel(), dtype=dtype, device="cuda")
        buf[offset:] = t.flatten()
        return buf[offset:].view(t.shape)

    what = f"{shape} {dtype}" + (f" at offset {offset}" if offset else "")
    mask = placed(plain.max_pool_2x2_with_mask(ints(shape, 0, 4, dtype))[1])
    y = placed(ints(small, -3, 4, dtype))
    y_nan = placed(y)
    y_nan[0, 0, 0, 0] = float("nan")
    for yy in (y, y_nan):
        a = pk.mask_unpool_2x2_kernel(yy, mask)
        b = plain.mask_unpool_2x2(yy, mask)
        if not same(a, b):
            raise AssertionError(f"unpool_fwd {what} differs")
        errs["unpool_fwd"] = max(errs["unpool_fwd"], max_abs_err(a, b))
    if not bool(torch.isnan(a[0, :2, :2, 0]).all()):
        raise AssertionError("a NaN in y must spread over its window")
    g = placed(ints(shape, -3, 4, dtype))
    g_bad = placed(g)
    hidden = [int(i) for i in (mask.flatten() == 0).nonzero()[[0, -1], 0]]
    g_bad.view(-1)[hidden[0]] = float("nan")     # two masked-out corners
    g_bad.view(-1)[hidden[1]] = float("inf")
    for gg in (g, g_bad):
        grads = []
        for fn in (pk.mask_unpool_2x2_kernel, plain.mask_unpool_2x2):
            yr = placed(y).requires_grad_(True)
            grads.append(torch.autograd.grad(fn(yr, mask), yr, gg)[0])
        if not same(*grads):
            raise AssertionError(f"unpool_bwd {what} differs")
        errs["unpool_bwd"] = max(errs["unpool_bwd"], max_abs_err(*grads))
    for f in hidden:
        i, r, col, ch = np.unravel_index(f, shape)
        if not bool(torch.isnan(grads[0][i, r // 2, col // 2, ch])):
            raise AssertionError("a NaN or an inf in g at a masked-out corner "
                                 f"must make gy NaN ({what})")


def check_kernels(torch, pk, plain):
    """Phase 2: bit-equality and timing of the four kernels."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda").to(dtype)

    detail, errs = [], {k: 0.0 for k in pk.KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for shape in RAGGED_POOL_SHAPES:
            for check in (check_pool_exact, check_unpool_exact):
                check(torch, pk, plain, ints, shape, dtype, errs)
        for check in (check_pool_exact, check_unpool_exact):
            check(torch, pk, plain, ints, RAGGED_POOL_SHAPES[1], dtype, errs,
                  offset=1)
        for shape, where in POOL_SHAPES:
            n, hh, ww, c = shape
            small = (n, hh // 2, ww // 2, c)
            check_pool_exact(torch, pk, plain, ints, shape, dtype, errs)

            big, sml = math.prod(shape) * esize, math.prod(small) * esize
            copies = max(2, math.ceil(2.0e8 / (2 * big + sml)))
            xs = [(ints(shape, 0, 4, dtype),) for _ in range(copies)]
            xg = [(a[0], ints(small, -3, 4, dtype)) for a in xs]
            nchw = [(a[0].permute(0, 3, 1, 2),) for a in xs]
            idx = [F.max_pool2d(a[0], 2, return_indices=True)[1] for a in nchw]
            with torch.no_grad():
                rows = [
                    ("pool_mask_fwd", big + sml + big,
                     device_ms(lambda t: pk._PoolMask.apply(t), xs),
                     device_ms(plain.max_pool_2x2_with_mask, xs),
                     device_ms(lambda t: F.max_pool2d(t, 2, return_indices=True), nchw)),
                    ("pool_mask_bwd", big + sml + big,
                     device_ms(lambda t, gg: pk._PoolMask.backward(_Ctx(t), gg, None), xg),
                     device_ms(_plain_pool_bwd(torch, plain), xg),
                     device_ms(lambda t, gg, i: torch.ops.aten.max_pool2d_with_indices_backward(
                         gg.permute(0, 3, 1, 2), t.permute(0, 3, 1, 2), [2, 2], [2, 2],
                         [0, 0], [1, 1], False, i),
                         [(a, gg, i) for (a, gg), i in zip(xg, idx)])),
                ]
            copy = copy_ms(torch, 2 * big + sml)
            detail += [timing_row(name, where, shape, dtype, nbytes, ms, plain_ms,
                                  lib_ms, copy) for name, nbytes, ms, plain_ms, lib_ms in rows]

        for shape, where in UNPOOL_SHAPES:
            n, h, w, c = shape
            full = (n, 2 * h, 2 * w, c)
            check_unpool_exact(torch, pk, plain, ints, full, dtype, errs)

            big, sml = math.prod(full) * esize, math.prod(shape) * esize
            copies = max(2, math.ceil(2.0e8 / (2 * big + sml)))
            sets, lib = [], []
            for _ in range(copies):
                xf = ints(full, 0, 4, dtype)
                m = plain.max_pool_2x2_with_mask(xf)[1]
                yy, gg = ints(shape, -3, 4, dtype), ints(full, -3, 4, dtype)
                sets.append((yy, m, gg))
                # the library calls take NCHW-contiguous tensors and flat
                # argmax indices, prepared here outside the timed region
                i = F.max_pool2d(xf.permute(0, 3, 1, 2).contiguous(), 2,
                                 return_indices=True)[1]
                lib.append((yy.permute(0, 3, 1, 2).contiguous(), i,
                            gg.permute(0, 3, 1, 2).reshape(n, c, -1),
                            i.reshape(n, c, -1)))
            with torch.no_grad():
                rows = [
                    ("unpool_fwd", sml + big + big,
                     device_ms(lambda yy, m, gg: pk._Unpool.apply(yy, m), sets),
                     device_ms(lambda yy, m, gg: plain.mask_unpool_2x2(yy, m), sets),
                     device_ms(lambda yc, i, gf, iflat: F.max_unpool2d(
                         yc, i, 2, output_size=full[1:3]), lib)),
                    ("unpool_bwd", big + big + sml,
                     device_ms(lambda yy, m, gg: pk._Unpool.backward(_Ctx(m), gg), sets),
                     device_ms(_plain_unpool_bwd(torch, plain), sets),
                     device_ms(lambda yc, i, gf, iflat: torch.gather(gf, 2, iflat), lib)),
                ]
            copy = copy_ms(torch, 2 * big + sml)
            detail += [timing_row(name, where, shape, dtype, nbytes, ms, plain_ms,
                                  lib_ms, copy) for name, nbytes, ms, plain_ms, lib_ms in rows]
    return detail, errs


def timing_row(name, where, shape, dtype, nbytes, ms, plain_ms, lib_ms, copy):
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"name": name, "where": where, "shape": list(shape),
            "dtype": str(dtype).split(".")[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / ms, "copy_ms": copy}


def copy_ms(torch, nbytes: int) -> float:
    """Device time of one ``Tensor.copy_`` that moves ``nbytes`` in all
    (half read, half written), inputs rotated over ≥ 200 MB like the
    kernels': what the memory system takes for that many bytes."""
    n = nbytes // 8                                  # fp32 elements per side
    srcs = [(torch.ones(n, device="cuda"),) for _ in range(max(2, math.ceil(2e8 / nbytes)))]
    return device_ms(lambda t: torch.empty_like(t).copy_(t), srcs)


def launch_floor_ms(torch) -> float:
    """Device time per launch of a near-empty kernel (a sleep of a few
    cycles) under the same device_ms harness as the kernels."""
    return device_ms(lambda: torch.cuda._sleep(8), [()])


class _Ctx:
    """Stands in for autograd's ctx so a backward can be timed on its own."""

    def __init__(self, saved):
        self.saved_tensors = (saved,)


def _plain_pool_bwd(torch, plain):
    def run(x, g):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            return torch.autograd.grad(plain.max_pool_2x2_with_mask(xr)[0], xr, g)[0]
    return run


def _plain_unpool_bwd(torch, plain):
    def run(y, m, g):
        with torch.enable_grad():
            yr = y.detach().requires_grad_(True)
            return torch.autograd.grad(plain.mask_unpool_2x2(yr, m), yr, g)[0]
    return run


def build_models(torch, Segmentator, dtype_name, seed):
    arch = {"name": "enet", "num_classes": 4, "compute_dtype": dtype_name}
    optim = {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    sched = {"name": "StepLR", "step_size": 90, "gamma": 0.1}
    return [Segmentator(arch, optim, sched,
                        torch.Generator().manual_seed(seed + i), device="cuda")
            for i in range(2)]


def run_step(torch, pk, make_epoch, ce, segs, img_u8, gt_u8, rs, T, gen):
    """T co-training iterations of bench.py's workload; returns
    (metrics, seconds, launches) with the counters reset just before."""
    K, B, Bu, N = 2, 4, 4, img_u8.shape[0]
    epoch = make_epoch(segs, 4, ce, train_jsd=True, train_adv=True,
                       augment_labeled=True, augment_unlabeled=True, eps_fgsm=0.03)
    idx_lab = rs.randint(0, N, (T, K, B))
    idx_unlab = rs.randint(0, N, (T, Bu))
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    m = epoch(img_u8, gt_u8, idx_lab, idx_unlab, None, gen, 1e-3, 0.5, 0.05)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    for name in ("sup_loss", "jsd_loss", "adv_loss"):
        if not bool(torch.isfinite(m[name]).all()):
            raise AssertionError(f"non-finite {name}: {m[name]}")
    for name, count in launches.items():
        if count != 12 * T:          # 6 forwards (or backwards) × 2 per iteration
            raise AssertionError(f"{name} launched {count} times in {T} "
                                 f"iterations, expected {12 * T}: {launches}")
    return m, dt, launches


def check_reference(torch, Enet, ce):
    """One train-mode forward + CE input gradient on the card (fp32, TF32
    off, CUDA kernels) against the same weights in float64 on the CPU."""
    gen = torch.Generator().manual_seed(5)
    net = Enet(4)
    from dct_tpu_torch.models.layers import init_weights_
    init_weights_(net, gen)
    x = torch.randint(0, 256, (2, 64, 64, 1), generator=gen).float() / 255.0
    gt = torch.randint(0, 4, (2, 64, 64), generator=gen)
    out = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = Enet(4)
        m.load_state_dict(net.state_dict())
        m = m.to(dev, dt, memory_format=torch.channels_last).train()
        xx = x.to(dev, dt).requires_grad_(True)
        logits = m(xx)
        (g,) = torch.autograd.grad(ce(logits, gt.to(dev)), [xx])
        out[dev] = (logits.detach().cpu().double(), g.cpu().double())
    errs = {}
    for i, name in enumerate(("logits", "input_grad")):
        ref = out["cpu"][i]
        err = float((out["cuda"][i] - ref).abs().max() / ref.abs().max())
        errs[name] = err
        if not err < 1e-3:
            raise AssertionError(f"{name} on the card differs from the float64 "
                                 f"CPU reference by {err:.3g} of its scale")
    return errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dct_tpu_torch.losses import get_loss_fn
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.models.enet import Enet
    from dct_tpu_torch.ops import pool_kernels as pk
    from dct_tpu_torch.ops import pooling as plain
    from dct_tpu_torch.train.steps import make_cotrain_epoch

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    log = pk.build()
    print(f"phase 1: built {SOURCE} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    detail, errs = check_kernels(torch, pk, plain)
    print("phase 2: 4 kernels bit-equal to their plain versions "
          "(fp32, bf16, ties, NaN window, NaN in y, NaN and inf in g at "
          "masked-out corners; at the main-path shapes, at ragged shapes "
          f"{RAGGED_POOL_SHAPES} and off 16 bytes)", flush=True)
    print(json.dumps({"kernel_detail": detail, "card": card}), flush=True)
    print(json.dumps({"launch_floor_ms": launch_floor_ms(torch), "card": card}),
          flush=True)

    ce = get_loss_fn("cross_entropy")
    ref_errs = check_reference(torch, Enet, ce)
    print(f"phase 3: card vs float64 CPU reference (share of scale): {ref_errs}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    N, H = 1674, 256                                   # ACDC train-slice count
    img_u8 = torch.randint(0, 255, (N, H, H), generator=gen, device="cuda",
                           dtype=torch.uint8)
    gt_u8 = torch.randint(0, 4, (N, H, H), generator=gen, device="cuda",
                          dtype=torch.uint8)
    rs = np.random.RandomState(0)
    segs = build_models(torch, Segmentator, "float32", 0)
    m, dt, _ = run_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8,
                        gt_u8, rs, 3, gen)
    print(f"phase 3: fp32 step, 3 iterations in {dt:.2f} s, sup "
          f"{m['sup_loss'][-1].tolist()} jsd {float(m['jsd_loss'][-1]):.5f} "
          f"adv {float(m['adv_loss'][-1]):.5f}; 24 + 24 launches/iteration", flush=True)

    segs = build_models(torch, Segmentator, "bfloat16", 10)
    run_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8, gt_u8, rs, 3, gen)
    T = 30
    torch.cuda.reset_peak_memory_stats()
    m, dt, launches = run_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8,
                               gt_u8, rs, T, gen)
    ips = 12 * T / dt
    print(json.dumps({"metric": "cotrain_images_per_sec", "value": ips,
                      "unit": "images/sec", "dtype": "bfloat16", "iterations": T,
                      "seconds": dt,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "card": card}), flush=True)

    profile_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8, gt_u8, rs, gen)

    kernels = []
    for name in pk.KERNELS:
        rows = [r for r in detail if r["name"] == name and r["dtype"] == "bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name],
            # one launch at each of the kernel's two main-path shapes, bf16
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in rows)})
        kernels[-1]["bound_share"] = kernels[-1]["bound_ms"] / kernels[-1]["ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_step(torch, pk, make_epoch, ce, segs, img_u8, gt_u8, rs, gen):
    """Device time by kernel over 3 bf16 iterations → chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step(torch, pk, make_epoch, ce, segs, img_u8, gt_u8, rs, 3, gen)
    OUT_DIR.mkdir(exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT_DIR / "profile_bf16.txt").write_text(table)
    totals = [line for line in table.splitlines() if "time total" in line]
    print(f"phase 4: profile of 3 bf16 iterations ({'; '.join(totals)}) "
          f"-> {OUT_DIR / 'profile_bf16.txt'}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
