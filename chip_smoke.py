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
   grid has rows; and at the eval step's shapes, one padded patient bucket
   of 16 slices a forward. Then each is timed with CUDA events beside its byte
   bound, one PyTorch library call that computes the same function and a
   ``copy_`` that moves as many bytes; a near-empty kernel is timed the
   same way: the launch floor.
3. Two full-width ENets (4 classes) take 3 co-training iterations in fp32
   (jsd, adv, augmentation on; PyTorch's precision defaults, as the CLI
   runs) on a synthetic 1674×256×256 uint8 dataset; losses must be finite
   and the kernel counters must show 24 forward and 24 backward launches
   per iteration. One train-mode forward and input gradient on the card
   (TF32 off for this comparison only) is held against the same net in
   float64 on the CPU.
4. ``bench.py``'s workload in bf16 (K=2, 4+4 images, 256², jsd + FGSM,
   augmentation): warm-up, then 30 timed iterations → images/s; then 3
   iterations under ``torch.profiler``, whose table of device and host
   time by op goes to ``chiprun_out/profile_bf16.txt``.

5. The co-training CLI at full width: ``dct_tpu_torch.train_cotraining``
   on ``configs/acdc_cotraining.yaml`` as it ships (fp32, two full ENets,
   K=2, B=Bu=4, 256²) with jsd and FGSM on, over a synthetic ACDC-style PNG
   tree written under ``build/`` from a seed (100 train patients × 16
   slices, 20 val patients of 8–16 slices), 2 epochs of 20 iterations, then
   a resume from its checkpoints to epoch 3. Losses must be finite, the CSV
   must carry dct_tpu's columns (the header of
   ``results/ACDC_cotrain_r3/metrics.csv``) for epochs 0–2, every val dice
   must lie in [0, 1], the checkpoints must exist, ``best_0.ckpt`` reloaded
   into a fresh Segmentator must reproduce its epoch's CSV 3D dice, and each
   eval forward must launch ``pool_mask_fwd`` and ``unpool_fwd`` twice and
   no backward kernel. Then the trained weights of
   ``results/ACDC_cotrain_r3/best_0.ckpt`` run one eval-mode forward on the
   card over one padded 16-slice val bucket (the shape the eval step
   launches; TF32 off for this comparison only), held against the same net
   in float64 on the CPU.

It ends with the ``kernels`` JSON line and, last, one JSON object
``{"ok": true, "device": {...}}``. It exits non-zero, with no result, when
no CUDA device is present or the ``dct_tpu_torch`` package is not beside it.
"""
from __future__ import annotations

import contextlib
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
# the eval step's forwards: one patient bucket, the slices of the longest
# val patient (16 in phase 5's tree, as in ACDC) padded to a multiple of 8
EVAL_L = 16
EVAL_POOL_SHAPES = [(EVAL_L,) + shape[1:] for shape, _ in POOL_SHAPES]
EVAL_UNPOOL_SHAPES = [(EVAL_L,) + shape[1:] for shape, _ in UNPOOL_SHAPES]
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
        for shape in EVAL_POOL_SHAPES:
            check_pool_exact(torch, pk, plain, ints, shape, dtype, errs)
        for n, h, w, c in EVAL_UNPOOL_SHAPES:
            check_unpool_exact(torch, pk, plain, ints, (n, 2 * h, 2 * w, c), dtype, errs)
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


@contextlib.contextmanager
def tf32_off(torch):
    """TF32 off for cuDNN and matmuls inside, the flags restored after: the
    float64 comparisons hold the card's fp32 arithmetic, not TF32's."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    old = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, old):
            f.allow_tf32 = v


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
        with tf32_off(torch):
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

    detail, errs = check_kernels(torch, pk, plain)
    print("phase 2: 4 kernels bit-equal to their plain versions "
          "(fp32, bf16, ties, NaN window, NaN in y, NaN and inf in g at "
          "masked-out corners; at the main-path shapes, at the eval shapes "
          f"{EVAL_POOL_SHAPES} (pool) and {EVAL_UNPOOL_SHAPES} (unpool), at "
          f"ragged shapes {RAGGED_POOL_SHAPES} and off 16 bytes)", flush=True)
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
    del segs, img_u8, gt_u8

    cli = run_cli(torch, pk, card)

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
            "library_ms": sum(r["library_ms"] for r in rows),
            "launches_cli": cli["launches"][name],
            "launches_eval": cli["eval_launches"][name]})
        kernels[-1]["bound_share"] = kernels[-1]["bound_ms"] / kernels[-1]["ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def write_acdc_tree(root: Path, seed: int = 0) -> None:
    """An ACDC-style PNG tree, root/{train,val}/{img,gt}/patientPPP_01_0_S.png
    at 256²: concentric rings (gt) and a noisy rendering of them (img), so a
    segmenter can learn the mapping. 100 train patients × 16 slices; 20 val
    patients of 8–16 slices, unequal so that the eval buckets pad."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    size, n_classes = 256, 4
    yy, xx = np.mgrid[0:size, 0:size]
    for mode, counts in (("train", [16] * 100),
                         ("val", rs.randint(8, 17, size=20).tolist())):
        for sub in ("img", "gt"):
            (root / mode / sub).mkdir(parents=True, exist_ok=True)
        for p, n_slices in enumerate(counts, start=1):
            for s in range(n_slices):
                cy, cx = size / 2 + rs.randint(-24, 25), size / 2 + rs.randint(-24, 25)
                r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
                gt = np.zeros((size, size), np.uint8)
                for c in range(1, n_classes):
                    gt[r < size * (0.4 - 0.1 * (c - 1))] = c
                img = (gt.astype(np.float32) / (n_classes - 1) * 180
                       + rs.randn(size, size) * 12 + 40).clip(0, 255).astype(np.uint8)
                stem = f"patient{p:03d}_01_0_{s}"
                Image.fromarray(img).save(root / mode / "img" / f"{stem}.png")
                Image.fromarray(gt).save(root / mode / "gt" / f"{stem}.png")


def run_cli(torch, pk, card: str) -> dict:
    """Phase 5: the co-training CLI at full width, two epochs and a resume
    to a third, checked as the module docstring says. Returns the launches
    of the whole run and of its eval passes."""
    import csv
    import shutil
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.data.dataset import MedicalImageDataset
    from dct_tpu_torch.data.pipeline import PatientBuckets
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train import CoTrainer
    from dct_tpu_torch.train import cotrainer as cot
    from dct_tpu_torch.train.steps import make_eval_all_models_step
    from dct_tpu_torch.train_cotraining import main as cli_main

    tree, run = Path("build/acdc_synthetic"), Path("build/cli_run")
    t0 = time.perf_counter()
    shutil.rmtree(tree, ignore_errors=True)
    shutil.rmtree(run, ignore_errors=True)
    write_acdc_tree(tree)
    print(f"phase 5: wrote the synthetic tree in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # per-epoch wall time and the launches of each eval pass, read around
    # the trainer's own methods
    epochs, eval_launches = [], {k: 0 for k in pk.KERNELS}
    eval_forwards = [0]
    run_epoch, eval_epoch = CoTrainer._run_epoch, CoTrainer._eval_epoch

    def timed_run_epoch(self, epoch, *args):
        t = time.perf_counter()
        run_epoch(self, epoch, *args)
        epochs.append((epoch, time.perf_counter() - t))

    def counted_eval_epoch(self, *args):
        before = dict(pk.LAUNCHES)
        out = eval_epoch(self, *args)
        torch.cuda.synchronize()
        for k in pk.KERNELS:
            eval_launches[k] += pk.LAUNCHES[k] - before[k]
        eval_forwards[0] += len(self.val_buckets) * self.K
        return out

    common = ["--config", "configs/acdc_cotraining.yaml",
              f"Dataset.root_dir={tree}", f"Trainer.save_dir={run}",
              "Trainer.iters_per_epoch=20", "StartTraining.train_jsd=True",
              "StartTraining.train_adv=True"]
    CoTrainer._run_epoch, CoTrainer._eval_epoch = timed_run_epoch, counted_eval_epoch
    try:
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        cli_main(common + ["Trainer.max_epoch=2"])
        trainer = cli_main(common + ["Trainer.max_epoch=3", f"Trainer.checkpoint={run}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
    finally:
        CoTrainer._run_epoch, CoTrainer._eval_epoch = run_epoch, eval_epoch

    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open("results/ACDC_cotrain_r3/metrics.csv", newline="") as f:
        ref_header = next(csv.reader(f))
    if list(rows[0].keys()) != ref_header:
        raise AssertionError(f"metrics.csv header {list(rows[0])} is not dct_tpu's {ref_header}")
    if [int(r["epoch"]) for r in rows] != [0, 1, 2]:
        raise AssertionError(f"metrics.csv epochs {[r['epoch'] for r in rows]}, expected 0, 1, 2")
    for r in rows:
        for k, v in r.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"epoch {r['epoch']}: {k} = {v}")
            if k.startswith(("val_dice", "val_batch_dice")) and not 0.0 <= float(v) <= 1.0:
                raise AssertionError(f"epoch {r['epoch']}: {k} = {v} outside [0, 1]")
    for name in ("best_0.ckpt", "best_1.ckpt", "last_0.ckpt", "last_1.ckpt",
                 "opt_state.ckpt", "metrics_0.csv", "metrics_1.csv",
                 "val_dice.npy", "val_batch_dice.npy", "scalars.jsonl", "config.yml"):
        if not (run / name).is_file():
            raise AssertionError(f"{run / name} missing")
    for k in ("pool_mask_bwd", "unpool_bwd"):
        if eval_launches[k]:
            raise AssertionError(f"{k} launched {eval_launches[k]} times in eval")
    for k in ("pool_mask_fwd", "unpool_fwd"):
        if eval_launches[k] != 2 * eval_forwards[0]:
            raise AssertionError(f"{k} launched {eval_launches[k]} times in "
                                 f"{eval_forwards[0]} eval forwards, expected 2 each")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} never launched on the CLI path: {launches}")

    # best_0.ckpt reproduces its epoch's 3D val dice
    sd = load_checkpoint(run / "best_0.ckpt")
    seg = Segmentator.from_state_dict(sd["segmentator"], device="cuda")
    val = MedicalImageDataset(tree, "val", quite=True)
    buckets = PatientBuckets(val, cot.DEFAULT_GRP_REGEX)
    if trainer.val_buckets.bucket_len != EVAL_L or buckets.bucket_len != EVAL_L:
        raise AssertionError(f"eval buckets of {trainer.val_buckets.bucket_len} "
                             f"slices, phase 2 checked the kernels at {EVAL_L}")
    out = make_eval_all_models_step([seg], 4)(
        torch.from_numpy(val.data["img"]).cuda(), torch.from_numpy(val.data["gt"]).cuda(),
        buckets.indices, buckets.mask)
    dice3d = out["dice3d"][:, 0].cpu().numpy().mean(0)
    row = rows[int(sd["best_epoch"])]
    for i in (1, 2, 3):
        csv_v = float(row[f"val_batch_dice_0_{i}"])
        if abs(dice3d[i] - csv_v) > 5.1e-5:
            raise AssertionError(f"best_0.ckpt (epoch {sd['best_epoch']}) gives "
                                 f"val_batch_dice_0_{i} {dice3d[i]:.6f}, the CSV {csv_v}")
    print(f"phase 5: CLI, 2 epochs + resume to 3 in {wall:.1f} s; best_0.ckpt "
          f"(epoch {sd['best_epoch']}) reproduces its 3D dice "
          f"{[round(float(d), 6) for d in dice3d[1:]]}; {eval_forwards[0]} eval "
          f"forwards launched {eval_launches}; CLI launches {launches}", flush=True)
    for (epoch, seconds), r in zip(epochs, rows):
        t_train, t_eval = float(r["t_train"]), float(r["t_eval"])
        print(json.dumps({"cli_epoch": epoch, "t_train": t_train, "t_eval": t_eval,
                          "t_host": seconds - t_train - t_eval,
                          "images_per_sec": float(r["images_per_sec"]),
                          "tf32_convs": torch.backends.cudnn.allow_tf32,
                          "val_batch_dice_0": [float(r[f"val_batch_dice_0_{i}"]) for i in (1, 2, 3)],
                          "card": card}), flush=True)
    del trainer, seg

    errs = check_trained_weights(torch, val, buckets)
    print(f"phase 5: trained results/ACDC_cotrain_r3/best_0.ckpt, eval forward of "
          f"a padded {EVAL_L}-slice bucket on the card vs float64 CPU (share of "
          f"scale): {errs}", flush=True)
    return {"launches": launches, "eval_launches": eval_launches}


def check_trained_weights(torch, val, buckets) -> dict:
    """The committed trained weights: one eval-mode forward on the card
    (fp32, TF32 off, CUDA kernels), through the Segmentator the eval step
    runs, of the first val patient's bucket that pads (its slices, then
    repeats of slice 0 up to the bucket length), against the same net in
    float64 on the CPU."""
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.models.enet import Enet
    from dct_tpu_torch.utils.convert import params_from_jax
    seg_sd = load_checkpoint("results/ACDC_cotrain_r3/best_0.ckpt")["segmentator"]
    padded = [p for p in range(len(buckets)) if not buckets.mask[p].all()]
    if not padded:
        raise AssertionError("no val patient pads its bucket")
    idx = buckets.indices[padded[0]]
    x = torch.from_numpy(val.data["img"][idx]).float()[..., None] / 255.0
    seg = Segmentator.from_state_dict(seg_sd, device="cuda")
    net = Enet(4)
    net.load_state_dict(params_from_jax(seg_sd["net_state_dict"], seg_sd["batch_stats"]))
    net = net.to("cpu", torch.float64, memory_format=torch.channels_last).eval()
    with tf32_off(torch), torch.inference_mode():
        out = {"cuda": seg.predict(x.cuda()).cpu().double(),
               "cpu": net(x.double())}
    err = float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max())
    if not err < 1e-3:
        raise AssertionError(f"trained eval logits on the card differ from the "
                             f"float64 CPU reference by {err:.3g} of their scale")
    return {"logits": err}


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
