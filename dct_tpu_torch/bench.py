"""Co-training throughput of the port (the root ``bench.py`` of dct_tpu),
on the card:

    python -m dct_tpu_torch.bench [--device cuda|cpu]

prints ONE JSON line with ``bench.py``'s keys, ``{"metric":
"cotrain_images_per_sec_per_chip", "value": N, "unit": "images/sec",
"vs_baseline": R, ...}``.

Workload (``bench.py``'s): two ENets, 4 classes, bf16 compute with fp32
parameters and Adam state, Adam 1e-3 with L2 1e-4, StepLR 90/0.1; 4 labeled
images per model and 4 shared unlabeled ones at 256²; jsd, FGSM (ε 0.03)
and augmentation on, the labeled and unlabeled forwards fused into one
two-group forward per model (``bench.py`` takes dct_tpu's default); λ_cot 0.5, λ_adv 0.05; T = 30 iterations a call of
``train/steps.py:make_cotrain_epoch`` on a uint8 set of 1674 slices and
labels drawn from ``np.random.RandomState(0)`` and moved to the device, the
batch indices drawn from the same ``RandomState``.

Timing: one warm-up call, then W = 5 calls, each timed alone and closed by
``torch.cuda.synchronize()``. ``value`` is the median over the calls of
(K·B + Bu)·T / seconds; ``ips_min``, ``ips_max`` and ``ips_windows`` give
the spread, since host speed moves a single call by tens of percent.
``vs_baseline`` divides by ``bench.py``'s own denominator: the reference's
torch ENet on one CPU core, 2.727 images/s.

``mfu_bf16_pct``: the FLOPs of one extra, untimed iteration, counted by
``torch.utils.flop_counter.FlopCounterMode`` (convolutions and matmuls
only, so not comparable with ``bench.py``'s XLA count, which includes
elementwise work), over the median call's time and the card's dense bf16
peak (a table keyed by the card's name; an unknown card raises).

Gates, which raise: every ``sup_loss``, ``jsd_loss`` and ``adv_loss`` of
every call finite (a NaN step can be faster), and on the card exactly 8
launches of each of the four pool kernels per iteration
(``ops/pool_kernels.LAUNCHES``; 0 on the CPU, where the kernels' plain
versions run). ``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import resolve_device
from .losses import get_loss_fn
from .models import Segmentator
from .ops import pool_kernels
from .train.steps import make_cotrain_epoch

TORCH_CPU_BASELINE_IPS = 2.727          # bench.py:24
# dense bf16 tensor-core peak by torch.cuda.get_device_name(): NVIDIA's H100
# data sheet, SXM5 part
BF16_DENSE_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}
K, B, BU, C = 2, 4, 4, 4
# 4 ENet passes × 2 of each kernel: the two fused labeled + unlabeled
# forwards (one per model), FGSM's generation forward and the adversarial
# forward, and the same four backward; 6 passes unfused
LAUNCHES_PER_ITERATION = 8
LAUNCHES_PER_ITERATION_UNFUSED = 12


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bf16_peak_flops(device_name: str) -> float:
    if device_name not in BF16_DENSE_PEAK_FLOPS:
        raise KeyError(f"no dense bf16 peak known for {device_name!r}; "
                       f"known: {sorted(BF16_DENSE_PEAK_FLOPS)}")
    return BF16_DENSE_PEAK_FLOPS[device_name]


def _check_finite(m: Dict[str, torch.Tensor]) -> None:
    for name in ("sup_loss", "jsd_loss", "adv_loss"):
        if not bool(torch.isfinite(m[name]).all()):
            raise FloatingPointError(f"non-finite {name} in a bench call: {m[name]}")


def run(device="cuda", N: int = 1674, H: int = 256, T: int = 30,
        windows: int = 5, fuse_forward: bool = True) -> dict:
    """The bench on ``device`` at N slices of H², T iterations a call, W =
    ``windows`` timed calls; returns the JSON line's dict. ``fuse_forward``
    False runs the unfused step instead (6 ENet passes, 12 launches of each
    kernel an iteration), to compare the two in one process."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    arch = {"name": "enet", "num_classes": C, "compute_dtype": "bfloat16"}
    optim = {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    sched = {"name": "StepLR", "step_size": 90, "gamma": 0.1}
    segs = [Segmentator(arch, optim, sched, torch.Generator().manual_seed(i), device=dev)
            for i in range(K)]
    rs = np.random.RandomState(0)
    img_u8 = torch.from_numpy(rs.randint(0, 255, (N, H, H), dtype=np.uint8)).to(dev)
    gt_u8 = torch.from_numpy(rs.randint(0, 4, (N, H, H)).astype(np.uint8)).to(dev)
    epoch = make_cotrain_epoch(segs, C, get_loss_fn("cross_entropy"), train_jsd=True,
                               train_adv=True, augment_labeled=True,
                               augment_unlabeled=True, eps_fgsm=0.03,
                               fuse_forward=fuse_forward)
    gen = torch.Generator(device=dev).manual_seed(0)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def call(t: int) -> Dict[str, torch.Tensor]:
        idx_lab = rs.randint(0, N, (t, K, B)).astype(np.int32)
        idx_unlab = rs.randint(0, N, (t, BU)).astype(np.int32)
        return epoch(img_u8, gt_u8, idx_lab, idx_unlab, None, gen, 1e-3, 0.5, 0.05)

    _check_finite(call(T))                                    # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    per_iteration = LAUNCHES_PER_ITERATION if fuse_forward else LAUNCHES_PER_ITERATION_UNFUSED
    want = dict.fromkeys(pool_kernels.KERNELS, per_iteration * T if on_card else 0)
    ips: List[float] = []
    launches = dict.fromkeys(pool_kernels.KERNELS, 0)
    for _ in range(windows):
        sync()
        pool_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = call(T)
        sync()
        seconds = time.perf_counter() - t0
        if dict(pool_kernels.LAUNCHES) != want:
            raise RuntimeError(f"{T} iterations launched {dict(pool_kernels.LAUNCHES)}, "
                               f"expected {want}")
        _check_finite(m)
        for k in launches:
            launches[k] += pool_kernels.LAUNCHES[k]
        ips.append((K * B + BU) * T / seconds)
    peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None

    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        call(1)
    sync()
    flops = counter.get_total_flops()
    value = statistics.median(ips)
    mfu = card = None
    if on_card:
        name = torch.cuda.get_device_name(dev)
        mfu = 100.0 * flops * value / (K * B + BU) / bf16_peak_flops(name)
        card = card_line()
    return {"metric": "cotrain_images_per_sec_per_chip", "value": value,
            "unit": "images/sec", "vs_baseline": value / TORCH_CPU_BASELINE_IPS,
            "ips_min": min(ips), "ips_max": max(ips), "ips_windows": ips,
            "windows": windows, "iterations": T, "peak_mem_gib": peak_mem,
            "flops_per_iteration": flops, "mfu_bf16_pct": mfu,
            "launches": launches, "fuse_forward": fuse_forward, "device": dev.type,
            "card": card}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the current card) or cpu")
    args = parser.parse_args(argv)
    out = run(resolve_device(args.device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
