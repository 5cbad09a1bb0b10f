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
   NaN in y and a NaN and an inf in g at masked-out corners, at the
   baselines' batch of 4 too; all four also
   at ragged shapes (spans off 16 bytes, odd w·c) and from pointers off 16
   bytes, which run the kernels' scalar edge path, at 4096 channels (over
   48 KB of shared memory a block in fp32) and at more row pairs than a
   grid has rows; at the eval step's shapes, one padded patient bucket
   of 16 slices a forward; at the spleen config's 512² shapes (its
   batches of 4, FGSM's stacked 8, its 16-slice eval bucket); and at the
   Cityscapes configs' shapes (3-channel ENet, 16 channels at the outer
   bottlenecks: the co-training config's fused 8 images and batches of 4
   at 256×512, the supervised config's batch of 4 at 512×1024); and at
   JEnet's (its pools of the raw 1-channel input at 256², of 16 channels
   at 128² and of 64 at 64², its unpools' y of (32², 64) and (64², 16), at
   the supervised batch of 4 and the 16-slice eval bucket). Then each
   is timed with CUDA events, at the ACDC main path's and at the Cityscapes
   co-training config's fused shapes, beside its byte
   bound, one PyTorch library call that computes the same function and a
   ``copy_`` that moves as many bytes; a near-empty kernel is timed the
   same way: the launch floor.
3. Two full-width ENets (4 classes) take 3 co-training iterations in fp32
   (jsd, adv, augmentation on, the fused two-group forward; PyTorch's
   precision defaults, as the CLI runs) on a synthetic 1674×256×256 uint8
   dataset; losses must be finite and the kernel counters must show 8
   launches of each kernel per iteration. One train-mode forward and input gradient on the card
   (TF32 off for this comparison only) is held against the same net in
   float64 on the CPU.
4. The port's bench (``dct_tpu_torch.bench.run``, ``bench.py``'s
   workload in bf16: K=2, 4+4 images, 256², jsd + FGSM, augmentation, a
   uint8 set of 1674 slices, the labeled and unlabeled forwards fused as
   bench.py runs them): a warm-up call, then 5 calls of 30 iterations,
   each timed alone, with 8 launches of each kernel an iteration; its JSON
   line (``bench.py``'s keys, the median images/s and its spread,
   ``mfu_bf16_pct``); then the same bench on the unfused step (12 launches
   of each kernel an iteration), its line under ``bench_unfused``, to
   measure the fused forward's gain in one process. Then 3 iterations under
   ``torch.profiler``, whose table of device and host time by op goes to
   ``chiprun_out/profile_bf16.txt``.

5. The co-training CLI at full width: ``dct_tpu_torch.train_cotraining``
   on ``configs/acdc_cotraining.yaml`` as it ships (fp32, two full ENets,
   K=2, B=Bu=4, 256²) with jsd and FGSM on, over a synthetic ACDC-style PNG
   tree written under ``build/`` from a seed (100 train patients × 8
   slices, 10 val patients of 8–15 slices), 2 epochs of 20 iterations, then
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

6. The three baseline CLIs at full width, each on its config as it ships
   (fp32, PyTorch's precision defaults, full ENet, 4 classes, B = 4 and
   Bu = 4, 256²): ``dct_tpu_torch.train_sup`` on a tree of 10 train
   patients × 8 slices (its epoch is a whole pass of the train folder,
   20 iterations), ``train_vat`` and ``train_mean_teacher`` on phase 5's
   tree (the ACDC split's 20 labeled patients: 40 iterations an epoch).
   Each runs 1 epoch, then resumes from its ``last.ckpt`` to a second.
   Checks per CLI: finite losses, dct_tpu's CSV header (the committed
   ``results/ACDC_vat`` and ``results/ACDC_meanteacher`` metrics for VAT
   and MT), val dice in [0, 1], the checkpoint files, the best checkpoint
   reloaded reproducing its CSV 2D dice, Adam's step count continuing
   across the resume, and the launches a training iteration (supervised
   2/2/2/2, VAT 10/10/6/6, MT 8/8/4/4 of pool_mask_fwd/unpool_fwd/
   pool_mask_bwd/unpool_bwd) and an eval forward (2/2/0/0) makes; VAT's
   variant without the adversarial term (λ_adv = 0) 2/2/2/2. VAT's
   perturbation on the trained ``results/ACDC_vat/best.ckpt`` weights, 4
   slices and one noise draw: every sample's ‖r_adv‖ must be ε (1e-3
   relative); its cosine to the same perturbation in float64 on the CPU
   is printed, at the CLI's precision and with TF32 off. The trained VAT net and Mean-Teacher teacher of
   ``results/`` run one eval-mode forward on the card over a padded
   16-slice bucket against float64 on the CPU, as in phase 5.

7. The ensemble evaluation: ``python -m dct_tpu_torch.summary`` (run in
   this process), soft and then hard vote, on phase 5's run (K = 2, 256²,
   10 val patients). Checks: the files' headers equal
   ``results/ACDC_cotrain_r3``'s; each model's 3D dice mean equals the
   CLI's ``val_batch_dice`` at its best checkpoint's epoch; each eval
   forward launches ``pool_mask_fwd`` and ``unpool_fwd`` twice and no
   backward kernel runs (P·K·2 of each). Then the committed
   ``results/ACDC_cotrain_r3`` weights' class maps and soft votes over one
   padded 16-slice bucket on the card against float64 on the CPU, pool-mask
   flips at near-ties counted.

8. ``configs/spleen_cotraining.yaml`` through the co-training CLI at 512²
   (fp32 as shipped, K = 2, B = Bu = 4) on a synthetic ``Patient_PP`` tree
   written under ``build/`` (100 train patients × 2 slices, 3 val patients
   of 9–16 slices), one epoch of 10 iterations: launches 8 an iteration
   and 2 an eval forward, dct_tpu's CSV columns (the header of
   ``results/spleen512_r3/jsd_adv/metrics.csv``), finite values; then
   the summary with ``--axises 1`` on its run, headers equal the committed
   spleen run's; then ``results/spleen512_r3/jsd_adv/best_0.ckpt`` over a
   padded 16-slice bucket at 512² on the card against float64.

9. Cityscapes: a synthetic tree at 1024×2048 (4 cities, 80 train and 8
   val images, raw label ids with void ids) written under ``build/``;
   ``train_cotraining_city`` on ``configs/cityscapes_cotraining.yaml`` as
   it ships (256×512, fp32, K = 2, B = Bu = 4, jsd + the FGSM/VAT mix,
   the 19 class weights) for 2 epochs, then a resume to 3;
   ``train_sup_city`` on ``configs/cityscapes_supervised.yaml`` (512×1024,
   batch 4) for 1 epoch, then a resume to 2. Cut: ``Dataset.subsample=1``
   and the epochs. Checks: dct_tpu's CSV columns for every epoch, finite
   losses, mIoU in [0, 1], the checkpoints, the resume's start epoch, the
   epoch-0 prediction dumps of the co-training run, and every kernel's
   launches against the count the drawn FGSM/VAT flags give
   (``city_iteration_launches``) plus 2 an eval or prediction forward.
   Then one co-training iteration at full width at the configs' λ maxima
   (λ_cot 1.0, λ_adv 0.005), FGSM in one direction and VAT in the other,
   from the run's last weights, on the card (TF32 off) against float64 on
   the CPU (``check_city_iteration`` states the tolerances).

10. The architectures, losses, optimizers and LR schedules of slice 8, each
   CLI through its entry point with dotted overrides of a shipped config:
   (a) ``train_sup`` with ``unet_bn``, SGD with Nesterov momentum 0.9 and
   CosineAnnealingLR on phase 6's supervised tree (256², batch 4) for 1
   epoch, then a resume to 2 that must start from the momentum trace the
   first epoch saved (dropout live); (b) ``train_sup`` with ``fcn8``,
   RMSprop (lr 1e-5: optax's ν starts at 0, so the first steps are ±10·lr
   an element), PolynomialLR and ``partial_ce``, 1 epoch; (c)
   ``train_cotraining`` with ``segnet``, AdamW and MultiStepLR, JSD and
   FGSM on (the fused two-group forward), on phase 5's tree, 1 epoch of
   20 iterations and a resume to 2 (AdamW's count 20 → 40); then one
   iteration of two SegNets at λ_cot 0.5 and λ_adv 0.05 from that run's
   weights, on the card (TF32 off) against float64 on the CPU (B = Bu = 2,
   the same thetas); (d) ``train_cotraining`` with ``unet`` raises the
   missing-dropout-generator error, as dct_tpu raises; each of seven
   optimizer settings takes 12 steps on ``unet_bn``'s 31 M parameters on
   the card within 1e-5 of a float64 CPU run. The pool kernels launch 0
   times on these paths. Each CLI epoch prints ``t_train``, ``t_eval``,
   seconds an iteration, images/s and peak device memory.

11. The architectures of slice 9 at full width, through the CLIs with
   dotted overrides: (a) ``train_cotraining_city`` on
   ``configs/cityscapes_cotraining.yaml`` with ``Arch.name=deeplabv3plus``
   (ResNet-101 (3, 4, 23, 3), output stride 8, 19 classes, 256×512, K = 2,
   B = Bu = 4, the fused forward, the FGSM/VAT mix) on phase 9's tree, with
   ``Trainer.coco_init_pth`` at a random DeepLabV2 .pth in the reference's
   key layout written here (``build/coco_init/``): 1 epoch and a resume to
   2; the trunk must load into both models (dct_tpu's "loaded N tensors"
   line, the first kernel equal to the .pth's) and ASPP-v3 keep its init
   (the shipped batch is halved only if it does not fit, and the script
   says so); (b) ``train_sup`` with ``pspnet`` and with ``jenet`` on phase
   6's supervised tree, 1 epoch each: JEnet launches pool_mask_fwd 3,
   unpool_fwd 2, pool_mask_bwd 2 and unpool_bwd 2 times an iteration (its
   input pool gets no gradient) and 3/2/0/0 an eval forward; (c)
   ``train_cotraining`` with two ``cnet``s (fused) on phase 5's tree, 1
   epoch of 20 iterations; (d) ``deeplabv2``, the MSC wrapper around it,
   ``resnet18`` and ``vgg11`` at full depth on a 256² batch, on the card
   (TF32 off) against float64 on the CPU; (e) one DeepLabV3+ Cityscapes
   co-training iteration at the configs' λ maxima, FGSM one way and VAT
   the other, on the card (TF32 off) against float64 on the CPU, cut to
   ``n_blocks`` (1, 1, 1, 1) (full widths), 128×256 and B = Bu = 2 so that
   the CPU side stays short. Every path but JEnet's launches no pool
   kernel. Each CLI epoch prints ``t_train``, ``t_eval``, seconds an
   iteration, images/s and peak device memory.

12. The parallel paths of slice 10, on the one card: (a) the
   co-training CLI under ``python -m torch.distributed.run
   --nproc_per_node 1`` (this script's ``--cli-worker`` mode, which calls
   the CLI's ``main`` and records the training epochs' launches) on phase
   5's tree, 1 epoch of 20 iterations, with ``Trainer.parallel=1`` (a
   (1, 1) mesh and the data-parallel path, NCCL) and with ``auto`` (no
   mesh, as dct_tpu); ``train_sup`` with ``auto`` on phase 6's tree. The
   mesh each prints must be dct_tpu's, the epoch's losses of ``1`` and
   ``auto`` within 1e-2 of phase 5's first epoch (the same config with
   ``Trainer.parallel`` unset; dct_tpu's own DP-vs-single tolerance after
   one epoch), and the launches 8/8/8/8 (supervised 2/2/2/2) an
   iteration. (b) Two processes on ``cuda:0`` joined by a
   gloo group (collectives staged through the host) each run one
   co-training iteration at full width (K = 2, B = Bu = 4 in all, 256²,
   λ_cot 0.5 and λ_adv 0.05, fp32 with TF32 off, injected thetas): the
   model-parallel step (mesh 2 × 1, one model a rank) and the
   data-parallel one (mesh 1 × 2, 2 + 2 images a rank), on phase 5's
   tree's first 16 slices with cuDNN's deterministic algorithms, each
   against the single-process step on the card: losses within 1e-4
   relative (adversarial 2e-3), update cosine ≥ 0.999 per model, running
   statistics within 1e-3 of scale, model a's within 2e-3 (the
   adversarial bound): they take the adversarial forward's batch
   statistics, and FGSM's sign flips where ENet's ill-conditioned fp32
   input gradient (phase 3) is near zero, which the data-parallel ranks'
   2-image convolutions round otherwise; each rank's launches as its
   passes give them. (c) Overlap-tile eval on the same two ranks: a two-conv net
   at halo 8 equal to the full image within 1e-5, and the trained
   ``results/ACDC_cotrain_r3/best_0.ckpt`` ENet at 256×512, halo 64, its
   argmax agreement above 0.9.

13. Slice 11's paths: (a) ``utils/logging.py:trace_epoch`` around 3 fused
   bf16 co-training iterations at full width (two ENets, B = Bu = 4, 256²,
   bench.py's 1674-slice uint8 set from ``RandomState(0)``; one iteration
   before the trace): the trace file must parse, and its device events of
   the four kernels must equal the counters, 8 of each an iteration; the
   kernels' share of the traced device time is printed. (b)
   ``augment_batch``, ``augment_u8_with_thetas`` and
   ``warp_gather_normalize`` on 12 indices, bit-equal on the card to
   ``normalize_gather`` → ``augment_batch_with_thetas`` under the same
   thetas, and the card bit-equal to the port on the CPU. (c) The
   ``FSGMGenerator`` and ``VATGenerator`` (ip = 1) shims on the trained
   ``results/ACDC_cotrain_r3/best_0.ckpt`` ENet, bit-equal to the direct
   ``fgsm`` and ``vat_perturbation`` calls under cuDNN's deterministic
   algorithms, launching 2/2/2/2 and 4/4/2/2; (d) ``predict(logit=False)``,
   rows summing to 1 within 1e-5; (e) the eval step with class weights
   (0.5, 2, 1, 4) on a padded 16-slice val bucket, the card within 1e-4
   relative of the CPU port (TF32 off); (f) where matplotlib imports, the
   learning-curve plot on phase 5's ``metrics.csv`` and the viewer in batch
   mode on phase 7's predictions (``build/phase13/``); else it prints why
   they did not run.

It ends with the ``kernels`` JSON line and, last, one JSON object
``{"ok": true, "device": {...}}``. It exits non-zero, with no result, when
no CUDA device is present or the ``dct_tpu_torch`` package is not beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
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
# the baseline trainers' forwards: 4 images (B = Bu = 4, one batch a forward)
B4_POOL_SHAPES = [(4,) + shape[1:] for shape, _ in POOL_SHAPES]
B4_UNPOOL_SHAPES = [(4,) + shape[1:] for shape, _ in UNPOOL_SHAPES]
# the spleen config at 512²: its step's batches of 4 (8 at FGSM's stacked
# input) and its eval bucket of 16 slices; each spatial size twice 256²'s
SPLEEN_POOL_SHAPES = [(n, 2 * h, 2 * w, c) for n in (4, 8, EVAL_L)
                      for (_, h, w, c), _ in POOL_SHAPES]
SPLEEN_UNPOOL_SHAPES = [(n, 2 * h, 2 * w, c) for n in (4, 8, EVAL_L)
                        for (_, h, w, c), _ in UNPOOL_SHAPES]
# the Cityscapes configs (3-channel ENet: 16 channels at bottleneck_1_0 and
# bottleneck_5_0, c0 = 13 + 3, so every span is whole 16-byte vectors):
# co-training at 256×512, its fused forward over 2B = 8 images (timed), its
# FGSM/VAT passes and val batches of 4; supervised at 512×1024, batch 4
CITY_POOL_SHAPES = [((8, 128, 256, 16), "city_bottleneck_1_0"),
                    ((8, 64, 128, 64), "city_bottleneck_2_0")]
CITY_UNPOOL_SHAPES = [((8, 32, 64, 64), "city_bottleneck_4_0"),
                      ((8, 64, 128, 16), "city_bottleneck_5_0")]
CITY_CHECK_POOL_SHAPES = [(4, 128, 256, 16), (4, 64, 128, 64),
                          (4, 256, 512, 16), (4, 128, 256, 64)]
CITY_CHECK_UNPOOL_SHAPES = [(4, 32, 64, 64), (4, 64, 128, 16),
                            (4, 64, 128, 64), (4, 128, 256, 16)]
# JEnet's (slice 9): its three pools, the first on the raw 1-channel input
# (pack 1), and its two unpools (y), at the supervised batch of 4 and the
# 16-slice eval bucket
JENET_POOL_SHAPES = [(n, 256, 256, 1) for n in (4, EVAL_L)] + [
    (n, h, h, c) for n in (4, EVAL_L) for h, c in ((128, 16), (64, 64))]
JENET_UNPOOL_SHAPES = [(n, h, h, c) for n in (4, EVAL_L) for h, c in ((32, 64), (64, 16))]
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
CARD = "cuda"                  # the device of phase 10's card-side runs


def emit(obj: dict) -> None:
    """Print one JSON line and append it to ``OUT_DIR/chip_smoke.jsonl``, so
    every measurement survives where only the tail of the output is kept."""
    line = json.dumps(obj)
    print(line, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.jsonl", "a") as f:
        f.write(line + "\n")


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
        for shape in (EVAL_POOL_SHAPES + B4_POOL_SHAPES + SPLEEN_POOL_SHAPES
                      + CITY_CHECK_POOL_SHAPES + JENET_POOL_SHAPES):
            check_pool_exact(torch, pk, plain, ints, shape, dtype, errs)
        for n, h, w, c in (EVAL_UNPOOL_SHAPES + B4_UNPOOL_SHAPES + SPLEEN_UNPOOL_SHAPES
                           + CITY_CHECK_UNPOOL_SHAPES + JENET_UNPOOL_SHAPES):
            check_unpool_exact(torch, pk, plain, ints, (n, 2 * h, 2 * w, c), dtype, errs)
        for shape, where in POOL_SHAPES + CITY_POOL_SHAPES:
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

        for shape, where in UNPOOL_SHAPES + CITY_UNPOOL_SHAPES:
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
    """T co-training iterations of bench.py's workload (the fused two-group
    forward, as dct_tpu runs it); returns (metrics, seconds, launches) with
    the counters reset just before."""
    from dct_tpu_torch.bench import LAUNCHES_PER_ITERATION
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
        # 4 forwards (or backwards) × 2 per iteration
        if count != LAUNCHES_PER_ITERATION * T:
            raise AssertionError(f"{name} launched {count} times in {T} iterations, "
                                 f"expected {LAUNCHES_PER_ITERATION * T}: {launches}")
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
    off, CUDA kernels) and on the CPU in fp32, against the same weights in
    float64 on the CPU. The logits must agree within 1e-3 of their scale.
    ENet's fp32 input gradient is ill-conditioned: on some draws of the
    weights an fp32 gradient, the CPU's as the card's, lies several 1e-3
    of scale from float64 (both printed), so the card's gradient must lie
    within 1e-3 of scale, or keep a cosine to float64 of at least 1 − 1e-4
    and lie within 2e-2."""
    gen = torch.Generator().manual_seed(5)
    net = Enet(4)
    from dct_tpu_torch.models.layers import init_weights_
    init_weights_(net, gen)
    x = torch.randint(0, 256, (2, 64, 64, 1), generator=gen).float() / 255.0
    gt = torch.randint(0, 4, (2, 64, 64), generator=gen)
    out = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        m = Enet(4)
        m.load_state_dict(net.state_dict())
        m = m.to(dev, dt, memory_format=torch.channels_last).train()
        xx = x.to(dev, dt).requires_grad_(True)
        with tf32_off(torch):
            logits = m(xx)
            (g,) = torch.autograd.grad(ce(logits, gt.to(dev)), [xx])
        out[dev, dt] = (logits.detach().cpu().double(), g.cpu().double())
    ref = out["cpu", torch.float64]
    errs = {}
    for side, key in (("card", ("cuda", torch.float32)), ("cpu_fp32", ("cpu", torch.float32))):
        (logits, g), (ref_logits, ref_g) = out[key], ref
        errs[f"{side}_logits"] = float((logits - ref_logits).abs().max() / ref_logits.abs().max())
        errs[f"{side}_input_grad"] = float((g - ref_g).abs().max() / ref_g.abs().max())
        errs[f"{side}_input_grad_1-cos"] = float(1 - (g * ref_g).sum() / (g.norm() * ref_g.norm()))
    grad_ok = errs["card_input_grad"] < 1e-3 or (errs["card_input_grad_1-cos"] < 1e-4
                                                 and errs["card_input_grad"] < 2e-2)
    if not (errs["card_logits"] < 1e-3 and grad_ok):
        raise AssertionError(f"the card differs from the float64 CPU reference: {errs}")
    return errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dct_tpu_torch import bench
    from dct_tpu_torch.bench import card_line
    from dct_tpu_torch.losses import get_loss_fn
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.models.enet import Enet
    from dct_tpu_torch.ops import pool_kernels as pk
    from dct_tpu_torch.ops import pooling as plain
    from dct_tpu_torch.train.steps import make_cotrain_epoch

    card = card_line()
    print(card, flush=True)
    start = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.jsonl").write_text("")

    def done(phase: str) -> None:
        print(f"{phase} done at {time.perf_counter() - start:.1f} s", flush=True)
    t0 = time.perf_counter()
    log = pk.build()
    print(f"phase 1: built {SOURCE} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    detail, errs = check_kernels(torch, pk, plain)
    done("phase 2 checks")
    print("phase 2: 4 kernels bit-equal to their plain versions "
          "(fp32, bf16, ties, NaN window, NaN in y, NaN and inf in g at "
          "masked-out corners; at the main-path shapes, at the eval shapes "
          f"{EVAL_POOL_SHAPES} (pool) and {EVAL_UNPOOL_SHAPES} (unpool), at the "
          f"baselines' {B4_POOL_SHAPES} and {B4_UNPOOL_SHAPES}, at the spleen "
          f"config's 512² shapes {SPLEEN_POOL_SHAPES} (pool) and {SPLEEN_UNPOOL_SHAPES} "
          f"(unpool), at JEnet's {JENET_POOL_SHAPES} (pool) and {JENET_UNPOOL_SHAPES} "
          f"(unpool), at ragged shapes {RAGGED_POOL_SHAPES} and off 16 bytes)", flush=True)
    emit({"kernel_detail": detail, "card": card})
    emit({"launch_floor_ms": launch_floor_ms(torch), "card": card})

    ce = get_loss_fn("cross_entropy")
    ref_errs = check_reference(torch, Enet, ce)
    print(f"phase 3: card vs float64 CPU reference (share of scale): {ref_errs}",
          flush=True)
    emit({"phase3_vs_float64": ref_errs, "card": card})
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
          f"adv {float(m['adv_loss'][-1]):.5f}; 8 launches of each kernel an iteration",
          flush=True)

    done("phase 3")
    # phase 4: the port's bench at its full workload (its own models and
    # data); each timed call runs with the counters set to 0 just before it
    # and read just after, and the bench fails unless 8 of each launched
    # an iteration
    bench_line = bench.run("cuda")
    emit(bench_line)
    launches = bench_line["launches"]
    for name, count in launches.items():
        want = bench.LAUNCHES_PER_ITERATION * bench_line["iterations"] * bench_line["windows"]
        if count != want:
            raise AssertionError(f"bench: {name} launched {count} times, expected {want}")
    # the unfused step in the same process, for the fused forward's gain
    emit({"bench_unfused": bench.run("cuda", fuse_forward=False)})
    segs = build_models(torch, Segmentator, "bfloat16", 10)
    run_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8, gt_u8, rs, 3, gen)
    profile_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8, gt_u8, rs, gen)
    del segs, img_u8, gt_u8

    done("phase 4")
    cli = run_cli(torch, pk, card)
    done("phase 5")
    per_iteration = {"cotrain": dict.fromkeys(pk.KERNELS, bench.LAUNCHES_PER_ITERATION),
                     **run_baselines(torch, pk, card, cli["tree"], cli["val"], cli["buckets"])}
    done("phase 6")
    summary_launches = run_summary(torch, pk, card, cli)
    done("phase 7")
    spleen = run_spleen(torch, pk, card)
    done("phase 8")
    city = run_city(torch, pk, card)
    done("phase 9")
    slice8 = run_slice8(torch, pk, card, cli["tree"])
    done("phase 10")
    slice9 = run_slice9(torch, pk, card, cli["tree"])
    done("phase 11")
    slice10 = run_slice10(torch, pk, card, cli["tree"])
    done("phase 12")
    slice11 = run_slice11(torch, pk, card, cli)
    done("phase 13")

    kernels = []
    main_path = {where for _, where in POOL_SHAPES + UNPOOL_SHAPES}
    for name in pk.KERNELS:
        bf16 = [r for r in detail if r["name"] == name and r["dtype"] == "bfloat16"]
        rows = [r for r in bf16 if r["where"] in main_path]
        city_rows = [r for r in bf16 if r["where"] not in main_path]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name],
            # one launch at each of the kernel's two main-path shapes, bf16
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            # the same at the Cityscapes co-training config's two fused shapes
            "city_ms": sum(r["ms"] for r in city_rows),
            "city_plain_ms": sum(r["plain_ms"] for r in city_rows),
            "city_bound_ms": sum(r["bound_ms"] for r in city_rows),
            "city_library_ms": sum(r["library_ms"] for r in city_rows),
            "launches_cli": cli["launches"][name],
            "launches_eval": cli["eval_launches"][name],
            "launches_per_iteration": {k: v[name] for k, v in per_iteration.items()},
            "launches_summary": {k: v[name] for k, v in summary_launches.items()},
            "launches_spleen_512": {k: v[name] for k, v in spleen.items()},
            "launches_city": {k: v[name] for k, v in city.items()},
            "launches_slice8": {k: v[name] for k, v in slice8.items()},
            "launches_slice9": {k: v[name] for k, v in slice9.items()},
            "launches_parallel_per_rank": {k: v[name] for k, v in slice10.items()},
            "launches_slice11": {k: v[name] for k, v in slice11.items()}})
        kernels[-1]["bound_share"] = kernels[-1]["bound_ms"] / kernels[-1]["ms"]
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def write_ring_tree(root: Path, layout, size: int, n_classes: int, rs) -> None:
    """root/<mode>/{img,gt}/<stem>.png for each (mode, stems) of ``layout``:
    concentric rings (gt) at a centre drawn from ``rs`` and a noisy rendering
    of them (img), so a segmenter can learn the mapping."""
    from PIL import Image
    yy, xx = np.mgrid[0:size, 0:size]
    shift = size * 3 // 32
    for mode, stems in layout:
        for sub in ("img", "gt"):
            (root / mode / sub).mkdir(parents=True, exist_ok=True)
        for stem in stems:
            cy = size / 2 + rs.randint(-shift, shift + 1)
            cx = size / 2 + rs.randint(-shift, shift + 1)
            r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            gt = np.zeros((size, size), np.uint8)
            for c in range(1, n_classes):
                gt[r < size * (0.4 - 0.1 * (c - 1))] = c
            img = (gt.astype(np.float32) / (n_classes - 1) * 180
                   + rs.randn(size, size) * 12 + 40).clip(0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / mode / "img" / f"{stem}.png")
            Image.fromarray(gt).save(root / mode / "gt" / f"{stem}.png")


def write_acdc_tree(root: Path, seed: int = 0, n_train: int = 100) -> None:
    """An ACDC-style tree at 256², 4 classes, stems patientPPP_01_0_S:
    ``n_train`` train patients × 8 slices; 10 val patients of 8–16 slices,
    unequal so that the eval buckets pad (cut from ACDC's ~10 slices a
    patient and 20 val patients to keep the script's run short)."""
    rs = np.random.RandomState(seed)
    val_counts = rs.randint(8, 17, size=10).tolist()

    def stems(counts):
        return [f"patient{p:03d}_01_0_{s}" for p, n in enumerate(counts, start=1)
                for s in range(n)]
    write_ring_tree(root, [("train", stems([8] * n_train)), ("val", stems(val_counts))],
                    256, 4, rs)


def write_spleen_tree(root: Path, seed: int = 2) -> None:
    """A spleen-style tree at 512², 2 classes, the slicer's stems
    Patient_PP_00_0_S: patients 1–100 of 2 train slices each (the split
    takes 1–20 as labeled, 21–100 as unlabeled); val patients 8, 10 and 16
    of 12, 16 and 9 slices (one eval bucket of 16)."""
    def stems(counts):
        return [f"Patient_{p:02d}_00_0_{s}" for p, n in counts for s in range(n)]
    write_ring_tree(root, [("train", stems([(p, 2) for p in range(1, 101)])),
                           ("val", stems([(8, 12), (10, 16), (16, 9)]))],
                    512, 2, np.random.RandomState(seed))


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
    from dct_tpu_torch.train.steps import make_eval_all_models_step
    from dct_tpu_torch.train.trainer import DEFAULT_GRP_REGEX
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
    buckets = PatientBuckets(val, DEFAULT_GRP_REGEX)
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
        emit({"cli_epoch": epoch, "t_train": t_train, "t_eval": t_eval,
              "t_host": seconds - t_train - t_eval,
              "images_per_sec": float(r["images_per_sec"]),
              "tf32_convs": torch.backends.cudnn.allow_tf32,
              "val_batch_dice_0": [float(r[f"val_batch_dice_0_{i}"]) for i in (1, 2, 3)],
              "card": card})
    del trainer, seg

    errs = check_trained_weights(torch, val, buckets, "results/ACDC_cotrain_r3/best_0.ckpt")
    print(f"phase 5: trained results/ACDC_cotrain_r3/best_0.ckpt, eval forward of "
          f"a padded {EVAL_L}-slice bucket on the card vs float64 CPU (share of "
          f"scale): {errs}", flush=True)
    return {"launches": launches, "eval_launches": eval_launches, "tree": tree,
            "val": val, "buckets": buckets}


def count_flips(seen_card, seen_ref) -> tuple:
    """(mask entries that differ, those of them not at a near-tie) between
    the card's and the float64 reference's pool calls, each recorded as
    (float64 input or None, mask as bool). A flip is at a near-tie when the
    float64 window's maximum exceeds the card's chosen corner by at most
    1e-5 of the layer's largest magnitude: fp32 rounding of the
    activations."""
    flips, far = 0, 0
    for (_, m_card), (x, m_ref) in zip(seen_card, seen_ref):
        n, hh, ww, c = x.shape
        win = x.reshape(n, hh // 2, 2, ww // 2, 2, c)
        gap = (win.amax(dim=(2, 4), keepdim=True) - win).reshape(x.shape)
        flips += int((m_card != m_ref).sum())
        far += int((gap[m_card & ~m_ref] > 1e-5 * x.abs().max()).sum())
    return flips, far


def recording_pool(pool, seen, side):
    """A stand-in for ENet's pool that records (its float64 input on the
    CPU side, its mask as bool) in ``seen[side]``."""
    def run(t):
        res = pool(t)
        seen[side].append((t.detach().cpu() if side == "cpu" else None, (res[1] != 0).cpu()))
        return res
    return run


def check_trained_weights(torch, val, buckets, path: str, entry: str = "segmentator",
                          near_ties: bool = False) -> dict:
    """The committed trained weights of ``path``'s ``entry``: one eval-mode
    forward on the card (fp32, TF32 off, CUDA kernels), through the
    Segmentator the eval step runs, of the first val patient's bucket that
    pads (its slices, then repeats of slice 0 up to the bucket length),
    against the same net in float64 on the CPU.

    The logits must agree within 1e-3 of their scale. Where a pool window
    holds a near-tie (two corners within fp32 rounding of each other), fp32
    and float64 may pick different corners: such mask flips are counted,
    and then only the logits' 99.9th percentile is held to 1e-3 of scale,
    the flips to 1e-5 of the mask entries and the argmax to all but 1e-4
    of the pixels. With ``near_ties``, more flips pass when every one lies
    in a near-tie window (``count_flips``): dead channels, whose weights
    weight decay left at 1e-34 and below, tie in every window in fp32 but
    differ at that scale in float64."""
    import dct_tpu_torch.models.enet as enet_mod
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.models.enet import Enet
    from dct_tpu_torch.utils.convert import params_from_jax
    seg_sd = load_checkpoint(path)[entry]
    padded = [p for p in range(len(buckets)) if not buckets.mask[p].all()]
    if not padded:
        raise AssertionError("no val patient pads its bucket")
    idx = buckets.indices[padded[0]]
    x = torch.from_numpy(val.data["img"][idx]).float()[..., None] / 255.0
    seg = Segmentator.from_state_dict(seg_sd, device="cuda")
    net = Enet(int(seg_sd["arch_dict"]["num_classes"]))
    net.load_state_dict(params_from_jax(seg_sd["net_state_dict"], seg_sd["batch_stats"]))
    net = net.to("cpu", torch.float64, memory_format=torch.channels_last).eval()
    pool, seen = enet_mod.max_pool_2x2_with_mask_kernel, {"cuda": [], "cpu": []}
    try:
        with tf32_off(torch), torch.inference_mode():
            enet_mod.max_pool_2x2_with_mask_kernel = recording_pool(pool, seen, "cuda")
            card = seg.predict(x.cuda()).cpu().double()
            enet_mod.max_pool_2x2_with_mask_kernel = recording_pool(pool, seen, "cpu")
            ref = net(x.double())
    finally:
        enet_mod.max_pool_2x2_with_mask_kernel = pool
    scale = ref.abs().max()
    err = (card - ref).abs()
    flips, far = count_flips(seen["cuda"], seen["cpu"])
    n_mask = sum(m.numel() for _, m in seen["cpu"])
    out = {"logits": float(err.max() / scale),
           "logits_p999": float(torch.quantile(err.flatten().float(), 0.999) / scale),
           "mask_flips": flips, "flips_not_near_tie": far, "mask_entries": n_mask,
           "argmax_disagree": float((card.argmax(-1) != ref.argmax(-1)).double().mean())}
    near_tie_ok = (out["logits_p999"] < 1e-3 and out["argmax_disagree"] <= 1e-4
                   and (flips <= 1e-5 * n_mask or (near_ties and far == 0)))
    if not (out["logits"] < 1e-3 or (flips and near_tie_ok)):
        raise AssertionError(f"trained {path} ({entry}) eval logits on the card differ "
                             f"from the float64 CPU reference: {out}")
    return out


FWD_BWD = ("pool_mask_fwd", "unpool_fwd", "pool_mask_bwd", "unpool_bwd")
SUP_HEADER = (["epoch"] + [f"{p}_{i}" for p in ("train_dice", "val_dice", "val_batch_dice")
                           for i in (1, 2, 3)]
              + ["train_loss", "val_loss", "images_per_sec", "t_train", "t_eval"])
# (name, CLI module, config, the tree it runs on ("sup" or phase 5's), the
# launches of pool_mask_fwd, unpool_fwd, pool_mask_bwd, unpool_bwd a
# training iteration, the committed CSV with dct_tpu's header or None,
# the CSV's 2D val dice columns, the best checkpoint, its eval entry)
BASELINES = [
    ("supervised", "train_sup", "configs/acdc_supervised.yaml", "sup", (2, 2, 2, 2),
     None, "val_dice", "best.ckpt", "segmentator"),
    ("vat", "train_vat", "configs/acdc_vat.yaml", "main", (10, 10, 6, 6),
     "results/ACDC_vat/metrics.csv", "val_dice", "best.ckpt", "segmentator"),
    ("mean_teacher", "train_mean_teacher", "configs/acdc_meanteacher.yaml", "main",
     (8, 8, 4, 4), "results/ACDC_meanteacher/metrics.csv", "val_teacher_2d_dice",
     "best_*.ckpt", "teacher"),
]


def run_baselines(torch, pk, card: str, main_tree: Path, val, buckets) -> dict:
    """Phase 6: the three baseline CLIs at full width, one epoch and a
    resume to a second each, checked as the module docstring says. Returns
    the launches a training iteration of each path makes."""
    import importlib
    import shutil
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.losses import get_loss_fn
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train import MeanTeacherTrainer, Trainer, VatTrainer
    from dct_tpu_torch.train import mean_teacher, trainer as trainer_mod, vat
    from dct_tpu_torch.train.steps import make_eval_all_step
    from dct_tpu_torch.train.vat import make_vat_epoch

    sup_tree = Path("build/acdc_synthetic_sup")
    t0 = time.perf_counter()
    shutil.rmtree(sup_tree, ignore_errors=True)
    write_acdc_tree(sup_tree, seed=1, n_train=10)
    print(f"phase 6: wrote the supervised tree in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # launches and wall time of each start_training call (one epoch each
    # here: the counters are set to 0 just before it and read just after),
    # and the launches of its eval passes, read around the trainers' own
    # functions
    evals = {"forwards": 0, **dict.fromkeys(pk.KERNELS, 0)}
    runs = []
    eval_dice = trainer_mod.eval_dice

    def counted_eval_dice(eval_all, val_dev, val_buckets):
        before = dict(pk.LAUNCHES)
        out = eval_dice(eval_all, val_dev, val_buckets)     # ends on the host
        for k in pk.KERNELS:
            evals[k] += pk.LAUNCHES[k] - before[k]
        evals["forwards"] += len(val_buckets)
        return out

    def timed(start):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            evals.update({"forwards": 0, **dict.fromkeys(pk.KERNELS, 0)})
            pk.reset_launch_counts()
            t = time.perf_counter()
            rows = start(self, *args, **kwargs)
            torch.cuda.synchronize()
            runs.append({"wall": time.perf_counter() - t, "launches": dict(pk.LAUNCHES),
                         "eval": dict(evals)})
            return rows
        return run

    classes = (Trainer, VatTrainer, MeanTeacherTrainer)
    starts = [c.start_training for c in classes]
    modules = (trainer_mod, vat, mean_teacher)
    for c, start in zip(classes, starts):
        c.start_training = timed(start)
    for m in modules:
        m.eval_dice = counted_eval_dice
    per_iteration = {}
    try:
        for (name, module, config, tree_name, per_iter, ref_csv, dice_col, best_glob,
             entry) in BASELINES:
            tree = sup_tree if tree_name == "sup" else main_tree
            run = Path(f"build/{name}_run")
            shutil.rmtree(run, ignore_errors=True)
            cli_main = importlib.import_module(f"dct_tpu_torch.{module}").main
            common = ["--config", config, f"Dataset.root_dir={tree}", f"Trainer.save_dir={run}"]
            first = len(runs)
            cli_main(common + ["Trainer.max_epoch=1"])
            count_after_one = int(_adam_payload(load_checkpoint(run / "last.ckpt"))["count"])
            trainer = cli_main(common + ["Trainer.max_epoch=2",
                                         f"Trainer.checkpoint={run / 'last.ckpt'}"])
            T = (len(trainer.train_set) // trainer.batch_size if name == "supervised"
                 else trainer.iters_per_epoch)
            check_baseline_run(name, run, runs[first:], T, per_iter, ref_csv,
                               count_after_one, trainer)
            per_iteration[name] = dict(zip(FWD_BWD, per_iter))
            check_best_reproduces(load_checkpoint, Segmentator, make_eval_all_step,
                                  eval_dice, name, run, best_glob, entry, dice_col, trainer)
            for epoch, r in enumerate(runs[first:]):
                row = _csv_rows(run)[epoch]
                t_train, t_eval = float(row["t_train"]), float(row["t_eval"])
                emit({"cli": name, "cli_epoch": epoch, "t_train": t_train,
                      "t_eval": t_eval, "t_host": r["wall"] - t_train - t_eval,
                      "iterations": T,
                      "images_per_sec": float(row["images_per_sec"]),
                      "tf32_convs": torch.backends.cudnn.allow_tf32,
                      "card": card})
            if name == "vat":
                per_iteration["vat_no_adv"] = check_vat_without_term(
                    torch, pk, trainer, make_vat_epoch, get_loss_fn("cross_entropy"))
            del trainer
    finally:
        for c, start in zip(classes, starts):
            c.start_training = start
        for m in modules:
            m.eval_dice = eval_dice

    vat_r = check_vat_perturbation(torch, val)
    print(f"phase 6: VAT r_adv on the trained results/ACDC_vat weights, 4 slices at "
          f"256², ε = 10, on the card at the CLI's precision and with TF32 off: "
          f"‖r_adv‖ and cosine to float64 on the CPU {vat_r}", flush=True)
    for path, entry in (("results/ACDC_vat/best.ckpt", "segmentator"),
                        ("results/ACDC_meanteacher/best_0.7408_85.ckpt", "teacher")):
        errs = check_trained_weights(torch, val, buckets, path, entry)
        print(f"phase 6: trained {path} ({entry}), eval forward of a padded "
              f"{EVAL_L}-slice bucket on the card vs float64 CPU (share of scale): "
              f"{errs}", flush=True)
    return per_iteration


def _adam_payload(sd: dict) -> dict:
    return (sd["student"] if "student" in sd else sd["segmentator"])["optim_state_dict"]


def _csv_rows(run: Path) -> list:
    import csv
    with open(run / "metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def check_baseline_run(name, run, runs, T, per_iter, ref_csv, count_after_one,
                       trainer) -> None:
    """CSV header, rows, finite losses, dice in [0, 1], files, Adam's count
    across the resume, and the launches of each epoch's training iterations
    and eval forwards."""
    import csv
    rows = _csv_rows(run)
    if ref_csv is None:
        ref_header = SUP_HEADER
    else:
        with open(ref_csv, newline="") as f:
            ref_header = next(csv.reader(f))
    if list(rows[0].keys()) != ref_header:
        raise AssertionError(f"{name}: metrics.csv header {list(rows[0])} is not dct_tpu's "
                             f"{ref_header}")
    if [int(r["epoch"]) for r in rows] != [0, 1]:
        raise AssertionError(f"{name}: metrics.csv epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        for k, v in r.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v}")
            if "dice" in k and not 0.0 <= float(v) <= 1.0:
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v} outside [0, 1]")
    if name == "vat" and not all(float(r["adv_loss"]) > 0 for r in rows):
        raise AssertionError("vat: the adversarial term did not run")
    best = sorted(run.glob("best*.ckpt"))
    if not (run / "last.ckpt").is_file() or len(best) != 1:
        raise AssertionError(f"{name}: checkpoints {sorted(p.name for p in run.iterdir())}")
    opt = trainer.student.optimizer if name == "mean_teacher" else trainer.segmentator.optimizer
    steps = {float(st["step"]) for st in opt.state.values()}
    if count_after_one != T or steps != {2.0 * T}:
        raise AssertionError(f"{name}: Adam count {count_after_one} after epoch 0, steps "
                             f"{steps} after the resume; expected {T} and {2 * T}")
    if len(runs) != 2:
        raise AssertionError(f"{name}: {len(runs)} training calls, expected 2")
    for epoch, r in enumerate(runs):
        ev, n_fwd = r["eval"], r["eval"]["forwards"]
        want_eval = dict(zip(FWD_BWD, (2 * n_fwd, 2 * n_fwd, 0, 0)))
        got_eval = {k: ev[k] for k in FWD_BWD}
        train = {k: r["launches"][k] - ev[k] for k in FWD_BWD}
        want = {k: n * T for k, n in zip(FWD_BWD, per_iter)}
        if got_eval != want_eval or train != want or n_fwd == 0:
            raise AssertionError(f"{name} epoch {epoch}: {T} iterations launched {train} "
                                 f"(expected {want}); {n_fwd} eval forwards launched "
                                 f"{got_eval} (expected {want_eval})")
    print(f"phase 6: {name}: 2 epochs of {T} iterations (1 + resume), "
          f"{runs[0]['eval']['forwards']} eval forwards an epoch; launches a training "
          f"iteration {dict(zip(FWD_BWD, per_iter))}, an eval forward 2/2/0/0; Adam "
          f"count {count_after_one} → {2 * T} across the resume", flush=True)


def check_best_reproduces(load_checkpoint, Segmentator, make_eval_all_step, eval_dice,
                          name, run, best_glob, entry, dice_col, trainer) -> None:
    """The best checkpoint, reloaded into a fresh Segmentator (Adam state
    included), gives its epoch's CSV 2D val dice on the trainer's val set."""
    (best,) = run.glob(best_glob)
    sd = load_checkpoint(best)
    seg = Segmentator.from_state_dict(sd[entry], device="cuda")
    dice2d = eval_dice(make_eval_all_step(seg, 4), trainer.val_dev, trainer.val_buckets)["dice2d"]
    epoch = int(sd["epoch"] if "epoch" in sd else sd["best_epoch"])
    row = _csv_rows(run)[epoch]
    for i in (1, 2, 3):
        csv_v = float(row[f"{dice_col}_{i}"])
        if abs(dice2d[i] - csv_v) > 5.1e-5:
            raise AssertionError(f"{name}: {best.name} (epoch {epoch}) gives {dice_col}_{i} "
                                 f"{dice2d[i]:.6f}, the CSV {csv_v}")
    print(f"phase 6: {name}: {best.name} (epoch {epoch}) reproduces its 2D val dice "
          f"{[round(float(d), 6) for d in dice2d[1:]]}", flush=True)


def check_vat_without_term(torch, pk, trainer, make_vat_epoch, ce) -> dict:
    """VAT's variant without the adversarial term (λ_adv = 0): 2 iterations
    on the trained CLI's model launch 2/2/2/2 an iteration."""
    idx_lab, idx_unlab = trainer.draw_indices()
    epoch = make_vat_epoch(trainer.segmentator, ce, 4, False, True, False,
                           trainer.eps, trainer.xi, trainer.ip)
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    m = epoch(trainer._img_cat, trainer._gt_cat, idx_lab[:2], idx_unlab[:2], gen, 1e-3, 0.0)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    if launches != dict.fromkeys(pk.KERNELS, 4) or not bool(torch.isfinite(m["sup_loss"]).all()):
        raise AssertionError(f"VAT without its term: 2 iterations launched {launches}, "
                             f"sup {m['sup_loss']}")
    print(f"phase 6: VAT with λ_adv = 0, 2 iterations: launches {launches}", flush=True)
    return {k: v // 2 for k, v in launches.items()}


class _Float64Train:
    """What ``vat_perturbation`` calls of a Segmentator, on the CPU in
    float64 with float64 logits: the reference direction of r_adv."""

    def __init__(self, net, BatchNorm):
        self.net = net
        self.batch_norms = [m for m in net.modules() if isinstance(m, BatchNorm)]

    def apply_train(self, x, update_stats=True):
        self.net.train()
        for m in self.batch_norms:
            m.update_stats = update_stats
        try:
            return self.net(x)
        finally:
            for m in self.batch_norms:
                m.update_stats = True


def check_vat_perturbation(torch, val):
    """VAT's r_adv on the card from the trained results/ACDC_vat weights, 4
    val slices at 256² and one noise draw, at the CLI's precision (PyTorch's
    defaults: TF32 convolutions) and with TF32 off; the same weights,
    slices and noise in float64 on the CPU. Fails unless every sample's
    ‖r_adv‖ is ε to 1e-3 relative at the CLI's precision; returns the
    norms and the cosines to the float64 direction, for both precisions."""
    from dct_tpu_torch.adversarial import vat_perturbation
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.models.layers import BatchNorm
    sd = load_checkpoint("results/ACDC_vat/best.ckpt")["segmentator"]
    eps, xi = 10.0, 1e-6                      # configs/acdc_vat.yaml
    img = torch.from_numpy(val.data["img"][:4]).float()[..., None] / 255.0
    d = torch.randn(img.shape, generator=torch.Generator().manual_seed(4))
    net = Segmentator.from_state_dict(sd, device="cpu").net.double()
    _, r_ref = vat_perturbation(_Float64Train(net, BatchNorm), img.double(), xi, eps, 1,
                                d=d.double())
    out = {}
    for precision, scope in (("cli", contextlib.nullcontext), ("tf32_off", tf32_off)):
        seg = Segmentator.from_state_dict(sd, device="cuda")
        with scope(torch):
            _, r_card = vat_perturbation(seg, img.cuda(), xi, eps, 1, d=d.cuda())
        a, b = r_card.cpu().double().flatten(1), r_ref.flatten(1)
        norms = a.norm(dim=1)
        out[precision] = {"norms": [round(float(n), 6) for n in norms],
                          "cosines": [round(float(c), 6)
                                      for c in (a * b).sum(1) / (norms * b.norm(dim=1))]}
    if not all(abs(n / eps - 1) < 1e-3 for n in out["cli"]["norms"]):
        raise AssertionError(f"VAT r_adv norms {out['cli']['norms']} on the card, "
                             f"expected ε = {eps}")
    return out


SUMMARY_FILES = ("summary.csv", "bsummary.csv", "div.csv", "summary_std.csv",
                 "bsummary_std.csv", "log_2Ddice_ensemble.csv", "log_3Ddice_model_1.csv")


def check_summary_headers(run: Path, committed: str) -> None:
    """The summary files' headers, and the std tables' row labels, equal
    the committed run's."""
    import csv
    for name in SUMMARY_FILES:
        with open(run / name, newline="") as f:
            got = list(csv.reader(f))
        with open(Path(committed) / name, newline="") as f:
            ref = list(csv.reader(f))
        if got[0] != ref[0] or (name.endswith("std.csv")
                                and [r[0] for r in got] != [r[0] for r in ref]):
            raise AssertionError(f"{run / name}: header {got[0]}, {committed}'s {ref[0]}")


def summarise(torch, pk, run: Path, n_forwards: int, *args) -> tuple:
    """``python -m dct_tpu_torch.summary`` on ``run``, in this process, with
    the counters set to 0 just before it and read just after; fails unless
    each of the ``n_forwards`` eval forwards launched pool_mask_fwd and
    unpool_fwd twice and no backward kernel ran. Returns (its tables,
    seconds, launches)."""
    from dct_tpu_torch.summary import main as summary_main
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    out = summary_main(["--input_dir", str(run), *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    want = dict(zip(FWD_BWD, (2 * n_forwards, 2 * n_forwards, 0, 0)))
    if launches != want:
        raise AssertionError(f"summary {args} on {run}: {n_forwards} eval forwards "
                             f"launched {launches}, expected {want}")
    return out, wall, launches


def run_summary(torch, pk, card: str, cli: dict) -> dict:
    """Phase 7: the ensemble evaluation, soft and hard, on phase 5's run
    (K = 2, 256², the card), then the trained results/ACDC_cotrain_r3 run's
    class maps and votes on the card against float64. Returns the launches
    of each summary run."""
    from dct_tpu_torch.checkpoint import load_checkpoint
    run, P, K = Path("build/cli_run"), len(cli["buckets"]), 2
    rows = _csv_rows(run)
    launches = {}
    for ensemble in ("soft", "hard"):
        out, wall, launches[ensemble] = summarise(torch, pk, run, P * K,
                                                  "--ensemble_method", ensemble)
        check_summary_headers(run, "results/ACDC_cotrain_r3")
        mean = out["bsummary"]["mean"]
        for s in range(K):
            epoch = int(load_checkpoint(run / f"best_{s}.ckpt")["best_epoch"])
            for i in (1, 2, 3):
                csv_v = float(rows[epoch][f"val_batch_dice_{s}_{i}"])
                if abs(mean[f"S{s}_DSC{i}"] - csv_v) > 5.1e-5:
                    raise AssertionError(f"summary S{s}_DSC{i} {mean[f'S{s}_DSC{i}']:.6f}, "
                                         f"the CLI's best_{s} epoch {epoch}: {csv_v}")
        print(f"phase 7: summary --ensemble_method {ensemble} on {run}: {P} patients × "
              f"{K} models in {wall:.2f} s, launches {launches[ensemble]}; headers of "
              f"results/ACDC_cotrain_r3; each model's 3D dice mean = its best epoch's CSV "
              f"val_batch_dice; kappa {out['div']}; ens 3D dice "
              f"{[round(float(mean[f'ens_DSC{i}']), 4) for i in (1, 2, 3)]}", flush=True)
        emit({"summary": ensemble, "seconds": wall, "patients": P, "models": K,
              "launches": launches[ensemble], "card": card})
    maps = check_summary_maps(torch, cli["val"], cli["buckets"], "results/ACDC_cotrain_r3")
    print(f"phase 7: trained results/ACDC_cotrain_r3 (K = 2, soft vote), a padded "
          f"{EVAL_L}-slice bucket, class maps and votes on the card vs float64 on the "
          f"CPU: {maps}", flush=True)
    return launches


def check_summary_maps(torch, val, buckets, run_dir: str) -> dict:
    """The summary step's class maps and soft votes of a committed run's
    best_*.ckpt on the first padded val bucket, on the card (fp32, TF32
    off, CUDA kernels) and in float64 on the CPU.

    Where a pool window holds a near-tie, fp32 and float64 may pick
    different corners, and the unpool then moves the logits downstream (a
    dead channel whose windows all tie does so everywhere). So each pool
    mask entry that differs is counted, and it must lie at a near-tie
    (``count_flips``). A
    model with no mask flip must give the float64 class map on all but
    1e-4 of the bucket's valid pixels, and so must the vote where no model
    flipped; pixels that differ beside counted near-tie flips are counted
    and reported."""
    import dct_tpu_torch.models.enet as enet_mod
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train.steps import make_summary_step
    sds = [load_checkpoint(c)["segmentator"] for c in sorted(Path(run_dir).glob("best_*.ckpt"))]
    C, K = int(sds[0]["arch_dict"]["num_classes"]), len(sds)
    p = [i for i in range(len(buckets)) if not buckets.mask[i].all()][0]
    idx, mask = buckets.indices[p:p + 1], buckets.mask[p:p + 1]
    img_u8, gt_u8 = torch.from_numpy(val.data["img"]), torch.from_numpy(val.data["gt"])
    pool, seen, out = enet_mod.max_pool_2x2_with_mask_kernel, {"cuda": [], "cpu": []}, {}
    try:
        with tf32_off(torch):
            for side in ("cuda", "cpu"):
                segs = [Segmentator.from_state_dict(sd, device=side) for sd in sds]
                if side == "cpu":
                    for s in segs:
                        s.compute_dtype = torch.float64
                enet_mod.max_pool_2x2_with_mask_kernel = recording_pool(pool, seen, side)
                res = make_summary_step(segs, C, "soft")(img_u8.to(side), gt_u8.to(side),
                                                         idx, mask)
                out[side] = (res["pred"][0].cpu(), res["ens"][0].cpu())
    finally:
        enet_mod.max_pool_2x2_with_mask_kernel = pool
    # each model's forward makes two pool calls, model 0's first
    per_model = [count_flips(seen["cuda"][2 * k:2 * k + 2], seen["cpu"][2 * k:2 * k + 2])
                 for k in range(K)]
    flips, far = [f for f, _ in per_model], sum(n for _, n in per_model)
    valid = torch.from_numpy(mask[0])
    n_pix = int(valid.sum()) * img_u8.shape[1] * img_u8.shape[2]
    differ = [int((out["cuda"][0][k][valid] != out["cpu"][0][k][valid]).sum())
              for k in range(K)]
    vote_differ = int((out["cuda"][1][valid] != out["cpu"][1][valid]).sum())
    res = {"pixels": n_pix, "map_differ": differ, "vote_differ": vote_differ,
           "mask_flips": flips, "flips_not_near_tie": far,
           "mask_entries_per_model": sum(m.numel() for _, m in seen["cpu"][:2])}
    bad = far or any(d > 1e-4 * n_pix for d, f in zip(differ, flips) if not f) or (
        not any(flips) and vote_differ > 1e-4 * n_pix)
    if bad:
        raise AssertionError(f"{run_dir}: class maps or votes on the card differ from "
                             f"float64 beyond counted near-ties: {res}")
    return res


def run_spleen(torch, pk, card: str) -> dict:
    """Phase 8: configs/spleen_cotraining.yaml through the co-training CLI
    at 512² (fp32 as shipped, K = 2, B = Bu = 4) on a synthetic tree, one
    epoch of 10 iterations; then the summary with --axises 1 on its run;
    then the trained results/spleen512_r3/jsd_adv/best_0.ckpt on the card
    against float64. Returns the launches of the CLI run and the summary."""
    import csv
    import shutil
    from dct_tpu_torch.train_cotraining import main as cli_main
    tree, run, T = Path("build/spleen_synthetic"), Path("build/spleen_run"), 10
    committed = "results/spleen512_r3/jsd_adv"
    t0 = time.perf_counter()
    shutil.rmtree(tree, ignore_errors=True)
    shutil.rmtree(run, ignore_errors=True)
    write_spleen_tree(tree)
    print(f"phase 8: wrote the 512² spleen tree in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = cli_main(["--config", "configs/spleen_cotraining.yaml", f"Dataset.root_dir={tree}",
                        f"Trainer.save_dir={run}", "Trainer.max_epoch=1",
                        f"Trainer.iters_per_epoch={T}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cli_launches = dict(pk.LAUNCHES)
    P, K = len(trainer.val_buckets), trainer.K
    n = 8 * T                          # the fused step: 4 ENet passes × 2 a kernel
    want = dict(zip(FWD_BWD, (n + 2 * P * K, n + 2 * P * K, n, n)))
    if cli_launches != want or trainer.val_buckets.bucket_len != EVAL_L:
        raise AssertionError(f"spleen CLI: {T} iterations and {P * K} eval forwards of "
                             f"{trainer.val_buckets.bucket_len} slices launched "
                             f"{cli_launches}, expected {want} at {EVAL_L}")
    rows = _csv_rows(run)
    with open(Path(committed) / "metrics.csv", newline="") as f:
        ref_header = next(csv.reader(f))
    if list(rows[0]) != ref_header or len(rows) != 1:
        raise AssertionError(f"spleen metrics.csv: header {list(rows[0])}, {len(rows)} rows; "
                             f"{committed}'s header {ref_header}")
    for k, v in rows[0].items():
        if not math.isfinite(float(v)) or ("dice" in k and not 0.0 <= float(v) <= 1.0):
            raise AssertionError(f"spleen epoch 0: {k} = {v}")
    emit({"cli": "cotraining_spleen_512", "cli_epoch": 0,
          "t_train": float(rows[0]["t_train"]), "t_eval": float(rows[0]["t_eval"]),
          "t_call": wall, "iterations": T,
          "images_per_sec": float(rows[0]["images_per_sec"]),
          "tf32_convs": torch.backends.cudnn.allow_tf32, "card": card})
    out, s_wall, s_launches = summarise(torch, pk, run, P * K, "--axises", "1")
    check_summary_headers(run, committed)
    print(f"phase 8: spleen CLI at 512², 1 epoch of {T} iterations in {wall:.1f} s "
          f"(launches {cli_launches}); summary --axises 1 in {s_wall:.2f} s (launches "
          f"{s_launches}), headers of {committed}, kappa {out['div']}", flush=True)
    errs = check_trained_weights(torch, trainer.val_set, trainer.val_buckets,
                                 f"{committed}/best_0.ckpt", near_ties=True)
    print(f"phase 8: trained {committed}/best_0.ckpt, eval forward of a padded "
          f"{EVAL_L}-slice bucket at 512² on the card vs float64 CPU (share of scale): "
          f"{errs}", flush=True)
    return {"cli": cli_launches, "summary": s_launches}


# the Cityscapes tree phase 9 writes: 4 cities × 20 train and 2 val images
# at Cityscapes' own 1024×2048, raw label ids with void ids among them
CITY_RAW_IDS = (7, 8, 11, 21, 23, 24, 26, 33, 0, 1, 4)
CITY_COUNTS = {"train": 20, "val": 2}
CITY_NAMES = ("aachen", "bochum", "bremen", "cologne")
CITY_SIZE = (1024, 2048)


def write_city_tree(root: Path, seed: int = 3) -> None:
    """root/leftImg8bit/<mode>/<city>/<stem>_leftImg8bit.png and the
    matching gtFine/..._gtFine_labelIds.png: horizontal bands of raw ids
    with a disc of another, and an RGB rendering of them (a colour an id and
    blocky noise), written by 8 threads at PNG level 1."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    rs = np.random.RandomState(seed)
    h, w = CITY_SIZE
    yy, xx = np.mgrid[0:h, 0:w]
    palette = rs.randint(0, 256, (256, 3)).astype(np.int16)
    noise = rs.randint(-20, 21, (h // 4, w // 4, 3)).astype(np.int16).repeat(4, 0).repeat(4, 1)
    jobs = []
    for mode, n in CITY_COUNTS.items():
        for city in CITY_NAMES:
            for sub in ("leftImg8bit", "gtFine"):
                (root / sub / mode / city).mkdir(parents=True, exist_ok=True)
            jobs += [(mode, city, i, int(rs.randint(2**31))) for i in range(n)]

    def one(job):
        mode, city, i, seed_i = job
        r = np.random.RandomState(seed_i)
        bands = np.array(CITY_RAW_IDS)[r.randint(0, len(CITY_RAW_IDS), 4)]
        raw = bands[np.minimum(yy * 4 // h + xx * r.randint(0, 3) // w, 3)].astype(np.uint8)
        cy, cx, rad = r.randint(0, h), r.randint(0, w), r.randint(h // 6, h // 3)
        raw[(yy - cy) ** 2 + (xx - cx) ** 2 < rad * rad] = CITY_RAW_IDS[r.randint(len(CITY_RAW_IDS))]
        img = (palette[raw] + np.roll(noise, r.randint(w), axis=1)).clip(0, 255).astype(np.uint8)
        stem = f"{city}_{i:06d}_000019"
        Image.fromarray(img).save(root / "leftImg8bit" / mode / city / f"{stem}_leftImg8bit.png",
                                  compress_level=1)
        Image.fromarray(raw).save(root / "gtFine" / mode / city / f"{stem}_gtFine_labelIds.png",
                                  compress_level=1)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))


def city_iteration_launches(flags) -> tuple:
    """(forward, backward) launches of each kernel in one Cityscapes
    co-training iteration with these (2,) FGSM flags: 2 a pass; forward
    passes: the two fused ones, then per direction FGSM's generation,
    clean and adversarial forwards (3) or VAT's clean, perturbed, clean
    and adversarial forwards (4); backward passes: the fused pair, and per
    direction the attack's input gradient and the adversarial forward's."""
    return 2 * (2 + sum(3 if f else 4 for f in flags)), 2 * (2 + 2 * 2)


def run_city(torch, pk, card: str) -> dict:
    """Phase 9: both Cityscapes CLIs at full width on a synthetic
    1024×2048 tree, a resume each, and one iteration at the configs' λ
    maxima against float64 on the CPU. Returns the launches of each path."""
    import shutil
    from dct_tpu_torch.train import city as city_mod
    from dct_tpu_torch.train_cotraining_city import main as cotrain_main
    from dct_tpu_torch.train_sup_city import main as sup_main
    tree = Path("build/city_synthetic")
    t0 = time.perf_counter()
    shutil.rmtree(tree, ignore_errors=True)
    write_city_tree(tree)
    print(f"phase 9: wrote the {CITY_SIZE[0]}×{CITY_SIZE[1]} Cityscapes tree "
          f"({len(CITY_NAMES)} cities, {CITY_COUNTS}) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the flags each epoch draws, and the launches of each epoch call and of
    # each eval and prediction forward, read around the trainer's own parts
    drawn, evals = [], {"forwards": 0, **dict.fromkeys(pk.KERNELS, 0)}
    draw, make_eval, make_pred = (city_mod.CoTrainerCity.draw_indices,
                                  city_mod.make_city_eval_step, city_mod.make_city_pred_step)

    def recording_draw(self, T):
        out = draw(self, T)
        drawn.append(out[-1].copy())
        return out

    def counted(make):
        def build(*args):
            step = make(*args)

            def run(*a):
                before = dict(pk.LAUNCHES)
                out = step(*a)
                for k in pk.KERNELS:
                    evals[k] += pk.LAUNCHES[k] - before[k]
                evals["forwards"] += 1
                return out
            return run
        return build

    results = {}
    city_mod.CoTrainerCity.draw_indices = recording_draw
    city_mod.make_city_eval_step = counted(make_eval)
    city_mod.make_city_pred_step = counted(make_pred)
    try:
        for name, main, config, epochs in (
                ("city_cotraining", cotrain_main, "configs/cityscapes_cotraining.yaml", (2, 3)),
                ("city_supervised", sup_main, "configs/cityscapes_supervised.yaml", (1, 2))):
            run = Path(f"build/{name}_run")
            shutil.rmtree(run, ignore_errors=True)
            common = ["--config", config, f"Dataset.root_dir={tree}", "Dataset.subsample=1",
                      f"Trainer.save_dir={run}"]
            drawn.clear()
            evals.update({"forwards": 0, **dict.fromkeys(pk.KERNELS, 0)})
            torch.cuda.synchronize()
            pk.reset_launch_counts()
            t0 = time.perf_counter()
            first = main(common + [f"Trainer.max_epoch={epochs[0]}"])
            trainer = main(common + [f"Trainer.max_epoch={epochs[1]}",
                                     f"Trainer.checkpoint={run}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(pk.LAUNCHES)
            inner = getattr(trainer, "inner", trainer)
            check_city_run(name, run, inner, epochs[1], drawn, evals, launches,
                           train_adv=name == "city_cotraining")
            for epoch, r in enumerate(_csv_rows(run)):
                emit({"cli": name, "cli_epoch": epoch, "t_train": float(r["t_train"]),
                      "t_eval": float(r["t_eval"]),
                      "iterations": inner.iters_per_epoch,
                      "images_per_sec": float(r["images_per_sec"]),
                      "image_size": list(inner.val_set.image_size),
                      "tf32_convs": torch.backends.cudnn.allow_tf32,
                      "card": card})
            print(f"phase 9: {name}: {epochs[0]} epochs + resume to {epochs[1]} in "
                  f"{wall:.1f} s, {inner.iters_per_epoch} iterations an epoch, launches "
                  f"{launches} ({evals['forwards']} eval and prediction forwards)", flush=True)
            results[name] = launches
            if name == "city_cotraining":
                cot_trainer = trainer
            del first
    finally:
        city_mod.CoTrainerCity.draw_indices = draw
        city_mod.make_city_eval_step, city_mod.make_city_pred_step = make_eval, make_pred
    results["city_iteration"] = check_city_iteration(torch, pk, cot_trainer,
                                                     Path("build/city_cotraining_run"))
    return results


def check_city_run(name, run, trainer, max_epoch, drawn, evals, launches,
                   train_adv) -> None:
    """CSV columns and rows, finite losses, mIoU in [0, 1], checkpoints,
    the resume's start epoch, the prediction dumps (every 10th epoch of the
    co-training run), and the launches of every epoch's iterations and of
    every eval and prediction forward against what the flags say."""
    K = trainer.K
    rows = _csv_rows(run)
    header = (["epoch"] + [f"{p}_{s}" for p in ("val_mIoU", "val_acc") for s in range(K)]
              + [f"sup_loss_{s}" for s in range(K)]
              + ["jsd_loss", "adv_loss", "images_per_sec", "t_train", "t_eval"])
    if list(rows[0]) != header or [int(r["epoch"]) for r in rows] != list(range(max_epoch)):
        raise AssertionError(f"{name}: metrics.csv header {list(rows[0])}, epochs "
                             f"{[r['epoch'] for r in rows]}; expected {header}, {max_epoch}")
    for r in rows:
        for k, v in r.items():
            if not math.isfinite(float(v)) or ("mIoU" in k and not 0.0 <= float(v) <= 1.0):
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v}")
        if train_adv and not float(r["adv_loss"]) > 0:
            raise AssertionError(f"{name}: the adversarial term did not run: {r}")
    for s in range(K):
        for f in (f"last_{s}.ckpt", f"best_{s}.ckpt"):
            if not (run / f).is_file():
                raise AssertionError(f"{name}: {run / f} missing")
    if trainer.start_epoch != max_epoch - 1:
        raise AssertionError(f"{name}: resumed at epoch {trainer.start_epoch}")
    dumps = sorted(p.relative_to(run).as_posix() for p in run.rglob("*.png"))
    want = (sorted(f"iter000/eval/{s}/{stem}.png" for s in range(K)
                   for stem in trainer.val_set.filenames) if train_adv else [])
    if dumps != want:
        raise AssertionError(f"{name}: {len(dumps)} prediction dumps, expected {len(want)}")
    T = trainer.iters_per_epoch
    if len(drawn) != max_epoch or any(len(f) != T for f in drawn):
        raise AssertionError(f"{name}: {len(drawn)} epochs drawn, expected {max_epoch} of {T}")
    if train_adv:
        fwd = sum(city_iteration_launches(f)[0] for flags in drawn for f in flags)
        bwd = city_iteration_launches(drawn[0][0])[1] * T * max_epoch
    else:
        fwd = bwd = 2 * T * max_epoch
    n_val = len(trainer._val_batches())
    n_eval = K * n_val * (max_epoch + (1 if train_adv else 0))   # the epoch-0 dumps
    want_l = dict(zip(FWD_BWD, (fwd + 2 * n_eval, fwd + 2 * n_eval, bwd, bwd)))
    want_e = dict(zip(FWD_BWD, (2 * n_eval, 2 * n_eval, 0, 0)))
    if launches != want_l or {k: evals[k] for k in FWD_BWD} != want_e \
            or evals["forwards"] != n_eval:
        raise AssertionError(f"{name}: launched {launches} ({evals}), expected {want_l} with "
                             f"{n_eval} eval and prediction forwards ({want_e})")


def check_city_iteration(torch, pk, trainer, run: Path) -> dict:
    """One Cityscapes co-training iteration at full width (256×512, K = 2,
    B = Bu = 4) at the configs' λ maxima (λ_cot 1.0, λ_adv 0.005), with
    FGSM in one direction and VAT in the other, from the co-training run's
    last weights: on the card (fp32, TF32 off) and in float64 on the CPU,
    the same indices and VAT noise. Adam's eps is 1e-3 on both sides (the
    config's 1e-8 would turn the exactly-zero gradients of conv biases ahead
    of a BatchNorm, which each side computes as rounding noise, into ±lr
    steps). Fails unless the losses agree within 1e-4 relative (the
    adversarial one 2e-3: FGSM's sign flips where the two input gradients
    round apart, and VAT's ξ = 1e-6 direction is fp32 rounding), each
    model's update has cosine ≥ 0.99 to the float64 one, the running
    statistics agree within 1e-3 of each leaf's scale, and the launches are
    what ``city_iteration_launches`` says. Returns the launches."""
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train.city import make_city_cotrain_epoch
    from dct_tpu_torch.cli import supervised_loss
    from dct_tpu_torch.config import yaml_parser
    config = yaml_parser("configs/cityscapes_cotraining.yaml", [])
    sds = [load_checkpoint(run / f"last_{s}.ckpt")["segmentator"] for s in range(2)]
    for sd in sds:
        sd["optim_dict"] = {**sd["optim_dict"], "eps": 1e-3}
    idx = trainer.draw_indices(1)[:4]
    flags = np.array([[True, False]])
    B, (H, W) = trainer.batch_size, trainer.val_set.image_size
    noise = torch.randn((1, 2, B, H, W, 3), generator=torch.Generator().manual_seed(9))
    out = {}
    for side, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        segs = [Segmentator.from_state_dict(sd, device=side) for sd in sds]
        for s in segs:
            s.compute_dtype = dtype
        initial = [{k: v.detach().cpu().double() for k, v in s.net.state_dict().items()}
                   for s in segs]
        epoch = make_city_cotrain_epoch(segs, 19, supervised_loss(config), True, True,
                                        trainer.eps_fgsm, trainer.eps_vat)
        with tf32_off(torch):
            torch.cuda.synchronize()
            pk.reset_launch_counts()
            m = epoch(trainer._img_cat.to(side), trainer._gt_cat.to(side), *idx, flags,
                      None, 5e-4, 1.0, 0.005, vat_noise=noise.to(side))
            torch.cuda.synchronize()
        launches = dict(pk.LAUNCHES)
        out[side] = ({k: v.cpu().double() for k, v in m.items()}, initial,
                     [{k: v.detach().cpu().double() for k, v in s.net.state_dict().items()}
                      for s in segs], launches)
    (m_card, init, new_card, launches), (m_ref, _, new_ref, _) = out["cuda"], out["cpu"]
    errs = {k: float(((m_card[k] - m_ref[k]).abs() / m_ref[k].abs()).max()) for k in m_ref}
    cos, stats = [], []
    for s in range(2):
        keys = [k for k in init[s] if "running" not in k]
        upd = [torch.cat([(new[s][k] - init[s][k]).flatten() for k in keys])
               for new in (new_card, new_ref)]
        cos.append(float(torch.nn.functional.cosine_similarity(*upd, dim=0)))
        stats.append(max(float((new_card[s][k] - new_ref[s][k]).abs().max())
                         / max(1.0, float(new_ref[s][k].abs().max()))
                         for k in init[s] if "running" in k))
    fwd, bwd = city_iteration_launches(flags[0])
    res = {"loss_rel_err": errs, "update_cosine": cos, "stats_err": stats,
           "losses_card": {k: v.flatten().tolist() for k, v in m_card.items()},
           "launches": launches}
    if (errs["sup_loss"] > 1e-4 or errs["jsd_loss"] > 1e-4 or errs["adv_loss"] > 2e-3
            or min(cos) < 0.99 or max(stats) > 1e-3
            or launches != dict(zip(FWD_BWD, (fwd, fwd, bwd, bwd)))):
        raise AssertionError(f"Cityscapes iteration on the card vs float64: {res}")
    print(f"phase 9: one co-training iteration at 256×512, λ_cot 1.0, λ_adv 0.005, flags "
          f"[FGSM, VAT], on the card (TF32 off) vs float64 on the CPU: {res}", flush=True)
    return launches


# phase 10's CLI runs: (name, CLI module, config, tree ("sup": phase 6's,
# else phase 5's), overrides, epochs of the first call, of the resume or None)
SLICE8_RUNS = [
    ("unet_bn_sgd", "train_sup", "configs/acdc_supervised.yaml", "sup",
     ["Arch.name=unet_bn", "Optim.name=SGD", "Optim.momentum=0.9", "Optim.nesterov=True",
      "Scheduler.name=CosineAnnealingLR", "Scheduler.T_max=100"], 1, 2),
    ("fcn8_rmsprop", "train_sup", "configs/acdc_supervised.yaml", "sup",
     ["Arch.name=fcn8", "Optim.name=RMSprop", "Optim.lr=1e-5", "Scheduler.name=PolynomialLR",
      "Scheduler.max_epoch=100", "Loss.name=partial_ce"], 1, None),
    ("segnet_adamw", "train_cotraining", "configs/acdc_cotraining.yaml", "main",
     ["Arch.name=segnet", "Optim.name=AdamW", "Scheduler.name=MultiStepLR",
      "Scheduler.milestones=[50,80]", "Trainer.iters_per_epoch=20",
      "StartTraining.train_jsd=True", "StartTraining.train_adv=True"], 1, 2),
]
SLICE8_OPTIMIZERS = [
    {"name": "SGD", "lr": 1e-2, "momentum": 0.9},
    {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "nesterov": True},
    {"name": "AdamW", "lr": 1e-3},
    {"name": "RMSprop", "lr": 1e-5},
    {"name": "AdaBound", "lr": 1e-3},
    {"name": "AdaBound", "lr": 1e-3, "amsbound": True},
    {"name": "AdaBoundW", "lr": 1e-3},
]


def run_slice8(torch, pk, card: str, main_tree: Path) -> dict:
    """Phase 10, as the module docstring says. Returns the launches of each
    kernel on each new path (all 0)."""
    import importlib
    import shutil
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.train import CoTrainer, Trainer
    from dct_tpu_torch.utils.convert import optim_state_to_jax

    sup_tree = Path("build/acdc_synthetic_sup")
    starts = {"train_sup": Trainer, "train_cotraining": CoTrainer}
    originals = {c: c.start_training for c in starts.values()}
    calls = []

    def timed(cls):
        def run(self, *args, **kwargs):
            segs = getattr(self, "segmentators", None) or [self.segmentator]
            calls.append({"optim_at_start": [optim_state_to_jax(s.optimizer, s.net,
                                                                s.optim_dict) for s in segs]})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pk.reset_launch_counts()
            t = time.perf_counter()
            rows = originals[cls](self, *args, **kwargs)
            torch.cuda.synchronize()
            calls[-1].update(wall=time.perf_counter() - t, launches=dict(pk.LAUNCHES),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            return rows
        return run

    for cls in starts.values():
        cls.start_training = timed(cls)
    launches = {}
    try:
        for name, module, config, tree_name, overrides, first, resume in SLICE8_RUNS:
            tree = sup_tree if tree_name == "sup" else main_tree
            run = Path(f"build/{name}_run")
            shutil.rmtree(run, ignore_errors=True)
            cli_main = importlib.import_module(f"dct_tpu_torch.{module}").main
            common = (["--config", config, f"Dataset.root_dir={tree}",
                       f"Trainer.save_dir={run}"] + overrides)
            n0 = len(calls)
            trainer = cli_main(common + [f"Trainer.max_epoch={first}"])
            ckpt = run / ("last.ckpt" if module == "train_sup" else "")
            saved = (load_checkpoint(ckpt)["segmentator"]["optim_state_dict"]
                     if module == "train_sup" else None)
            if resume:
                trainer = cli_main(common + [f"Trainer.max_epoch={resume}",
                                             f"Trainer.checkpoint={ckpt}"])
            check_slice8_run(torch, name, run, calls[n0:], trainer, saved, card)
            launches[name] = {k: sum(c["launches"][k] for c in calls[n0:]) for k in pk.KERNELS}
            if name == "segnet_adamw":
                check_segnet_iteration(torch, pk, trainer, run)
            del trainer
    finally:
        for cls, start in originals.items():
            cls.start_training = start
    check_unet_cotraining_raises(main_tree)
    check_optimizers(torch)
    for name, n in launches.items():
        if any(n.values()):
            raise AssertionError(f"{name}: the pool kernels launched {n}, expected 0")
    print(f"phase 10: pool-kernel launches on the new paths {launches}", flush=True)
    return launches


def check_slice8_run(torch, name, run, calls, trainer, saved, card) -> None:
    """Finite CSV rows for every epoch, the checkpoints, the optimizer state
    across the resume, and one ``cli_epoch`` line an epoch."""
    rows = _csv_rows(run)
    if [int(r["epoch"]) for r in rows] != list(range(len(calls))):
        raise AssertionError(f"{name}: metrics.csv epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        for k, v in r.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v}")
            if "dice" in k and not 0.0 <= float(v) <= 1.0:
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v} outside [0, 1]")
    segs = getattr(trainer, "segmentators", None) or [trainer.segmentator]
    if name == "unet_bn_sgd":
        # the resume starts from the momentum trace epoch 0 saved
        start, trace = calls[1]["optim_at_start"][0]["trace"], saved["trace"]
        flat = list(zip(_tree_leaves(start), _tree_leaves(trace)))
        if not flat or any(not np.array_equal(a, b) for a, b in flat) or not any(
                np.any(b != 0) for _, b in flat):
            raise AssertionError("unet_bn_sgd: the resume did not start from the saved "
                                 "SGD momentum trace")
    if name == "segnet_adamw":
        counts = [int(c["optim_at_start"][0]["count"]) for c in calls]
        steps = {int(st["step"]) for st in segs[0].optimizer.state.values()}
        T = trainer.iters_per_epoch
        if counts != [0, T] or steps != {2 * T} or not trainer.fuse_forward:
            raise AssertionError(f"segnet_adamw: AdamW counts {counts} at the calls' starts, "
                                 f"{steps} at the end, fused {trainer.fuse_forward}")
    T = (trainer.iters_per_epoch if hasattr(trainer, "iters_per_epoch")
         else len(trainer.train_set) // trainer.batch_size)
    for epoch, (r, c) in enumerate(zip(rows, calls)):
        t_train, t_eval = float(r["t_train"]), float(r["t_eval"])
        emit({"cli": name, "cli_epoch": epoch, "t_train": t_train, "t_eval": t_eval,
              "t_host": c["wall"] - t_train - t_eval, "iterations": T,
              "s_per_iteration": t_train / T,
              "images_per_sec": float(r["images_per_sec"]),
              "peak_mem_gib": c["peak_gib"], "tf32_convs": torch.backends.cudnn.allow_tf32,
              "card": card})
    losses = {k: float(v) for k, v in rows[-1].items() if "loss" in k}
    print(f"phase 10: {name}: {len(rows)} epochs of {T} iterations, last losses {losses}",
          flush=True)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [np.asarray(tree)]


def check_segnet_iteration(torch, pk, trainer, run: Path) -> None:
    """One fused co-training iteration of the run's two SegNets (its last
    weights) at λ_cot 0.5, λ_adv 0.05, B = Bu = 2, the same indices and
    thetas, on the card (fp32, TF32 off) and in float64 on the CPU. AdamW's
    eps is 1e-3 on both sides (1e-8 would turn the exactly-zero gradients
    of conv biases ahead of a BatchNorm, rounding noise on each side, into
    ±lr steps). Fails unless the losses agree within 1e-4 relative (the
    adversarial one 2e-3: FGSM's sign flips where the two input gradients
    round apart), each update has cosine ≥ 0.99 to the float64 one, and the
    statistics agree within 1e-3 of each leaf's scale."""
    from dct_tpu_torch.data.augment import sample_aug_thetas
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.losses import get_loss_fn
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train.steps import make_cotrain_epoch
    sds = [load_checkpoint(run / f"last_{s}.ckpt")["segmentator"] for s in range(2)]
    for sd in sds:
        sd["optim_dict"] = {**sd["optim_dict"], "eps": 1e-3}
    rs = np.random.RandomState(12)
    n = trainer._img_cat.shape[0]
    B, (H, W) = 2, trainer._img_cat.shape[1:3]
    idx_lab, idx_unlab = rs.randint(0, n, (1, 2, B)), rs.randint(0, n, (1, B))
    thetas = sample_aug_thetas(torch.Generator().manual_seed(13), 3 * B, H, W)[None]
    out = {}
    for side, dtype in ((CARD, torch.float32), ("cpu", torch.float64)):
        segs = [Segmentator.from_state_dict(sd, device=side, in_channels=1) for sd in sds]
        for s in segs:
            s.compute_dtype = dtype
        initial = [{k: v.detach().cpu().double() for k, v in s.net.state_dict().items()}
                   for s in segs]
        epoch = make_cotrain_epoch(segs, 4, get_loss_fn("cross_entropy"), True, True, True,
                                   True, 0.03)
        with tf32_off(torch):
            torch.cuda.synchronize()
            m = epoch(trainer._img_cat.to(side), trainer._gt_cat.to(side), idx_lab, idx_unlab,
                      None, None, 1e-3, 0.5, 0.05, thetas=thetas.to(side))
            torch.cuda.synchronize()
        out[side] = ({k: v.cpu().double() for k, v in m.items()}, initial,
                     [{k: v.detach().cpu().double() for k, v in s.net.state_dict().items()}
                      for s in segs])
    (m_card, init, new_card), (m_ref, _, new_ref) = out[CARD], out["cpu"]
    errs = {k: float(((m_card[k] - m_ref[k]).abs() / m_ref[k].abs()).max())
            for k in ("sup_loss", "jsd_loss", "adv_loss")}
    cos, stats = [], []
    for s in range(2):
        keys = [k for k in init[s] if "running" not in k]
        upd = [torch.cat([(new[s][k] - init[s][k]).flatten() for k in keys])
               for new in (new_card, new_ref)]
        cos.append(float(torch.nn.functional.cosine_similarity(*upd, dim=0)))
        stats.append(max(float((new_card[s][k] - new_ref[s][k]).abs().max())
                         / max(1.0, float(new_ref[s][k].abs().max()))
                         for k in init[s] if "running" in k))
    res = {"loss_rel_err": errs, "update_cosine": cos, "stats_err": stats,
           "losses_card": {k: m_card[k].flatten().tolist() for k in errs}}
    if (errs["sup_loss"] > 1e-4 or errs["jsd_loss"] > 1e-4 or errs["adv_loss"] > 2e-3
            or min(cos) < 0.99 or max(stats) > 1e-3):
        raise AssertionError(f"SegNet iteration on the card vs float64: {res}")
    print(f"phase 10: one SegNet co-training iteration at 256², B = Bu = 2, λ_cot 0.5, "
          f"λ_adv 0.05, on the card (TF32 off) vs float64 on the CPU: {res}", flush=True)


def check_unet_cotraining_raises(main_tree: Path) -> None:
    """dct_tpu's co-training step passes no dropout RNG: flax raises for
    UNet. The port raises too, at the first train-mode forward."""
    from dct_tpu_torch.train_cotraining import main as cli_main
    try:
        cli_main(["--config", "configs/acdc_cotraining.yaml", f"Dataset.root_dir={main_tree}",
                  "Trainer.save_dir=build/unet_cotraining_run", "Trainer.max_epoch=1",
                  "Trainer.iters_per_epoch=1", "Arch.name=unet"])
    except RuntimeError as e:
        if "Dropout needs a generator" not in str(e):
            raise
        print(f"phase 10: train_cotraining with Arch.name=unet raises: {e}", flush=True)
        return
    raise AssertionError("train_cotraining with Arch.name=unet did not raise")


def check_optimizers(torch) -> None:
    """Each of ``SLICE8_OPTIMIZERS`` (weight decay 1e-4, the lr halved after
    step 6) takes 12 steps over ``unet_bn``'s 31 M parameters with the same
    seeded fp32 gradients, on the card in fp32 and on the CPU in float64:
    every parameter within 1e-5 of its float64 value, relative to the
    tensor's largest magnitude."""
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.optim import build_optimizer, set_lr
    seg = Segmentator({"name": "unet_bn", "num_classes": 4}, {"name": "Adam", "lr": 1e-3},
                      {"name": "StepLR", "step_size": 90}, torch.Generator().manual_seed(3),
                      device="cpu", in_channels=1)
    p0 = [p.detach().clone() for p in seg.net.parameters()]
    gen = torch.Generator().manual_seed(4)
    grads = [[torch.randn(p.shape, generator=gen) * (0.1 + t % 3) for p in p0]
             for t in range(12)]
    errs = {}
    for cfg in SLICE8_OPTIMIZERS:
        cfg = {**cfg, "weight_decay": 1e-4}
        finals = []
        for side, dtype in ((CARD, torch.float32), ("cpu", torch.float64)):
            params = [torch.nn.Parameter(p.to(side, dtype, copy=True)) for p in p0]
            opt = build_optimizer(cfg, params)
            for t in range(12):
                for p, g in zip(params, grads[t]):
                    p.grad = g.to(side, dtype)
                set_lr(opt, cfg["lr"] * (0.5 if t >= 6 else 1.0))
                opt.step()
            finals.append([p.detach().cpu().double() for p in params])
        err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))
                  for a, b in zip(*finals))
        key = cfg["name"] + "".join(f"_{k}" for k in ("nesterov", "amsbound") if cfg.get(k))
        errs[key] = err
        if err > 1e-5:
            raise AssertionError(f"{key}: 12 steps on the card {err:.3g} from float64")
    print(f"phase 10: 12 optimizer steps over unet_bn's parameters, card fp32 vs CPU "
          f"float64 (largest error relative to each tensor's scale): {errs}", flush=True)
    emit({"optimizers_card_vs_float64": errs})


# phase 11 (slice 9): the Cityscapes co-training CLI with DeepLabV3+ at
# full depth, its COCO init written here in the reference's key layout;
# its CLI overrides, the trunk depth of that init, the training CLIs of the
# other new archs (name, CLI module, config, tree as in SLICE8_RUNS,
# overrides, the kernels' launches a training iteration and an eval
# forward), the side of the forward checks and the size of the λ > 0
# DeepLabV3+ iteration (cut to n_blocks (1, 1, 1, 1) and 128×256 so that
# its float64 side on the CPU stays short)
SLICE9_CITY = ["Arch.name=deeplabv3plus"]
SLICE9_COCO_BLOCKS = (3, 4, 23, 3)
SLICE9_RUNS = [
    ("pspnet_sup", "train_sup", "configs/acdc_supervised.yaml", "sup",
     ["Arch.name=pspnet"], (0, 0, 0, 0), (0, 0, 0, 0)),
    ("jenet_sup", "train_sup", "configs/acdc_supervised.yaml", "sup",
     ["Arch.name=jenet"], (3, 2, 2, 2), (3, 2, 0, 0)),
    ("cnet_cotraining", "train_cotraining", "configs/acdc_cotraining.yaml", "main",
     ["Arch.name=cnet", "Trainer.iters_per_epoch=20", "StartTraining.train_jsd=True",
      "StartTraining.train_adv=True"], (0, 0, 0, 0), (0, 0, 0, 0)),
]
SLICE9_FWD_SIDE = 256
SLICE9_ITER = {"n_blocks": [1, 1, 1, 1], "grids": [1], "hw": (128, 256), "B": 2}


class _Tee:
    """sys.stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def write_coco_pth(torch, path: Path, n_blocks, seed: int = 6) -> dict:
    """A random DeepLabV2 state_dict in the reference's key layout (``scale.``
    prefixes, ``conv``/``bn`` pairs, ``aspp.stages``, ``num_batches_tracked``)
    and a 21-class COCO-sized head, written with ``torch.save``; returns it."""
    from dct_tpu_torch.models import get_arch
    net = get_arch("deeplabv2", {"num_classes": 21, "n_blocks": list(n_blocks),
                                 "in_channels": 3})
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, t in net.state_dict().items():
        parts = key.split(".")
        if parts[0] == "aspp":
            name = f"aspp.stages.{parts[1]}.{parts[2]}"
        else:
            trunk = "layer1.conv1" if parts[1] == "layer1_conv1" else ".".join(parts[1:-2])
            name = f"{trunk}.{'conv' if parts[-2] == 'Conv_0' else 'bn'}.{parts[-1]}"
        v = torch.randn(t.shape, generator=gen) * (0.02 if t.dim() == 4 else 0.1)
        if name.endswith("running_var"):
            v = v.abs() + 1.0
            sd["scale." + name.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
        elif name.endswith("bn.weight"):
            v = v + 1.0
        sd["scale." + name] = v
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)
    return sd


def run_slice9(torch, pk, card: str, main_tree: Path) -> dict:
    """Phase 11, as the module docstring says. Returns the launches of each
    kernel on each path."""
    import importlib
    import shutil
    from dct_tpu_torch import train_cotraining_city as city_cli
    from dct_tpu_torch.train import CoTrainer, CoTrainerCity, Trainer
    from dct_tpu_torch.train import trainer as trainer_mod

    calls = []
    evals = {"forwards": 0, **dict.fromkeys(pk.KERNELS, 0)}
    originals = {c: c.start_training for c in (Trainer, CoTrainer, CoTrainerCity)}
    eval_dice = trainer_mod.eval_dice

    def counted_eval_dice(eval_all, val_dev, val_buckets):
        before = dict(pk.LAUNCHES)
        out = eval_dice(eval_all, val_dev, val_buckets)     # ends on the host
        for k in pk.KERNELS:
            evals[k] += pk.LAUNCHES[k] - before[k]
        evals["forwards"] += len(val_buckets)
        return out

    def timed(cls):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            evals.update({"forwards": 0, **dict.fromkeys(pk.KERNELS, 0)})
            pk.reset_launch_counts()
            t = time.perf_counter()
            rows = originals[cls](self, *args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"wall": time.perf_counter() - t, "launches": dict(pk.LAUNCHES),
                          "eval": dict(evals),
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            return rows
        return run

    for cls in originals:
        cls.start_training = timed(cls)
    trainer_mod.eval_dice = counted_eval_dice
    launches = {}
    try:
        launches["deeplabv3plus_city"] = run_deeplab_city(torch, card, city_cli, calls)
        sup_tree = Path("build/acdc_synthetic_sup")
        for name, module, config, tree_name, overrides, per_iter, per_eval in SLICE9_RUNS:
            tree = sup_tree if tree_name == "sup" else main_tree
            run = Path(f"build/{name}_run")
            shutil.rmtree(run, ignore_errors=True)
            cli_main = importlib.import_module(f"dct_tpu_torch.{module}").main
            n0 = len(calls)
            trainer = cli_main(["--config", config, f"Dataset.root_dir={tree}",
                                f"Trainer.save_dir={run}", "Trainer.max_epoch=1"] + overrides)
            T = (trainer.iters_per_epoch if hasattr(trainer, "iters_per_epoch")
                 else len(trainer.train_set) // trainer.batch_size)
            check_slice9_run(torch, name, run, calls[n0:], T, per_iter, per_eval, card)
            if name == "cnet_cotraining" and not trainer.fuse_forward:
                raise AssertionError("cnet_cotraining: the fused forward did not run")
            launches[name] = {k: sum(c["launches"][k] for c in calls[n0:]) for k in pk.KERNELS}
            del trainer
    finally:
        for cls, start in originals.items():
            cls.start_training = start
        trainer_mod.eval_dice = eval_dice
    check_slice9_forwards(torch)
    launches["deeplabv3plus_iteration"] = check_deeplab_iteration(torch, pk)
    for name, n in launches.items():
        if name != "jenet_sup" and any(n.values()):
            raise AssertionError(f"{name}: the pool kernels launched {n}, expected 0")
    print(f"phase 11: pool-kernel launches on the new paths {launches}", flush=True)
    return launches


def run_deeplab_city(torch, card: str, city_cli, calls) -> dict:
    """Phase 11 (a): ``train_cotraining_city`` on phase 9's tree with
    DeepLabV3+ and ``Trainer.coco_init_pth`` at a random .pth written here,
    one epoch and a resume to a second; the trunk must load into both
    models (dct_tpu's line, and its first kernel equal to the .pth's) and
    ASPP-v3 keep its init. The batch of the shipped config is halved only if
    it does not fit on the card (the script says so)."""
    import shutil
    tree, run = Path("build/city_synthetic"), Path("build/deeplab_city_run")
    pth = Path("build/coco_init/deeplabv2_coco.pth")
    t0 = time.perf_counter()
    ref = write_coco_pth(torch, pth, SLICE9_COCO_BLOCKS)
    print(f"phase 11: wrote {pth} ({len(ref)} tensors) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    n_trunk = sum(1 for k in ref if "aspp" not in k and "num_batches" not in k)
    load = city_cli.load_coco_init
    checked = []

    def checked_load(segs, path):
        aspp = [s.net.aspp.c0.Conv_0.weight.detach().cpu().clone() for s in segs]
        load(segs, path)
        for s, a in zip(segs, aspp):
            got = s.net.trunk.layer1_conv1.Conv_0.weight.detach().cpu()
            if not torch.equal(got, ref["scale.layer1.conv1.conv.weight"]):
                raise AssertionError("the COCO trunk did not load into the model")
            if not torch.equal(s.net.aspp.c0.Conv_0.weight.detach().cpu(), a):
                raise AssertionError("ASPP-v3 took weights from the DeepLabV2 .pth")
        checked.append(len(segs))

    batch = []
    for attempt in ([], ["Lab_Dataloader.batch_size=2", "Unlab_Dataloader.batch_size=2"]):
        shutil.rmtree(run, ignore_errors=True)
        common = (["--config", "configs/cityscapes_cotraining.yaml", f"Dataset.root_dir={tree}",
                   "Dataset.subsample=1", f"Trainer.save_dir={run}",
                   f"Trainer.coco_init_pth={pth}"] + SLICE9_CITY + attempt)
        n0 = len(calls)
        tee = _Tee(sys.stdout)
        city_cli.load_coco_init = checked_load
        try:
            with contextlib.redirect_stdout(tee):
                city_cli.main(common + ["Trainer.max_epoch=1"])
                trainer = city_cli.main(common + ["Trainer.max_epoch=2",
                                                  f"Trainer.checkpoint={run}"])
            batch = attempt
            break
        except torch.cuda.OutOfMemoryError as e:
            if attempt:
                raise
            del calls[n0:]
            print(f"phase 11: deeplabv3plus at the shipped batch of 4 does not fit on the "
                  f"card ({e}); cut: batch 2", flush=True)
            torch.cuda.empty_cache()
        finally:
            city_cli.load_coco_init = load
    line = f">> torch init: loaded {n_trunk} tensors, skipped 0 (shape mismatch)"
    if tee.text().count(line) != 4 or checked != [2, 2]:
        raise AssertionError(f"phase 11: the COCO init did not load ({line!r} "
                             f"{tee.text().count(line)} times, checked {checked})")
    inner = trainer.inner if hasattr(trainer, "inner") else trainer
    rows, T = _csv_rows(run), inner.iters_per_epoch
    if [int(r["epoch"]) for r in rows] != [0, 1] or inner.start_epoch != 1:
        raise AssertionError(f"deeplabv3plus_city: epochs {[r['epoch'] for r in rows]}, "
                             f"resumed at {inner.start_epoch}")
    for r in rows:
        for k, v in r.items():
            if not math.isfinite(float(v)) or ("mIoU" in k and not 0.0 <= float(v) <= 1.0):
                raise AssertionError(f"deeplabv3plus_city epoch {r['epoch']}: {k} = {v}")
        if not float(r["adv_loss"]) > 0:
            raise AssertionError(f"deeplabv3plus_city: the adversarial term did not run: {r}")
    if not inner.segmentators[0].bn_momentum == 0.001:
        raise AssertionError("deeplabv3plus_city: not the fused forward's arch")
    for epoch, (r, c) in enumerate(zip(rows, calls[n0:])):
        t_train, t_eval = float(r["t_train"]), float(r["t_eval"])
        emit({"cli": "deeplabv3plus_city", "cli_epoch": epoch, "t_train": t_train,
              "t_eval": t_eval, "t_host": c["wall"] - t_train - t_eval, "iterations": T,
              "s_per_iteration": t_train / T, "images_per_sec": float(r["images_per_sec"]),
              "image_size": list(inner.val_set.image_size), "batch_cut": batch,
              "peak_mem_gib": c["peak_gib"], "tf32_convs": torch.backends.cudnn.allow_tf32,
              "card": card})
    print(f"phase 11: deeplabv3plus_city: ResNet-101 trunk {SLICE9_COCO_BLOCKS} loaded from "
          f"the .pth into both models ({n_trunk} tensors each), 1 epoch + resume of {T} "
          f"iterations, last losses { {k: float(v) for k, v in rows[-1].items() if 'loss' in k} }",
          flush=True)
    return {k: sum(c["launches"][k] for c in calls[n0:]) for k in FWD_BWD}


def check_slice9_run(torch, name, run, calls, T, per_iter, per_eval, card) -> None:
    """Finite CSV rows, dice in [0, 1], one ``cli_epoch`` line an epoch, and
    the kernels' launches a training iteration and an eval forward."""
    rows = _csv_rows(run)
    if [int(r["epoch"]) for r in rows] != list(range(len(calls))) or len(calls) != 1:
        raise AssertionError(f"{name}: metrics.csv epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        for k, v in r.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v}")
            if "dice" in k and not 0.0 <= float(v) <= 1.0:
                raise AssertionError(f"{name} epoch {r['epoch']}: {k} = {v} outside [0, 1]")
    for epoch, (r, c) in enumerate(zip(rows, calls)):
        ev, n_fwd = c["eval"], c["eval"]["forwards"]
        train = {k: c["launches"][k] - ev[k] for k in FWD_BWD}
        want = {k: n * T for k, n in zip(FWD_BWD, per_iter)}
        want_eval = {k: n * n_fwd for k, n in zip(FWD_BWD, per_eval)}
        if name.endswith("_sup") and not n_fwd:
            raise AssertionError(f"{name}: no eval forward was counted")
        if train != want or {k: ev[k] for k in FWD_BWD} != want_eval:
            raise AssertionError(f"{name} epoch {epoch}: {T} iterations launched {train} "
                                 f"(expected {want}); {n_fwd} eval forwards launched "
                                 f"{ {k: ev[k] for k in FWD_BWD} } (expected {want_eval})")
        t_train, t_eval = float(r["t_train"]), float(r["t_eval"])
        emit({"cli": name, "cli_epoch": epoch, "t_train": t_train, "t_eval": t_eval,
              "t_host": c["wall"] - t_train - t_eval, "iterations": T,
              "s_per_iteration": t_train / T, "images_per_sec": float(r["images_per_sec"]),
              "peak_mem_gib": c["peak_gib"], "launches_per_iteration": dict(zip(FWD_BWD, per_iter)),
              "launches_per_eval_forward": dict(zip(FWD_BWD, per_eval)), "eval_forwards": n_fwd,
              "tf32_convs": torch.backends.cudnn.allow_tf32, "card": card})
    print(f"phase 11: {name}: 1 epoch of {T} iterations, launches an iteration "
          f"{dict(zip(FWD_BWD, per_iter))}, an eval forward {dict(zip(FWD_BWD, per_eval))}, "
          f"last losses { {k: float(v) for k, v in rows[-1].items() if 'loss' in k} }",
          flush=True)


def check_slice9_forwards(torch) -> None:
    """Phase 11 (d): ``deeplabv2`` (1/8 logits), the MSC wrapper around it
    (train mode: the full, 0.5 and 0.75 scales and their max), ``resnet18``
    (train-mode BatchNorm) and ``vgg11`` (eval mode: it has dropout) at full
    depth on a 256² batch, on the card in fp32 (TF32 off) against the same
    weights in float64 on the CPU. Train-mode BatchNorm over one image
    renormalises channels of near-zero variance at each of the trunk's
    layers, which amplifies fp32 rounding: the CPU's own fp32 forward lies
    up to 7.4e-3 of scale from float64 at MSC's 0.5 scale (measured). So
    each output's error must be within twice the CPU fp32 forward's error
    (and 1e-6) of its scale."""
    from dct_tpu_torch.models import get_arch
    from dct_tpu_torch.models.deeplab import DeepLabV2_ResNet101_MSC
    from dct_tpu_torch.models.layers import init_weights_
    side = SLICE9_FWD_SIDE
    nets = [("deeplabv2", lambda: get_arch("deeplabv2", {"num_classes": 19, "in_channels": 3}),
             3, 1, True),
            ("deeplabv2_msc", lambda: DeepLabV2_ResNet101_MSC(19, in_channels=3), 3, 1, True),
            ("resnet18", lambda: get_arch("resnet18", {"num_classes": 4}), 1, 2, True),
            ("vgg11", lambda: get_arch("vgg11", {"num_classes": 4}), 1, 2, False)]
    errs = {}
    for name, build, cin, b, train in nets:
        gen = torch.Generator().manual_seed(7)
        net = build()
        init_weights_(net, gen)
        x = torch.rand((b, side, side, cin), generator=gen)
        outs = []
        for dev, dt in ((CARD, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
            m = build()
            m.load_state_dict(net.state_dict())
            m = m.to(dev, dt, memory_format=torch.channels_last).train(train)
            with tf32_off(torch), torch.no_grad():
                out = m(x.to(dev, dt))
            outs.append([o.cpu().double() for o in (out if isinstance(out, list) else [out])])
            del m
        card, cpu32, ref = outs
        errs[name] = {side_name: [float((o - r).abs().max() / r.abs().max())
                                  for o, r in zip(got, ref)]
                      for side_name, got in (("card_fp32", card), ("cpu_fp32", cpu32))}
        shapes = [tuple(r.shape) for r in ref]
        if any(c > 2 * p + 1e-6 for c, p in zip(errs[name]["card_fp32"],
                                                errs[name]["cpu_fp32"])):
            raise AssertionError(f"phase 11: {name} on the card vs float64: {errs[name]}")
        print(f"phase 11: {name} forward at {side}², outputs {shapes}, fp32 on the card (TF32 "
              f"off) and on the CPU vs float64 on the CPU (share of scale): {errs[name]}",
              flush=True)
    emit({"slice9_forwards_vs_float64": errs})


def check_deeplab_iteration(torch, pk) -> dict:
    """Phase 11 (e): one Cityscapes co-training iteration of two DeepLabV3+
    (full widths, ``SLICE9_ITER``'s depth and size, 19 classes, B = Bu =
    ``SLICE9_ITER["B"]``) at the configs' λ maxima (λ_cot 1.0, λ_adv 0.005),
    FGSM in one direction and VAT in the other, the fused forward, from the
    same init on the card (fp32, TF32 off) and in float64 on the CPU, the
    same indices, labels (void pixels among them) and VAT noise; Adam eps
    1e-3 (as ``check_city_iteration`` says why). Fails unless the losses
    agree within 1e-4 relative (the adversarial one 2e-3), each update has
    cosine ≥ 0.99 to the float64 one and the running statistics agree
    within 1e-3 of each leaf's scale. Returns the launches (none)."""
    from dct_tpu_torch.cli import supervised_loss
    from dct_tpu_torch.config import yaml_parser
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train.city import make_city_cotrain_epoch
    config = yaml_parser("configs/cityscapes_cotraining.yaml", [])
    (H, W), B = SLICE9_ITER["hw"], SLICE9_ITER["B"]
    arch = {"name": "deeplabv3plus", "num_classes": 19, "n_blocks": SLICE9_ITER["n_blocks"],
            "grids": SLICE9_ITER["grids"]}
    optim = {"name": "Adam", "lr": 5e-4, "weight_decay": 2e-4, "eps": 1e-3}
    sched = {"name": "StepLR", "step_size": 100, "gamma": 0.1}
    rs = np.random.RandomState(12)
    N = 8
    img = torch.from_numpy(rs.randint(0, 256, (N, H, W, 3)).astype(np.uint8))
    gt = rs.randint(0, 19, (N, H, W)).astype(np.uint8)
    gt[:, : H // 8] = 250
    gt = torch.from_numpy(gt)
    idx = (rs.randint(0, N, (1, 2, B)).astype(np.int32), rs.randint(0, N, (1, B)).astype(np.int32),
           rs.randint(0, N, (1, 2, B)).astype(np.int32), rs.randint(0, N, (1, 2, B)).astype(np.int32))
    flags = np.array([[True, False]])
    noise = torch.randn((1, 2, B, H, W, 3), generator=torch.Generator().manual_seed(13))
    inits = [Segmentator(arch, optim, sched, torch.Generator().manual_seed(20 + k),
                         device="cpu", in_channels=3).net.state_dict() for k in range(2)]
    out = []
    for side, dtype in ((CARD, torch.float32), ("cpu", torch.float64)):
        segs = [Segmentator(arch, optim, sched, torch.Generator().manual_seed(0), device=side,
                            in_channels=3) for _ in range(2)]
        for s, sd in zip(segs, inits):
            s.net.load_state_dict(sd)
            s.compute_dtype = dtype
        epoch = make_city_cotrain_epoch(segs, 19, supervised_loss(config), True, True,
                                        0.03, 0.03)
        with tf32_off(torch):
            torch.cuda.synchronize()
            pk.reset_launch_counts()
            t0 = time.perf_counter()
            m = epoch(img.to(side), gt.to(side), *idx, flags, None, 5e-4, 1.0, 0.005,
                      vat_noise=noise.to(side))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        out.append(({k: v.cpu().double() for k, v in m.items()},
                    [{k: v.detach().cpu().double() for k, v in s.net.state_dict().items()}
                     for s in segs], dict(pk.LAUNCHES), dt))
        del segs, epoch
    (m_card, new_card, launches, dt_card), (m_ref, new_ref, _, dt_ref) = out
    errs = {k: float(((m_card[k] - m_ref[k]).abs() / m_ref[k].abs()).max()) for k in m_ref}
    cos, stats = [], []
    for s in range(2):
        init = {k: v.double() for k, v in inits[s].items()}
        keys = [k for k in init if "running" not in k]
        upd = [torch.cat([(new[s][k] - init[k]).flatten() for k in keys])
               for new in (new_card, new_ref)]
        cos.append(float(torch.nn.functional.cosine_similarity(*upd, dim=0)))
        stats.append(max(float((new_card[s][k] - new_ref[s][k]).abs().max())
                         / max(1.0, float(new_ref[s][k].abs().max()))
                         for k in init if "running" in k))
    res = {"loss_rel_err": errs, "update_cosine": cos, "stats_err": stats,
           "losses_card": {k: v.flatten().tolist() for k, v in m_card.items()},
           "seconds_card": dt_card, "seconds_cpu_float64": dt_ref, "launches": launches}
    if (errs["sup_loss"] > 1e-4 or errs["jsd_loss"] > 1e-4 or errs["adv_loss"] > 2e-3
            or min(cos) < 0.99 or max(stats) > 1e-3):
        raise AssertionError(f"DeepLabV3+ iteration on the card vs float64: {res}")
    print(f"phase 11: one DeepLabV3+ co-training iteration (n_blocks "
          f"{SLICE9_ITER['n_blocks']}, full widths, {H}×{W}, B = Bu = {B}), λ_cot 1.0, "
          f"λ_adv 0.005, flags [FGSM, VAT], on the card (TF32 off) vs float64 on the CPU: "
          f"{res}", flush=True)
    emit({"deeplabv3plus_iteration_card_vs_float64": res})
    return launches


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


SLICE10_ITERS = 20
SLICE10_CLI = [
    # name, CLI module, tree, overrides, the mesh dct_tpu prints (None: no line)
    ("par1", "dct_tpu_torch.train_cotraining", "main", ["Trainer.parallel=1"],
     "{'model': 1, 'data': 1}"),
    ("auto", "dct_tpu_torch.train_cotraining", "main", ["Trainer.parallel=auto"], None),
    ("sup_auto", "dct_tpu_torch.train_sup", "sup", ["Trainer.parallel=auto"], None),
]
# phase 12 (b): one iteration on phase 5's tree's first 16 slices, fp32,
# TF32 off, cuDNN's deterministic algorithms (two runs of a step then agree
# to the bit, so the model-parallel ranks, which compute what the single
# process computes, equal it exactly)
SLICE10_STEP = {"K": 2, "B": 4, "Bu": 4, "H": 256, "N": 16, "T": 1, "lam_cot": 0.5,
                "lam_adv": 0.05, "device": "cuda:0", "tf32": False, "seed": 4,
                "deterministic": True}
SLICE10_SPATIAL = [{"net": "twoconv", "H": 64, "W": 256, "halo": 8, "device": "cuda:0"},
                   {"net": "enet", "B": 2, "H": 256, "W": 512, "halo": 64,
                    "device": "cuda:0"}]


def cli_worker(argv) -> int:
    """``--cli-worker OUT MODULE ARGS...``: run a CLI's ``main(ARGS)`` in this
    process (a rank of a torchrun launch) and write OUT.RANK.json with the
    launches of its training epochs, their iterations and its mesh."""
    import importlib
    import torch
    from dct_tpu_torch.cli import finish
    from dct_tpu_torch.ops import pool_kernels as pk
    from dct_tpu_torch.train import CoTrainer, Trainer
    out, module, args = argv[0], argv[1], argv[2:]
    mod = importlib.import_module(module)
    cls = CoTrainer if "cotraining" in module else Trainer
    train_epoch = cls._train_epoch
    seen = {"iterations": 0, **dict.fromkeys(pk.KERNELS, 0)}

    def counted(self, *a):
        torch.cuda.synchronize()
        before = dict(pk.LAUNCHES)
        result = train_epoch(self, *a)
        torch.cuda.synchronize()
        for k in pk.KERNELS:
            seen[k] += pk.LAUNCHES[k] - before[k]
        seen["iterations"] += (self.iters_per_epoch if cls is CoTrainer
                               else self.batcher.n // self.batcher.batch_size)
        return result

    cls._train_epoch = counted
    trainer = mod.main(args)
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    Path(f"{out}.{rank}.json").write_text(json.dumps(
        {"train": seen, "mesh": None if trainer.mesh is None else trainer.mesh.shape}))
    finish()
    return 0


def _epoch0_losses(run: Path) -> dict:
    rows = _csv_rows(run)
    return {k: float(v) for k, v in rows[0].items()
            if k.endswith("loss") or "_loss_" in k}


def run_slice10(torch, pk, card: str, main_tree: Path) -> dict:
    """Phase 12, as the module docstring says. Returns the launches a
    training iteration makes on each path and rank."""
    import shutil
    import subprocess
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.parallel.dryrun import (case_models, cotrain_case, max_rel_diff,
                                               merge_models, run_cases, spawn)

    # (a) the CLIs at world 1 under torchrun
    trees = {"main": main_tree, "sup": Path("build/acdc_synthetic_sup")}
    per_iter, runs = {}, {}
    for name, module, tree, overrides, want_mesh in SLICE10_CLI:
        run = Path(f"build/slice10_{name}")
        shutil.rmtree(run, ignore_errors=True)
        config = ("configs/acdc_cotraining.yaml" if "cotraining" in module
                  else "configs/acdc_supervised.yaml")
        args = ["--config", config, f"Dataset.root_dir={trees[tree]}",
                f"Trainer.save_dir={run}", "Trainer.max_epoch=1", *overrides]
        if "cotraining" in module:
            args += [f"Trainer.iters_per_epoch={SLICE10_ITERS}",
                     "StartTraining.train_jsd=True", "StartTraining.train_adv=True"]
        out = f"build/slice10_{name}_launches"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "1", "chip_smoke.py", "--cli-worker",
                               out, module, *args], capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"phase 12: {name} failed:\n{proc.stdout[-3000:]}"
                               f"\n{proc.stderr[-6000:]}")
        meshes = [line.split(":", 1)[1].strip() for line in proc.stdout.splitlines()
                  if line.startswith(">> parallel mesh:")]
        if meshes != ([want_mesh] if want_mesh else []):
            raise AssertionError(f"phase 12: {name} printed meshes {meshes}, dct_tpu "
                                 f"prints {want_mesh}")
        seen = json.loads(Path(f"{out}.0.json").read_text())["train"]
        launches = {k: seen[k] / seen["iterations"] for k in pk.KERNELS}
        want = 8 if "cotraining" in module else 2
        if any(v != want for v in launches.values()):
            raise AssertionError(f"phase 12: {name} launched {launches} an iteration, "
                                 f"expected {want} of each")
        per_iter[f"cli_{name}"] = launches
        rows = _csv_rows(run)
        runs[name] = _epoch0_losses(run)
        emit({"slice10_cli": name, "mesh": meshes[0] if meshes else None,
              "t_train": float(rows[0]["t_train"]), "iterations": seen["iterations"],
              "s_per_iteration": float(rows[0]["t_train"]) / seen["iterations"],
              "wall_s": wall, "launches_per_iteration": launches, "card": card})
    # the same config with Trainer.parallel unset: phase 5's first epoch
    unset = _epoch0_losses(Path("build/cli_run"))
    for name in ("par1", "auto") if runs else ():
        gap = max(abs(runs[name][k] - unset[k]) for k in unset)
        print(f"phase 12 (a): {name} epoch-0 losses vs Trainer.parallel unset (phase 5): "
              f"max gap {gap:.3e} (dct_tpu's DP-vs-single tolerance 1e-2)", flush=True)
        if not gap <= 1e-2:
            raise AssertionError(f"phase 12: {name} losses {runs[name]} vs {unset}")
    phase5 = _csv_rows(Path("build/cli_run"))
    print(f"phase 12 (a): s an iteration, epoch 0 of a fresh process: "
          + ", ".join(f"{n} {float(_csv_rows(Path(f'build/slice10_{n}'))[0]['t_train']) / 20:.4f}"
                      for n in runs)
          + f"; phase 5 epoch 0 / 1: {float(phase5[0]['t_train']) / 20:.4f} / "
          f"{float(phase5[1]['t_train']) / 20:.4f} ({card})", flush=True)

    # (b) and (c): two ranks on the one card, gloo
    sd = load_checkpoint("results/ACDC_cotrain_r3/best_0.ckpt")["segmentator"]
    trained = Segmentator.from_state_dict(sd, device="cpu").net.state_dict()
    step = {**SLICE10_STEP, "tree": str(main_tree)}
    mp_case, dp_case = {**step, "n_model": 2}, {**step, "n_model": 1}
    spatial = [dict(c) for c in SLICE10_SPATIAL]
    spatial[1]["weights"] = trained
    cases = [("cotrain_case", mp_case), ("cotrain_case", dp_case),
             ("spatial_case", spatial[0]), ("spatial_case", spatial[1])]
    t0 = time.perf_counter()
    ranks = spawn(run_cases, 2, (cases,), timeout=600)
    t_two = time.perf_counter() - t0
    ref = cotrain_case(0, 1, {**step, "n_model": None})
    init = {k: s.net.state_dict() for k, s in enumerate(case_models(step, "cpu"))}
    print(f"phase 12 (b): two gloo ranks on one card in {t_two:.1f} s (spawn, builds, "
          f"4 cases); collectives staged through the host: "
          f"{[r['host_staged'] for r in ranks]}; single-process step "
          f"{ref['seconds']:.3f} s ({card})", flush=True)
    for i, (name, case) in enumerate((("model-parallel 2x1", mp_case),
                                      ("data-parallel 1x2", dp_case))):
        got = [r["results"][i] for r in ranks]
        models = merge_models(got)
        m, r = got[0]["metrics"], ref["metrics"]
        sup_gap = float(np.max(np.abs(m["sup_loss"] - r["sup_loss"]) / np.abs(r["sup_loss"])))
        jsd = m["jsd_loss"].mean(1) if m["jsd_loss"].ndim == 2 else m["jsd_loss"]
        adv = m["adv_loss"].sum(1) if m["adv_loss"].ndim == 2 else m["adv_loss"]
        jsd_gap = float(np.max(np.abs(jsd - r["jsd_loss"]) / np.abs(r["jsd_loss"])))
        adv_gap = float(np.max(np.abs(adv - r["adv_loss"]) / np.abs(r["adv_loss"])))
        cos = []
        for k in init:
            keys = [n for n in init[k] if init[k][n].is_floating_point() and "running" not in n]
            u = torch.cat([(models[k][n].double() - init[k][n].double()).flatten() for n in keys])
            v = torch.cat([(ref["models"][k][n].double() - init[k][n].double()).flatten()
                           for n in keys])
            cos.append(float(u @ v / (u.norm() * v.norm())))
        stats = [max_rel_diff({k: models[k]}, {k: ref["models"][k]}, stats=True)
                 for k in init]
        print(f"phase 12 (b): {name}: sup {sup_gap:.2e} jsd {jsd_gap:.2e} adv {adv_gap:.2e} "
              f"relative; update cosine {[round(c, 6) for c in cos]}; statistics "
              f"{[f'{x:.2e}' for x in stats]} of scale; rank seconds "
              f"{[round(g['seconds'], 3) for g in got]}", flush=True)
        if not (sup_gap <= 1e-4 and jsd_gap <= 1e-4 and adv_gap <= 2e-3
                and min(cos) >= 0.999 and stats[1] <= 1e-3 and stats[0] <= 2e-3):
            raise AssertionError(f"phase 12: {name} disagrees with one process")
        for rank, g in enumerate(got):
            want = slice10_rank_launches(case, rank)
            if g["launches"] != dict.fromkeys(pk.KERNELS, want):
                raise AssertionError(f"phase 12: {name} rank {rank} launched "
                                     f"{g['launches']}, its passes give {want} each")
            per_iter[f"{'mp' if case['n_model'] == 2 else 'dp'}_rank{rank}"] = g["launches"]
        print(f"phase 12 (b): {name} launches per rank "
              f"{[g['launches'] for g in got]}", flush=True)
    two = [r["results"][2] for r in ranks]
    err = max(float((t["tiled"] - two[0]["full"]).abs().max()) for t in two)
    print(f"phase 12 (c): two-conv net, halo 8, tiled vs full: max abs {err:.2e}", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"phase 12: two-conv tiled output off by {err}")
    enet = [r["results"][3] for r in ranks]
    agree = min(float((t["tiled"].argmax(-1) == enet[0]["full"].argmax(-1)).float().mean())
                for t in enet)
    print(f"phase 12 (c): ENet (results/ACDC_cotrain_r3/best_0.ckpt) 256x512, halo 64, "
          f"argmax agreement tiled vs full {agree:.6f}", flush=True)
    if not agree > 0.9:
        raise AssertionError(f"phase 12: ENet argmax agreement {agree}")
    return per_iter


def slice10_rank_launches(case: dict, rank: int) -> int:
    """Launches of each kernel one rank of phase 12 (b) makes in its one
    iteration: two pools and two unpools a forward, each forward
    backpropagated once. Data-parallel, every rank runs the whole step:
    the fused forward of each model, FGSM's generation and the adversarial
    forward (4 forwards). Model-parallel with one model a rank, rank 0
    owns model a = 0 (its fused forward and the adversarial one), rank 1
    model b = 1 (its fused forward and the generation)."""
    forwards = case["K"] + 2 if case["n_model"] == 1 else 2
    return 2 * forwards


# phase 13: the Op enum of csrc/pool_mask.cu's tiled_kernel, in its order
TILED_OPS = {"kPoolFwd": "pool_mask_fwd", "kPoolBwd": "pool_mask_bwd",
             "kUnpoolFwd": "unpool_fwd", "kUnpoolBwd": "unpool_bwd"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE11_LOSS_WEIGHT = [0.5, 2.0, 1.0, 4.0]


def traced_kernel(name: str):
    """The port's kernel a trace event's name launches, or None for any
    other kernel: ``(anonymous namespace)::tiled_kernel<((anonymous
    namespace)::Op)2, ...>`` as the trace names it, or
    ``tiled_kernel<Op::kUnpoolFwd, ...>``, or not demangled
    (``...tiled_kernelILNS_2OpE2E...``)."""
    import re
    m = (re.search(r"tiled_kernel<[^,]*?\bOp(?:\)\s*|::)(\w+)", name)
         or re.search(r"tiled_kernelIL\w*?OpE?(\d+)E", name))
    if m is None:
        return None
    ops = list(TILED_OPS.values())
    tok = m.group(1)
    if tok.isdigit() and int(tok) < len(ops):
        return ops[int(tok)]
    if tok in TILED_OPS:
        return TILED_OPS[tok]
    raise AssertionError(f"phase 13: a tiled_kernel event no kernel claims: {name}")


def check_trace(torch, pk, card: str, img_u8, gt_u8, rs, logdir: Path) -> tuple:
    """Phase 13 (a): ``trace_epoch`` around 3 fused bf16 co-training
    iterations (one more before, outside the trace); the trace's device
    events of the four kernels must equal the counters. Returns (the
    counters, the kernels' share of the traced device time). The names and
    counts of the trace's device events go to ``OUT_DIR``."""
    from collections import Counter
    from dct_tpu_torch.losses import get_loss_fn
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train.steps import make_cotrain_epoch
    from dct_tpu_torch.utils.logging import trace_epoch
    ce = get_loss_fn("cross_entropy")
    gen = torch.Generator(device="cuda").manual_seed(13)
    segs = build_models(torch, Segmentator, "bfloat16", 30)
    run_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8, gt_u8, rs, 1, gen)
    with trace_epoch(logdir) as prof:
        _, _, counters = run_step(torch, pk, make_cotrain_epoch, ce, segs, img_u8, gt_u8,
                                  rs, 3, gen)
    assert prof is not None
    traces = list(logdir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"phase 13: trace_epoch wrote {traces}")
    events = [e for e in json.loads(traces[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    names = Counter((e["cat"], e.get("name", "")) for e in events)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase13_trace_events.json").write_text(json.dumps(
        sorted(([c, n, k] for (c, n), k in names.items()), key=lambda r: -r[2]), indent=0))
    seen = dict.fromkeys(pk.KERNELS, 0)
    kernel_us = 0.0
    for e in events:
        k = traced_kernel(e.get("name", "")) if e["cat"] == "kernel" else None
        if k is not None:
            seen[k] += 1
            kernel_us += float(e["dur"])
    device_us = sum(float(e["dur"]) for e in events)
    if seen != counters or set(seen.values()) != {3 * 8}:
        raise AssertionError(
            f"phase 13: the trace holds {seen} launches of the kernels, the counters "
            f"{counters} (8 each an iteration); its {len(events)} device events by "
            f"category {Counter(e['cat'] for e in events)}, names "
            f"{[n[:100] for (_, n), _ in names.most_common(12)]}")
    share = kernel_us / device_us
    print(f"phase 13 (a): trace_epoch, 3 fused bf16 iterations -> {traces[0]} "
          f"({traces[0].stat().st_size / 2**20:.1f} MiB): {len(events)} device events, "
          f"device time {device_us / 1e3:.3f} ms, the four kernels {seen} in the trace = "
          f"the counters, {kernel_us / 1e3:.3f} ms: {100 * share:.3f} % of the traced "
          f"device time ({card})", flush=True)
    emit({"slice11_trace": {"device_ms": device_us / 1e3, "kernel_ms": kernel_us / 1e3,
                            "kernel_share": share, "events": len(events),
                            "by_category": dict(Counter(e["cat"] for e in events)),
                            "launches": seen}, "card": card})
    return counters, share


def run_slice11(torch, pk, card: str, cli: dict) -> dict:
    """Phase 13, slice 11's paths on the card, (a)–(f) as the module
    docstring says. Returns each path's launches."""
    import shutil
    from dct_tpu_torch.adversarial import FSGMGenerator, VATGenerator, fgsm, vat_perturbation
    from dct_tpu_torch.checkpoint import load_checkpoint
    from dct_tpu_torch.data.augment import (augment_batch, augment_batch_with_thetas,
                                            augment_u8_with_thetas, sample_aug_thetas)
    from dct_tpu_torch.data.pipeline import normalize_gather, warp_gather_normalize
    from dct_tpu_torch.losses import get_loss_fn
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train.steps import make_eval_patient_step
    t_start = time.perf_counter()
    out_dir = Path("build/phase13")
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        launches[name] = dict(pk.LAUNCHES)
        return result

    # (a) the trace, on bench.py's data set
    rs = np.random.RandomState(0)
    N, H = 1674, 256
    img_u8 = torch.from_numpy(rs.randint(0, 255, (N, H, H), dtype=np.uint8)).cuda()
    gt_u8 = torch.from_numpy(rs.randint(0, 4, (N, H, H)).astype(np.uint8)).cuda()
    ce = get_loss_fn("cross_entropy")
    launches["trace_3_iterations"], share = check_trace(torch, pk, card, img_u8, gt_u8, rs,
                                                        out_dir / "trace")

    # (b) the warp API on B = 12 indices, under one draw of thetas
    idx = torch.from_numpy(rs.randint(0, N, 12)).cuda()
    thetas = sample_aug_thetas(torch.Generator(device="cuda").manual_seed(5), 12, H, H)
    two_step = augment_batch_with_thetas(*normalize_gather(img_u8, gt_u8, idx), thetas)
    paths = {
        "augment_batch": augment_batch(*normalize_gather(img_u8, gt_u8, idx),
                                       torch.Generator(device="cuda").manual_seed(5)),
        "augment_u8_with_thetas": augment_u8_with_thetas(img_u8[idx], gt_u8[idx], thetas),
        "warp_gather_normalize": warp_gather_normalize(img_u8, gt_u8, idx, thetas)}
    cpu = {"two_step": augment_batch_with_thetas(
        *normalize_gather(img_u8[idx].cpu(), gt_u8[idx].cpu(), torch.arange(12)),
        thetas.cpu())}
    cpu["warp_gather_normalize"] = warp_gather_normalize(img_u8[idx].cpu(), gt_u8[idx].cpu(),
                                                         torch.arange(12), thetas.cpu())
    diffs = {name: [int((a != b).sum()) for a, b in zip(got, two_step)]
             for name, got in paths.items()}
    diffs.update({f"{name}_vs_cpu": [int((a.cpu() != b).sum()) for a, b in zip(two_step, got)]
                  for name, got in cpu.items()})
    print(f"phase 13 (b): the warps on the card vs the two-step warp, and the card vs the "
          f"CPU port, differing (image, label) pixels: {diffs}", flush=True)
    if any(any(d) for d in diffs.values()):
        raise AssertionError(f"phase 13: warps differ: {diffs}")
    del img_u8, gt_u8

    # (c)-(e) the trained r3 ENet (cuDNN's deterministic algorithms: two
    # identical calls then agree to the bit)
    sd = load_checkpoint("results/ACDC_cotrain_r3/best_0.ckpt")["segmentator"]
    seg = Segmentator.from_state_dict(sd, device="cuda")
    val, buckets = cli["val"], cli["buckets"]
    p = [p for p in range(len(buckets)) if not buckets.mask[p].all()][0]
    x = torch.from_numpy(val.data["img"][buckets.indices[p][:8]]).cuda().float()[..., None] / 255.0
    gt = torch.from_numpy(val.data["gt"][buckets.indices[p][:4]]).cuda().long()
    d = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        shim = {"fgsm": counted("fgsm", lambda: FSGMGenerator(seg, 0.03)(x, gt, ce)),
                "vat": counted("vat", lambda: VATGenerator(seg, 1e-6, 10.0, 1)(x, d=d)),
                "vat_generator": VATGenerator(seg, 1e-6, 10.0, 1)(
                    x, generator=torch.Generator(device="cuda").manual_seed(7))}
        direct = {"fgsm": fgsm(seg, x, gt, ce, 0.03),
                  "vat": vat_perturbation(seg, x, 1e-6, 10.0, 1, d=d),
                  "vat_generator": vat_perturbation(
                      seg, x, 1e-6, 10.0, 1,
                      generator=torch.Generator(device="cuda").manual_seed(7))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    equal = {k: all(same(a, b) for a, b in zip(shim[k], direct[k])) for k in shim}
    norms = shim["vat"][1].flatten(1).double().norm(dim=1)
    print(f"phase 13 (c): FSGMGenerator / VATGenerator (ip = 1) on results/ACDC_cotrain_r3 "
          f"best_0 vs the direct calls, bit-equal: {equal}; launches FGSM "
          f"{launches['fgsm']}, VAT {launches['vat']}; ‖r_adv‖ {norms.tolist()}", flush=True)
    if not all(equal.values()):
        raise AssertionError(f"phase 13: the shims differ from the direct calls: {equal}")
    for name, want in (("fgsm", (2, 2, 2, 2)), ("vat", (4, 4, 2, 2))):
        if launches[name] != dict(zip(FWD_BWD, want)):
            raise AssertionError(f"phase 13: {name} launched {launches[name]}, expected "
                                 f"{dict(zip(FWD_BWD, want))}")
    probs = counted("predict", lambda: seg.predict(x, logit=False))
    row_err = float((probs.double().sum(-1) - 1).abs().max())
    print(f"phase 13 (d): predict(logit=False): rows sum to 1 within {row_err:.2e}; "
          f"launches {launches['predict']}", flush=True)
    if not (row_err <= 1e-5 and launches["predict"] == dict(zip(FWD_BWD, (2, 2, 0, 0)))):
        raise AssertionError(f"phase 13: predict(logit=False) {row_err}, {launches['predict']}")
    # the shims' train-mode forwards moved seg's running statistics: the
    # eval step runs on fresh copies of the checkpoint on both sides
    seg = Segmentator.from_state_dict(sd, device="cuda")
    cpu_seg = Segmentator.from_state_dict(sd, device="cpu")
    losses = {}
    with tf32_off(torch):
        for side, s_, u8 in (("card", seg, "cuda"), ("cpu", cpu_seg, "cpu")):
            for w in (None, SLICE11_LOSS_WEIGHT):
                step = make_eval_patient_step(s_, 4, w)
                img_v = torch.from_numpy(val.data["img"]).to(u8)
                gt_v = torch.from_numpy(val.data["gt"]).to(u8)
                run = (lambda: step(img_v, gt_v, buckets.indices[p], buckets.mask[p]))
                m = counted("eval", run) if (side, w) == ("card", SLICE11_LOSS_WEIGHT) else run()
                losses[side, w is None] = float(m["loss"])
    rel = abs(losses["card", False] - losses["cpu", False]) / abs(losses["cpu", False])
    print(f"phase 13 (e): eval step with loss_weight {SLICE11_LOSS_WEIGHT} on a padded "
          f"{EVAL_L}-slice bucket: card {losses['card', False]:.7f}, CPU "
          f"{losses['cpu', False]:.7f} ({rel:.2e} relative); unweighted "
          f"{losses['card', True]:.7f}; launches {launches['eval']}", flush=True)
    if not (rel <= 1e-4 and losses["card", False] != losses["card", True]
            and launches["eval"] == dict(zip(FWD_BWD, (2, 2, 0, 0)))):
        raise AssertionError(f"phase 13: the weighted eval loss {losses}, {launches['eval']}")

    # (f) the offline plot and viewer, host tools with no device path
    try:
        import matplotlib
        mpl = matplotlib.__version__
    except ImportError as e:
        mpl = None
        print(f"phase 13 (f): matplotlib does not import on this machine ({e}): the "
              f"learning-curve plot and the viewer (host tools; dct_tpu needs matplotlib "
              f"for them too) did not run", flush=True)
    if mpl is not None:
        from dct_tpu_torch.postprocessing import plot, viewer
        out_dir.mkdir(parents=True, exist_ok=True)
        curves = plot.plot_learning_curves(["build/cli_run"], out=str(out_dir / "curves.png"))
        preds = Path("build/cli_run/iter1000/val")
        viewer.main(["--img_source", "build/acdc_synthetic/val/img", str(preds / "0"),
                     str(preds / "voting"), "-n", "4", "--out", str(out_dir / "viewer.png")])
        files = [Path(curves), out_dir / "viewer.png"]
        if not all(f.is_file() and f.stat().st_size > 0 for f in files):
            raise AssertionError(f"phase 13: the plot or the viewer wrote nothing: {files}")
        print(f"phase 13 (f): matplotlib {mpl} imports; plot_learning_curves on phase 5's "
              f"metrics.csv and the viewer (batch mode) on phase 7's predictions wrote "
              f"{[str(f) for f in files]}", flush=True)
    seconds = time.perf_counter() - t_start
    print(f"phase 13: {seconds:.1f} s ({card})", flush=True)
    emit({"slice11_seconds": seconds, "matplotlib": mpl, "kernel_share": share,
          "launches": launches, "card": card})
    return launches


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--cli-worker":
        sys.exit(cli_worker(sys.argv[2:]))
    sys.exit(main())
