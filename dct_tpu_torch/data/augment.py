"""On-device batched augmentation (``dct_tpu/data/augment.py``).

Per sample, independently with p=0.5 each: vertical flip, horizontal mirror,
rotation U(−45°, 45°), and a crop of scale U(0.85, 0.95) at a uniform
position. All four compose into one affine matrix per sample, executed as
one gather per image (``ops/warp.py``). The draws come from an explicit
``torch.Generator``, so they follow dct_tpu's distribution, not its bits;
tests inject dct_tpu's thetas to compare the warps.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.warp import affine_warp, affine_warp_shear_batch


def scale_u8(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 → ``dtype`` in [0, 1]: divided by 255, on every device. On the
    card PyTorch turns a division by a Python scalar into a multiply by its
    reciprocal, one ulp off the quotient for 126 of the 256 values (as
    jitted dct_tpu does); a 0-d tensor divisor keeps the division, so the
    card's images equal the CPU's (and un-jitted dct_tpu's) to the bit."""
    x = x.to(dtype)
    return x / torch.full((), 255.0, dtype=dtype, device=x.device)


def sample_aug_thetas(generator: torch.Generator, n: int, height: int,
                      width: int) -> torch.Tensor:
    """Per-sample (n,2,3) affine matrices on the generator's device."""
    dev = generator.device

    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)

    flip_ud = uniform() < 0.5
    flip_lr = uniform() < 0.5
    do_rot = uniform() < 0.5
    angle = torch.where(do_rot, uniform(-45.0, 45.0), 0.0)
    do_crop = uniform() < 0.5
    crop = torch.where(do_crop, uniform(0.85, 0.95), 1.0)
    off_y = torch.where(do_crop, (uniform() - 0.5) * (1.0 - crop) * height, 0.0)
    off_x = torch.where(do_crop, (uniform() - 0.5) * (1.0 - crop) * width, 0.0)

    rad = torch.deg2rad(angle)
    c, s = torch.cos(rad), torch.sin(rad)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    zero = torch.zeros_like(c)
    flips = torch.stack([
        torch.stack([torch.where(flip_ud, -1.0, 1.0), zero], -1),
        torch.stack([zero, torch.where(flip_lr, -1.0, 1.0)], -1)], -2)
    # composition: output→input = Flip ∘ Rotate ∘ CropZoom
    fr = flips @ rot
    lin = fr * crop[:, None, None]
    t = fr @ torch.stack([off_y, off_x], -1)[..., None]
    return torch.cat([lin, t], dim=2)


def augment_batch(img: torch.Tensor, gt: torch.Tensor,
                  generator: torch.Generator, fast: bool = True,
                  impl: str = "gather") -> Tuple[torch.Tensor, torch.Tensor]:
    """Jointly augment (B,H,W[,C]) float images and (B,H,W) int labels by
    per-sample thetas drawn from ``generator`` (``sample_aug_thetas``)
    and moved to the images' device. ``fast`` and ``impl`` as in
    :func:`augment_batch_with_thetas`."""
    b, h, w = img.shape[:3]
    thetas = sample_aug_thetas(generator, b, h, w).to(img.device)
    return augment_batch_with_thetas(img, gt, thetas, fast=fast, impl=impl)


def augment_u8_with_thetas(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                           thetas: torch.Tensor, dtype=torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-warp a gathered uint8 batch (img (B,H,W), gt (B,H,W)) jointly,
    then normalise → ((B,H,W,1) ``dtype`` image in [0,1], (B,H,W) int64
    labels; dct_tpu's are int32). A nearest warp only selects pixels (or
    fills 0), so it commutes with the per-pixel division by 255: equal to
    ``warp_gathered_u8`` to the bit."""
    stacked = torch.stack([img_u8, gt_u8], dim=-1)              # (B,H,W,2) u8
    out = affine_warp(stacked, thetas, "nearest", 0)
    return scale_u8(out[..., 0], dtype)[..., None], out[..., 1].long()


def augment_batch_with_thetas(img: torch.Tensor, gt: torch.Tensor,
                              thetas: torch.Tensor, fast: bool = True,
                              impl: str = "gather"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jointly warp (B,H,W[,1]) float images and (B,H,W) int labels by the
    given (B,2,3) thetas. ``fast`` warps both nearest in one pass, by the
    exact per-pixel gather (``impl="gather"``) or by the L·D·U shear warp
    (``"shear"``, ``ops/warp.py:affine_warp_shear_batch``); otherwise the
    image is warped bilinearly and the labels nearest."""
    squeeze_c = img.dim() == 4
    im = img[..., 0] if squeeze_c else img
    if fast:
        stacked = torch.stack([im, gt.to(im.dtype)], dim=-1)      # (B,H,W,2)
        if impl == "shear":
            out = affine_warp_shear_batch(stacked, thetas)
        else:
            out = affine_warp(stacked, thetas, "nearest", 0.0)
        im_a, gt_a = out[..., 0], out[..., 1].to(gt.dtype)
    else:
        im_a = affine_warp(im, thetas, "bilinear", 0.0)
        gt_a = affine_warp(gt.float(), thetas, "nearest", 0.0).to(gt.dtype)
    if squeeze_c:
        im_a = im_a[..., None]
    return im_a, gt_a


def apply_thetas(x: torch.Tensor, thetas: torch.Tensor,
                 method: str = "bilinear") -> torch.Tensor:
    """Warp (B,H,W) or (B,H,W,C) by given per-sample (B,2,3) thetas, zero
    outside: Mean-Teacher warps the student's view and replays the same
    warp on the teacher's probabilities with it."""
    return affine_warp(x, thetas, method, 0.0)


def warp_gathered_u8(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                     thetas: torch.Tensor, dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise a gathered uint8 (B,H,W) img+gt pair to float first, then
    nearest-warp the pair → ((B,H,W,1) image in [0,1], (B,H,W) int64 labels)."""
    img = scale_u8(img_u8, dtype)[..., None]
    return augment_batch_with_thetas(img, gt_u8.long(), thetas)
