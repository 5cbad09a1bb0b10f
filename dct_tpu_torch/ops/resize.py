"""Bilinear resizes of NCHW tensors (``dct_tpu/ops/resize.py`` and the
``jax.image.resize(..., "bilinear")`` calls of dct_tpu's SegNet and FCN).

``resize_bilinear_align_corners`` maps output coordinate v to input
coordinate v·(in − 1)/(out − 1), torch's ``align_corners=True``; a side of
one point, in or out, reads input point 0 (dct_tpu's ``_interp_matrix``
single-point case, which ``F.interpolate`` shares). dct_tpu writes it as two
interpolation matrices so that it runs on the MXU; here it is one
``F.interpolate``. ``resize_bilinear`` is ``jax.image.resize``'s bilinear:
half-pixel centred (``align_corners=False``), and antialiased whenever a
side shrinks, as ``jax.image.resize`` is (its triangle kernel widened by
the scale, which is ``F.interpolate``'s ``antialias=True``; without it a
shrink is off by the order of the values). It equals ``jax.image.resize``
at every size, edges included; an upsampling of both sides takes the plain
kernel, which equals the antialiased one there.

Both compute in float32 at least and cast back, as dct_tpu's resize does
for bf16 (float64 stays float64); a resize to the input's own size returns
the input.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, hw: Sequence[int], align_corners: bool,
                 antialias: bool = False) -> torch.Tensor:
    size = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[2:]) == size:
        return x
    wdt = torch.promote_types(x.dtype, torch.float32)
    y = F.interpolate(x.to(wdt), size=size, mode="bilinear",
                      align_corners=align_corners, antialias=antialias)
    return y.to(x.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """(B,C,H,W) → (B,C,h,w), align-corners bilinear."""
    return _interpolate(x, hw, True)


def resize_bilinear(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """(B,C,H,W) → (B,C,h,w), half-pixel-centred bilinear, antialiased
    where a side shrinks."""
    shrinks = int(hw[0]) < x.shape[2] or int(hw[1]) < x.shape[3]
    return _interpolate(x, hw, False, antialias=shrinks)
