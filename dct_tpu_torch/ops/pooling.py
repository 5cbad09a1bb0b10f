"""2x2 max-pooling with an argmax mask, and unpooling through it, NHWC —
the plain PyTorch versions of ``dct_tpu/ops/pooling.py``.

The 2x2/stride-2 windows are disjoint, so the pool returns a full-resolution
one-hot {0,1} mask (in x's dtype) marking the *first* position, in row-major
window order, that attains the max; the unpool broadcasts each pooled value
over its window and multiplies by that mask (``nn.MaxUnpool2d`` at the
recorded argmax).

The pool is written as ``maximum(maximum(a, b), maximum(c, d))`` over the
four window corners, exactly as ``dct_tpu`` writes it, so autograd splits a
tie's gradient the way JAX differentiates that tree (``[1,1,1,0]`` gives
``[.25,.25,.5,0]``). ``torch.maximum`` propagates NaN: a window holding a NaN
pools to NaN and sets its mask at position (1,1).

These are the CPU path of ``ops/pool_kernels.py`` and the oracle that
``chip_smoke.py`` holds the CUDA kernels against.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _split_windows(x: torch.Tensor):
    """(B,H,W,C) → the four 2x2-window corners, each (B,H/2,W/2,C)."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return y[:, :, 0, :, 0], y[:, :, 0, :, 1], y[:, :, 1, :, 0], y[:, :, 1, :, 1]


def _interleave(m00, m01, m10, m11) -> torch.Tensor:
    """Inverse of _split_windows: four (B,h,w,C) corners → (B,2h,2w,C)."""
    b, h, w, c = m00.shape
    top = torch.stack([m00, m01], dim=3)            # (B,h,w,2,C)
    bot = torch.stack([m10, m11], dim=3)
    return torch.stack([top, bot], dim=2).reshape(b, 2 * h, 2 * w, c)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Plain 2x2/stride-2 max pool, NHWC (H, W must be even)."""
    a, b, c, d = _split_windows(x)
    return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))


def max_pool_2x2_with_mask(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2/stride-2 max pool returning (pooled, full-res argmax mask)."""
    a, b, c, d = _split_windows(x)
    pooled = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    m00 = a == pooled
    m01 = (b == pooled) & ~m00
    m10 = (c == pooled) & ~m00 & ~m01
    m11 = ~m00 & ~m01 & ~m10
    mask = _interleave(m00, m01, m10, m11).to(x.dtype)
    return pooled, mask


def mask_unpool_2x2(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Place each value of ``y`` (B,h,w,C) at its argmax position recorded in
    ``mask`` (B,2h,2w,C); zeros elsewhere. A multiply, not a select, so a NaN
    in ``y`` stays NaN at the masked-out positions too."""
    b, h, w, c = y.shape
    up = y[:, :, None, :, None, :].expand(b, h, 2, w, 2, c) \
        .reshape(b, 2 * h, 2 * w, c)
    return up * mask
