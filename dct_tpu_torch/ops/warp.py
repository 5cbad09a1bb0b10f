"""Batched affine warps — the on-device augmentation primitive
(``dct_tpu/ops/warp.py:affine_warp``, nearest and bilinear).

``theta`` is a (2,3) matrix per sample mapping *centered output* pixel
coords (y, x) to *centered input* coords: ``src = theta[:, :2] @ dst +
theta[:, 2]``. Out-of-bounds samples take ``fill``. The source coordinates
are computed in float32 in the same order as dct_tpu's, and rounded half to
even, so a nearest warp picks the same pixels.
"""
from __future__ import annotations

import torch


def _grid(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=device) - (w - 1) / 2.0
    return yy[:, None].expand(h, w), xx[None, :].expand(h, w)


def affine_warp(img: torch.Tensor, theta: torch.Tensor,
                method: str = "bilinear", fill: float = 0.0) -> torch.Tensor:
    """Warp a batch (B,H,W) or (B,H,W,C) by per-sample thetas (B,2,3) with one
    gather per sample point (four for bilinear) — dct_tpu's per-image
    ``affine_warp`` vmapped over the batch."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    b, h, w, _ = img.shape
    yy, xx = _grid(h, w, img.device)
    # coordinates in float32, as dct_tpu computes them (float64 thetas, as
    # JAX draws them in 64-bit mode, promote them to float64 in both)
    t = theta.to(torch.promote_types(theta.dtype, torch.float32))[:, :, :, None, None]
    sy = t[:, 0, 0] * yy + t[:, 0, 1] * xx + t[:, 0, 2] + (h - 1) / 2.0
    sx = t[:, 1, 0] * yy + t[:, 1, 1] * xx + t[:, 1, 2] + (w - 1) / 2.0
    batch = torch.arange(b, device=img.device)[:, None, None]
    fill_v = torch.tensor(fill, dtype=img.dtype, device=img.device)

    def gather(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        vals = img[batch, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, fill_v)

    if method == "nearest":
        out = gather(torch.round(sy).long(), torch.round(sx).long())
    elif method == "bilinear":
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        wy = (sy - y0)[..., None]
        wx = (sx - x0)[..., None]
        y0i, x0i = y0.long(), x0.long()
        v00 = gather(y0i, x0i)
        v01 = gather(y0i, x0i + 1)
        v10 = gather(y0i + 1, x0i)
        v11 = gather(y0i + 1, x0i + 1)
        out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
               + v10 * wy * (1 - wx) + v11 * wy * wx)
    else:
        raise ValueError(f"unknown method {method!r}")
    return out[..., 0] if squeeze else out

