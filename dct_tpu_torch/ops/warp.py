"""Batched affine warps — the on-device augmentation primitive
(``dct_tpu/ops/warp.py:affine_warp``, nearest and bilinear, and
``affine_warp_shear``, the nearest-rounded L·D·U shear warp of the
Cityscapes augmentations), and ``make_affine``, which composes one theta.

dct_tpu warps one image by one theta and vmaps that over a batch
(``affine_warp_batch``); here ``affine_warp`` takes the batch, (B,H,W[,C])
images with (B,2,3) thetas, and is that batched function.

``theta`` is a (2,3) matrix per sample mapping *centered output* pixel
coords (y, x) to *centered input* coords: ``src = theta[:, :2] @ dst +
theta[:, 2]``. Out-of-bounds samples take ``fill``. The source coordinates
are computed in float32 in the same order as dct_tpu's, and rounded half to
even, so a nearest warp picks the same pixels.
"""
from __future__ import annotations

import torch


def make_affine(angle_deg=0.0, zoom_y=1.0, zoom_x=1.0, shift_y=0.0,
                shift_x=0.0, flip_ud=False, flip_lr=False, device=None
                ) -> torch.Tensor:
    """Compose flip/rotate/zoom/shift into one (2,3) float32 output→input
    matrix, in float32 as dct_tpu composes it. The arguments are Python
    scalars or 0-d tensors; ``flip_*`` are booleans (signs ±1). ``zoom > 1``
    zooms in (a crop); ``shift`` is in input pixels, added after the linear
    part. The matrix lies on ``device`` (``resolve_device``: the card
    unless the caller asks for the CPU)."""
    from .. import resolve_device
    dev = resolve_device(device)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    angle = torch.deg2rad(f32(angle_deg))
    cos, sin = torch.cos(angle), torch.sin(angle)
    one = f32(1.0)
    sy = torch.where(torch.as_tensor(flip_ud, device=dev), -one, one) / f32(zoom_y)
    sx = torch.where(torch.as_tensor(flip_lr, device=dev), -one, one) / f32(zoom_x)
    # rotation in (y, x) convention, then the per-axis scale and flip
    rot = torch.stack([torch.stack([cos, -sin]), torch.stack([sin, cos])])
    scale = torch.stack([torch.stack([sy, 0.0 * sy]), torch.stack([0.0 * sx, sx])])
    t = torch.stack([f32(shift_y), f32(shift_x)])
    return torch.cat([rot @ scale, t[:, None]], dim=1)


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



def _ldu(theta: torch.Tensor):
    """Per-sample (B,2,3) thetas → (l, d0, d1, u, t0, t1), each (B,), with
    M = [[1,0],[l,1]] @ diag(d0,d1) @ [[1,u],[0,1]]. The decomposition holds
    for |m01/m00| ≤ 1 and |m10/m00| ≤ 1."""
    m00, m01, t0 = theta[:, 0, 0], theta[:, 0, 1], theta[:, 0, 2]
    m10, m11, t1 = theta[:, 1, 0], theta[:, 1, 1], theta[:, 1, 2]
    return m10 / m00, m00, m11 - m10 * m01 / m00, m01 / m00, t0, t1


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def _scale_src(n_out: int, n_in: int, scale: torch.Tensor):
    """Nearest resampling between centred axes, per sample: (source index,
    valid) of each output index v, source round(scale·(v − c_out) + c_in).
    dct_tpu applies it as a one-hot matmul; a gather selects the same
    element."""
    src = torch.round(scale[:, None] * (_iota(n_out, scale.device) - (n_out - 1) / 2.0)
                      + (n_in - 1) / 2.0).long()
    return src, (src >= 0) & (src < n_in)


def affine_warp_shear_batch(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Nearest affine warp of a batch (B,H,W,C) by per-sample (B,2,3) thetas
    through dct_tpu's three nearest-rounded stages, each rounded as dct_tpu
    rounds it in float32 (half to even):

    * L, (H,W) → (2H, 3W/2): row v takes the padded image's row
      round(v_c + t0 + cy) from column round(l·v_c + t1 + cx − c1x) on;
    * D: rows rescaled by d0, then columns by d1 → (2H, W), outside → 0;
    * U, (2H, W) → (H, W): column x takes rows round(u·x_c + c1y − cy) on.

    The composite may move a pixel by up to ~1.5 px against an exact warp
    (:func:`affine_warp`), by design. The stages only select elements, so
    they compose here into one gather per output pixel. Valid for
    |m01/m00| ≤ 1, |m10/m00| ≤ 1 and |translation| ≤ H/2; outside → 0."""
    b, h, w, c = img.shape
    dev = img.device
    l, d0, d1, u, t0, t1 = _ldu(theta.to(torch.promote_types(theta.dtype, torch.float32)))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    h1, w1 = 2 * h, (3 * w) // 2
    c1y, c1x = (h1 - 1) / 2.0, (w1 - 1) / 2.0

    # L: padded row y_idx[v] (pad h above), columns x0[v] … x0[v] + w1 − 1
    v_c = _iota(h1, dev) - c1y
    y_idx = (torch.round(v_c + t0[:, None] + cy).long() + h).clamp(0, 3 * h - 1)
    x0 = (torch.round(l[:, None] * v_c + t1[:, None] + cx - c1x).long() + w).clamp(
        0, 3 * w - w1)
    # D: stage rows and columns
    sy, vy = _scale_src(h1, h1, d0)                     # (B, 2H)
    sx, vx = _scale_src(w, w1, d1)                      # (B, W)
    # U: output (y, x) reads D's row y0[x] + y
    y0 = torch.round(u[:, None] * (_iota(w, dev) - cx) + (c1y - cy)).long().clamp(0, h1 - h)
    rows = y0[:, None, :] + torch.arange(h, device=dev)[None, :, None]    # (B,H,W)
    bi = torch.arange(b, device=dev)[:, None, None]
    r = sy.clamp(0, h1 - 1)[bi, rows]                    # D row → L row
    ok = vy[bi, rows] & vx[:, None, :]
    cols = x0[bi, r] + sx.clamp(0, w1 - 1)[:, None, :]   # padded column
    py, px = y_idx[bi, r] - h, cols - w                  # image coordinates
    ok = ok & (py >= 0) & (py < h) & (px >= 0) & (px < w)
    vals = img[bi, py.clamp(0, h - 1), px.clamp(0, w - 1)]
    return torch.where(ok[..., None], vals, torch.zeros((), dtype=img.dtype, device=dev))


def affine_warp_shear(img: torch.Tensor, theta: torch.Tensor,
                      fill: float = 0.0) -> torch.Tensor:
    """One (H,W,C) image by one (2,3) theta: :func:`affine_warp_shear_batch`
    of a batch of one. The shear warp fills with 0 only."""
    assert fill == 0.0, "the shear warp fills with 0 only"
    return affine_warp_shear_batch(img[None], theta[None])[0]
