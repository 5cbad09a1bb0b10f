"""Overlap-tile inference over the mesh's ``data`` ranks
(``dct_tpu/parallel/spatial.py``).

The WIDTH axis is split over the ranks: each rank runs the whole network
on its tile plus ``halo`` columns of context on each side, its window
clamped inside the image so that the edge tiles see the true border, and
keeps its tile's centre; an all-gather over the data group concatenates
the centres. The tiled output equals the full-image output wherever
``halo`` covers the network's half receptive field (a fully
convolutional, translation-invariant net; for a net that downsamples by
s, halo and tile widths should be multiples of s).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import comm


def make_spatial_eval(apply_fn: Callable, mesh, halo: int) -> Callable:
    """``step(img (B,H,W,C)) -> logits (B,H,W,K)`` tiling W over the data
    ranks of ``mesh``; ``apply_fn(img)`` must be fully convolutional and
    keep the spatial size. Every rank passes the whole image and gets the
    whole output."""
    n, i = mesh.shape["data"], mesh.data_index

    @torch.inference_mode()
    def step(img: torch.Tensor) -> torch.Tensor:
        w = img.shape[2]
        assert w % n == 0, (
            f"spatial eval: W={w} not divisible by data axis size {n}")
        wt = w // n
        assert w >= wt + 2 * halo, (
            f"spatial eval: W={w} too small for tile {wt} + 2*halo {halo}")
        wwin = wt + 2 * halo
        start = min(max(i * wt - halo, 0), w - wwin)
        logits = apply_fn(img[:, :, start:start + wwin])
        off = i * wt - start
        centre = logits[:, :, off:off + wt].contiguous()
        return comm.gather_rows(centre, mesh.data_group, dim=2)

    return step
