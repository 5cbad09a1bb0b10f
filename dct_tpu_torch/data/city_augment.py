"""The Cityscapes augmentations: the reference's ``key2aug`` registry and
``get_composed_augmentations`` (``dct_tpu/data/city_augment.py``).

A config's ``Dataset.augmentations`` (for example ``{rotate: 10, rcrop:
[h, w]}``) names samplers; each draws one affine theta per sample, the
chain composes into one (2,3) theta per sample, and one shear warp
(``ops/warp.py:affine_warp_shear``) moves image, labels and a validity
channel together. Crops keep the canvas size: the window is zoomed to fill
it. Labels warped from outside the canvas become ``ignore_index``.

theta maps centred output coordinates to centred input ones,
``src = theta[:, :2] @ dst + theta[:, 2]``; applying ``first`` then
``second`` composes to ``A1 @ A2 | A1 t2 + t1``. The draws come from an
explicit ``torch.Generator``: they follow dct_tpu's distributions, not its
bits, so tests inject thetas to compare the warps.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.warp import affine_warp_shear_batch


def _uniform(generator, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    dev = generator.device if generator is not None else None
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)


def _identity(n: int, device=None) -> torch.Tensor:
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device).repeat(n, 1, 1)


def _diag_theta(zy, zx, ty, tx) -> torch.Tensor:
    """(n,) scales and shifts → (n,2,3) thetas."""
    z = torch.zeros_like(zy)
    return torch.stack([torch.stack([zy, z, ty], -1),
                        torch.stack([z, zx, tx], -1)], -2)


def compose_thetas(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Theta of (apply ``first``, then ``second``): A1@A2 | A1 t2 + t1."""
    a = first[:, :, :2] @ second[:, :, :2]
    t = (first[:, :, :2] @ second[:, :, 2:])[:, :, 0] + first[:, :, 2]
    return torch.cat([a, t[:, :, None]], dim=2)


def _pair(size) -> Tuple[int, int]:
    if isinstance(size, (int, float)):
        return int(size), int(size)
    return int(size[0]), int(size[1])


# samplers: (generator, n, h, w) → (n,2,3) float32 thetas on the generator's device

def random_crop(size):
    """A (th, tw) window at a uniform position, zoomed to fill the canvas."""
    th, tw = _pair(size)

    def sample(gen, n, h, w):
        zy, zx = min(th, h) / h, min(tw, w) / w
        oy = (_uniform(gen, n) - 0.5) * (h - min(th, h))
        ox = (_uniform(gen, n) - 0.5) * (w - min(tw, w))
        return _diag_theta(torch.full_like(oy, zy), torch.full_like(ox, zx), oy, ox)

    return sample


def center_crop(size):
    """The centred (th, tw) window, zoomed to fill the canvas."""
    th, tw = _pair(size)

    def sample(gen, n, h, w):
        zero = torch.zeros(n, device=gen.device if gen is not None else None)
        return _diag_theta(torch.full_like(zero, min(th, h) / h),
                           torch.full_like(zero, min(tw, w) / w), zero, zero)

    return sample


def scale(size):
    """Aspect-preserving resize to the target: the canvas is already the
    target size, so the identity."""
    del size

    def sample(gen, n, h, w):
        return _identity(n, gen.device if gen is not None else None)

    return sample


def random_rotate(degree):
    """A rotation by U(−degree, degree) degrees."""
    degree = float(degree)

    def sample(gen, n, h, w):
        ang = torch.deg2rad(_uniform(gen, n, -degree, degree))
        c, s = torch.cos(ang), torch.sin(ang)
        zero = torch.zeros_like(c)
        return torch.stack([torch.stack([c, -s, zero], -1),
                            torch.stack([s, c, zero], -1)], -2)

    return sample


def random_sized(size):
    """Resize by U(0.5, 2), back to the canvas, random crop: a zoom-in of
    1/u (capped at 1) at a uniform position."""
    del size

    def sample(gen, n, h, w):
        z = torch.clamp(1.0 / _uniform(gen, n, 0.5, 2.0), 0.0, 1.0)
        oy = (_uniform(gen, n) - 0.5) * (1.0 - z) * h
        ox = (_uniform(gen, n) - 0.5) * (1.0 - z) * w
        return _diag_theta(z, z, oy, ox)

    return sample


def random_sized_crop(size):
    """A window of area U(0.45, 1) of the canvas and aspect U(0.5, 2) (or
    its inverse, with p = 0.5) at a uniform position, zoomed to fill it."""
    del size

    def sample(gen, n, h, w):
        area = _uniform(gen, n, 0.45, 1.0)
        ar = _uniform(gen, n, 0.5, 2.0)
        ar = torch.where(_uniform(gen, n) < 0.5, ar, 1.0 / ar)
        zx = torch.clamp(torch.sqrt(area * ar), 0.0, 1.0)
        zy = torch.clamp(torch.sqrt(area / ar), 0.0, 1.0)
        oy = (_uniform(gen, n) - 0.5) * (1.0 - zy) * h
        ox = (_uniform(gen, n) - 0.5) * (1.0 - zx) * w
        return _diag_theta(zy, zx, oy, ox)

    return sample


# the reference's registry, its 'sale' alias of 'scale' included
key2aug: Dict[str, Callable] = {
    "rcrop": random_crop,
    "scale": scale,
    "rsize": random_sized,
    "rsizecrop": random_sized_crop,
    "rotate": random_rotate,
    "ccrop": center_crop,
    "sale": scale,
}


class ComposedAugment:
    """The augmenter of a config's ``augmentations``: ``aug(img (B,H,W,C)
    float, gt (B,H,W) int, generator, thetas=None)`` → (img, gt), warped by
    ``thetas`` (B,2,3) when given, else by thetas drawn from ``generator``
    (:meth:`sample`)."""

    def __init__(self, samplers: List[Callable], ignore_index: int = 250) -> None:
        self.samplers = samplers
        self.ignore_index = ignore_index

    def sample(self, generator: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
        """(n,2,3) thetas: each sampler's draw, composed in config order."""
        thetas = self.samplers[0](generator, n, h, w)
        for smp in self.samplers[1:]:
            thetas = compose_thetas(thetas, smp(generator, n, h, w))
        return thetas

    def warp(self, img: torch.Tensor, gt: torch.Tensor, thetas: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One shear warp of image, labels and a validity channel; labels
        from outside the canvas become ``ignore_index``."""
        b, h, w = img.shape[:3]
        stacked = torch.cat([img, gt[..., None].to(img.dtype),
                             torch.ones((b, h, w, 1), dtype=img.dtype, device=img.device)],
                            dim=-1)
        out = affine_warp_shear_batch(stacked, thetas.to(img.device))
        valid = out[..., -1] > 0.5
        gt_a = torch.where(valid, out[..., -2].to(gt.dtype),
                           torch.full((), self.ignore_index, dtype=gt.dtype, device=gt.device))
        return out[..., :-2], gt_a

    def __call__(self, img: torch.Tensor, gt: torch.Tensor,
                 generator: Optional[torch.Generator],
                 thetas: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if thetas is None:
            thetas = self.sample(generator, img.shape[0], img.shape[1], img.shape[2])
        return self.warp(img, gt, thetas)


def get_composed_augmentations(aug_dict: Optional[dict],
                               ignore_index: int = 250) -> Optional[ComposedAugment]:
    """Config dict → the augmenter, or None for no (or an empty) dict."""
    if not aug_dict:
        return None
    samplers = []
    for aug_key, aug_param in aug_dict.items():
        samplers.append(key2aug[aug_key](aug_param))
        print(f"Using {aug_key} aug with params {aug_param}")
    return ComposedAugment(samplers, ignore_index)
