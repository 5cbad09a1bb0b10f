"""The general generator of a cell's inputs, read from its configuration
(image size, channels, classes, data set size, void share, the synthetic
set's label blocks and class mixes, augmentations) and its traffic mix
(batch sizes, iterations a call, adversarial mix).

Everything is drawn from the seed: the uint8 data set and the affine
thetas and VAT noise on the device (``torch.Generator`` on the card), the
batch rows and the FGSM/VAT flags on the host (``numpy``), as the
program's trainers draw rows and flags on the host. Work is fixed per
seed: every seed gets the same batch sizes, and the flags of a pool of
iterations are an equal number of FGSM and VAT choices in another order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class Feed:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device) -> None:
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device).manual_seed((seed + 1) % 2**63)
        self.h, self.w = int(cfg["height"]), int(cfg["width"])
        self.n = int(cfg["dataset_images"])

    def dataset(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 images (N,H,W) or (N,H,W,C) and uint8 labels (N,H,W) that
        look like a segmentation set's: labels constant over square blocks
        of ``synthetic.label_block`` pixels, each image with its own mix of
        classes (softmax of ``synthetic.class_skew`` times a normal draw per
        class), ``void_share`` of the blocks void (250); pixels of a class
        around that class's own intensity (per channel), plus normal noise
        of ``synthetic.pixel_noise``."""
        syn = self.cfg["synthetic"]
        n_cls = int(self.cfg["arch"]["num_classes"])
        c = int(self.cfg["in_channels"])
        blk = int(syn["label_block"])
        gh, gw = -(-self.h // blk), -(-self.w // blk)
        g, dev = self.gen, self.device
        mix = torch.softmax(float(syn["class_skew"]) *
                            torch.randn((self.n, n_cls), generator=g, device=dev), dim=1)
        cells = torch.multinomial(mix, gh * gw, replacement=True, generator=g)
        void = float(self.cfg.get("void_share", 0.0))
        if void > 0:
            hole = torch.rand(cells.shape, generator=g, device=dev) < void
            cells = torch.where(hole, torch.full_like(cells, 250), cells)
        gt = cells.view(self.n, gh, gw).repeat_interleave(blk, 1).repeat_interleave(blk, 2)
        gt = gt[:, :self.h, :self.w].to(torch.uint8)
        means = 255.0 * torch.rand((256, c), generator=g, device=dev)
        img = means[gt.long()] + float(syn["pixel_noise"]) * torch.randn(
            (self.n, self.h, self.w, c), generator=g, device=dev)
        img = img.round().clamp(0, 255).to(torch.uint8)
        return (img[..., 0] if c == 1 else img), gt

    def rows(self, iterations: int, blocks: Sequence[Tuple[int, ...]],
             distinct: bool, across: int = -1) -> List[np.ndarray]:
        """Per block of ``blocks`` (shapes of one iteration's index arrays), a
        (T, *shape) int64 array of data set rows. ``distinct`` (the checked
        steps): no row of the first ``across`` blocks (all by default)
        repeats across all iterations, and the other blocks take rows
        distinct from those and within their iteration; otherwise rows are
        distinct within an iteration."""
        per_it = sum(math.prod(b) for b in blocks)
        across = len(blocks) if across < 0 else across
        first = sum(math.prod(b) for b in blocks[:across])
        if distinct and across < len(blocks):
            if iterations * first + per_it - first > self.n:
                raise ValueError(f"{iterations} x {first} + {per_it - first} distinct rows "
                                 f"from {self.n}")
            order = self.rng.permutation(self.n)
            fixed = order[:iterations * first].reshape(iterations, first)
            rest = order[iterations * first:]
            flat = np.concatenate([fixed, np.stack([
                self.rng.permutation(rest)[:per_it - first] for _ in range(iterations)])], 1)
        elif distinct:
            if iterations * per_it > self.n:
                raise ValueError(f"{iterations} x {per_it} distinct rows from {self.n}")
            flat = self.rng.permutation(self.n)[:iterations * per_it].reshape(iterations, per_it)
        else:
            flat = np.stack([self.rng.permutation(self.n)[:per_it] for _ in range(iterations)])
        out, at = [], 0
        for b in blocks:
            size = math.prod(b)
            out.append(flat[:, at:at + size].reshape((iterations,) + tuple(b)))
            at += size
        return out

    def flags(self, iterations: int, ratio: float, directions: int = 2) -> np.ndarray:
        """(T, directions) bools, True for FGSM: ``ratio`` of them (rounded)
        True, in an order drawn from the seed."""
        n = iterations * directions
        flat = np.zeros(n, bool)
        flat[:int(round(n * ratio))] = True
        return self.rng.permutation(flat).reshape(iterations, directions)

    def noise(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=self.device)

    def uniform(self, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=self.gen, device=self.device)

    def thetas(self, iterations: int, n: int) -> torch.Tensor:
        """(T, n, 2, 3) float32 augmentation thetas: the configuration's
        ``augmentations`` composed in order where it lists them, else the
        medical set (flip, mirror, rotation and crop, each with p 0.5)."""
        th = [self._city(n, self.cfg["augmentations"]) if "augmentations" in self.cfg
              else self._medical(n) for _ in range(iterations)]
        return torch.stack(th)

    def _medical(self, n: int) -> torch.Tensor:
        u = self.uniform
        flip_ud, flip_lr, rot = u(n) < 0.5, u(n) < 0.5, u(n) < 0.5
        angle = torch.where(rot, u(n, -45.0, 45.0), 0.0)
        crop_on = u(n) < 0.5
        crop = torch.where(crop_on, u(n, 0.85, 0.95), 1.0)
        off_y = torch.where(crop_on, (u(n) - 0.5) * (1.0 - crop) * self.h, 0.0)
        off_x = torch.where(crop_on, (u(n) - 0.5) * (1.0 - crop) * self.w, 0.0)
        rad = torch.deg2rad(angle)
        c, s = torch.cos(rad), torch.sin(rad)
        rotm = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
        z = torch.zeros_like(c)
        flips = torch.stack([torch.stack([torch.where(flip_ud, -1.0, 1.0), z], -1),
                             torch.stack([z, torch.where(flip_lr, -1.0, 1.0)], -1)], -2)
        fr = flips @ rotm
        t = fr @ torch.stack([off_y, off_x], -1)[..., None]
        return torch.cat([fr * crop[:, None, None], t], dim=2)

    def _city(self, n: int, augs: Dict[str, object]) -> torch.Tensor:
        th = None
        for key, arg in augs.items():
            step = getattr(self, f"_aug_{key}")(n, arg)
            th = step if th is None else _compose(th, step)
        return th

    def _aug_rotate(self, n: int, degree) -> torch.Tensor:
        ang = torch.deg2rad(self.uniform(n, -float(degree), float(degree)))
        c, s = torch.cos(ang), torch.sin(ang)
        z = torch.zeros_like(c)
        return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1)], -2)

    def _aug_rsizecrop(self, n: int, _size) -> torch.Tensor:
        area, ar = self.uniform(n, 0.45, 1.0), self.uniform(n, 0.5, 2.0)
        ar = torch.where(self.uniform(n) < 0.5, ar, 1.0 / ar)
        zx = torch.clamp(torch.sqrt(area * ar), 0.0, 1.0)
        zy = torch.clamp(torch.sqrt(area / ar), 0.0, 1.0)
        oy = (self.uniform(n) - 0.5) * (1.0 - zy) * self.h
        ox = (self.uniform(n) - 0.5) * (1.0 - zx) * self.w
        z = torch.zeros_like(zy)
        return torch.stack([torch.stack([zy, z, oy], -1), torch.stack([z, zx, ox], -1)], -2)


def _compose(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Theta of (apply ``first``, then ``second``): A1 A2 | A1 t2 + t1."""
    a = first[:, :, :2] @ second[:, :, :2]
    t = (first[:, :, :2] @ second[:, :, 2:])[:, :, 0] + first[:, :, 2]
    return torch.cat([a, t[:, :, None]], dim=2)
