"""Device-resident data path (``dct_tpu/data/pipeline.py``): the uint8
dataset, grayscale (N,H,W) or RGB (N,H,W,3), is uploaded to the device
once, a batch is an index tensor, and the gather, normalisation and
augmentation run on the device. The host draws the batch indices
(``EpochBatcher``, ``InfiniteBatcher``) and pads patients into eval buckets
(``PatientBuckets``) with dct_tpu's exact draws and layout."""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .augment import (augment_batch_with_thetas, augment_u8_with_thetas,
                      sample_aug_thetas, scale_u8, warp_gathered_u8)
from .dataset import MedicalImageDataset


class DeviceDataset:
    """The packed uint8 arrays of a dataset (``data["img"]`` (N,H,W) or
    (N,H,W,3), ``data["gt"]`` (N,H,W)): a MedicalImageDataset or a
    CityscapesDataset, uploaded to ``device`` (one transfer each); indexing
    and normalisation happen on the device."""

    def __init__(self, ds: MedicalImageDataset, device: torch.device) -> None:
        self.img = torch.from_numpy(ds.data["img"]).to(device)
        self.gt = torch.from_numpy(ds.data["gt"]).to(device)
        self.filenames = ds.filenames
        self.n = len(ds)

    def __len__(self) -> int:
        return self.n


def normalize_gather(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                     idx: torch.Tensor, dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather a batch by indices and normalise: uint8 → [0,1] float
    (B,H,W,C) (grayscale (N,H,W) gains a channel axis, RGB (N,H,W,3) keeps
    its own); labels → int64."""
    img = scale_u8(img_u8[idx], dtype)
    gt = gt_u8[idx].long()
    if img.dim() == 3:
        img = img[..., None]
    return img, gt


def gather_augment_u8(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                      idx: torch.Tensor, generator: Optional[torch.Generator],
                      dtype=torch.float32, thetas: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normalize_gather`` + one nearest warp of the gathered batch, by
    ``thetas`` (B,2,3) when given, else by thetas drawn from ``generator``.
    A multi-channel (N,H,W,C) dataset goes through ``normalize_gather`` and
    ``augment_batch_with_thetas`` as in dct_tpu, which warps the first
    channel only and returns it alone: a (B,H,W,1) image."""
    if thetas is None:
        thetas = sample_aug_thetas(generator, idx.shape[0], img_u8.shape[1],
                                   img_u8.shape[2])
    thetas = thetas.to(img_u8.device)
    if img_u8.dim() != 3:
        img, gt = normalize_gather(img_u8, gt_u8, idx, dtype)
        return augment_batch_with_thetas(img, gt, thetas)
    return warp_gathered_u8(img_u8[idx], gt_u8[idx], thetas, dtype)


def warp_gather_normalize(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                          idx: torch.Tensor, thetas: torch.Tensor,
                          dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normalize_gather`` and a nearest affine warp by ``thetas`` (B,2,3)
    of a grayscale uint8 dataset (N,H,W): the gathered uint8 pair is warped
    by ``augment_u8_with_thetas`` and normalised after it (the division by
    255 is per pixel, so it commutes with the warp exactly). Out-of-bounds
    pixels are 0 in image and labels. Returns ((B,H,W,1) image, (B,H,W)
    int64 labels), equal to the bit to ``normalize_gather`` then
    ``augment_batch_with_thetas``."""
    assert img_u8.dim() == 3, "fused warp-gather supports grayscale (N,H,W)"
    n, h, w = img_u8.shape
    assert n * h * w < 2 ** 31, "flat index would overflow int32"
    idx = torch.as_tensor(idx, device=img_u8.device).long()
    return augment_u8_with_thetas(img_u8[idx], gt_u8[idx],
                                  thetas.to(img_u8.device), dtype)


class EpochBatcher:
    """Batch indices for one pass: shuffled (a ``rs.permutation``) or in
    order, and drop-last, or padded with the pass's first indices up to a
    whole batch (so those items count twice, as in dct_tpu)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True) -> None:
        assert n >= batch_size, (n, batch_size)
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last

    def epoch(self, rs: np.random.RandomState) -> np.ndarray:
        order = rs.permutation(self.n) if self.shuffle else np.arange(self.n)
        n_batches = (self.n // self.batch_size if self.drop_last
                     else -(-self.n // self.batch_size))
        if not self.drop_last and self.n % self.batch_size:
            order = np.concatenate([order, order[:n_batches * self.batch_size - self.n]])
        return order[:n_batches * self.batch_size].reshape(n_batches, self.batch_size)


class InfiniteBatcher:
    """Endless batch stream: ``take(k)`` → (k, B) indices, spanning passes
    as needed, reshuffled each pass unless ``shuffle`` is False. The first
    pass is drawn from ``rs`` at construction."""

    def __init__(self, n: int, batch_size: int, rs: np.random.RandomState,
                 shuffle: bool = True) -> None:
        self.inner = EpochBatcher(n, batch_size, shuffle, drop_last=True)
        self.rs = rs
        self._buf = self.inner.epoch(self.rs)
        self._pos = 0

    def take(self, k: int) -> np.ndarray:
        out = []
        need = k
        while need > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                self._buf = self.inner.epoch(self.rs)
                self._pos = 0
                continue
            grab = min(avail, need)
            out.append(self._buf[self._pos:self._pos + grab])
            self._pos += grab
            need -= grab
        return np.concatenate(out, axis=0)


class PatientBuckets:
    """Patient-grouped, padded eval batches: each patient's slices, padded
    to the longest patient's count rounded up to a multiple of
    ``round_to``, with a validity mask. Padding repeats index 0 and is
    masked out of every dice and loss."""

    def __init__(self, ds: MedicalImageDataset, grp_regex: str,
                 round_to: int = 8) -> None:
        pattern = re.compile(grp_regex)
        groups: Dict[str, List[int]] = {}
        for i, stem in enumerate(ds.filenames):
            m = pattern.match(stem)
            assert m, f"{stem!r} !~ {grp_regex!r}"
            groups.setdefault(m.group(1), []).append(i)
        self.patients = sorted(groups)
        max_len = max(len(v) for v in groups.values())
        self.bucket_len = -(-max_len // round_to) * round_to
        P = len(self.patients)
        self.indices = np.zeros((P, self.bucket_len), np.int32)
        self.mask = np.zeros((P, self.bucket_len), bool)
        for p, name in enumerate(self.patients):
            idxs = groups[name]
            self.indices[p, :len(idxs)] = idxs
            self.mask[p, :len(idxs)] = True

    def __len__(self) -> int:
        return len(self.patients)
