"""Device-resident data path (``dct_tpu/data/pipeline.py``): the uint8
(N,H,W) dataset stays on the device, a batch is an index tensor, and the
gather, normalisation and augmentation run on the device."""
from __future__ import annotations

from typing import Tuple

import torch

from .augment import sample_aug_thetas, warp_gathered_u8


def normalize_gather(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                     idx: torch.Tensor, dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather a batch by indices and normalise: uint8 → [0,1] float
    (B,H,W,C) (grayscale (N,H,W) gains a channel axis); labels → int64."""
    img = img_u8[idx].to(dtype) / 255.0
    gt = gt_u8[idx].long()
    if img.dim() == 3:
        img = img[..., None]
    return img, gt


def gather_augment_u8(img_u8: torch.Tensor, gt_u8: torch.Tensor,
                      idx: torch.Tensor, generator: torch.Generator,
                      dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normalize_gather`` + one nearest warp of the gathered grayscale
    batch, with thetas drawn from ``generator``."""
    if img_u8.dim() != 3:
        raise NotImplementedError("augmenting multi-channel datasets is "
                                  "not ported yet (a later slice)")
    h, w = img_u8.shape[1], img_u8.shape[2]
    thetas = sample_aug_thetas(generator, idx.shape[0], h, w).to(img_u8.device)
    return warp_gathered_u8(img_u8[idx], gt_u8[idx], thetas, dtype)
