"""One-hot conversions and dice, class axis last (``dct_tpu/utils/general.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def class2one_hot(seg: torch.Tensor, C: int, dtype=torch.float32) -> torch.Tensor:
    """(B,H,W) int map → (B,H,W,C) one-hot."""
    return F.one_hot(seg.long(), C).to(dtype)


def probs2one_hot(probs: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) probs → (B,H,W,C) hard one-hot of the argmax (first max on
    ties)."""
    return class2one_hot(torch.argmax(probs, dim=-1), probs.shape[-1], dtype=probs.dtype)


def dice_coef(label: torch.Tensor, pred: torch.Tensor, smooth: float = 1e-8) -> torch.Tensor:
    """2D (per-slice) dice between one-hot (B,H,W,C) maps → (B,C)."""
    inter = torch.sum(label * pred, dim=(1, 2)).float()
    sums = (torch.sum(label, dim=(1, 2)) + torch.sum(pred, dim=(1, 2))).float()
    return (2.0 * inter + smooth) / (sums + smooth)
