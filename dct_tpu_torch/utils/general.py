"""One-hot conversions and dice, class axis last, and the host-side
helpers of the trainers (``dct_tpu/utils/general.py``)."""
from __future__ import annotations

import random
from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np
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


def dice_batch(label: torch.Tensor, pred: torch.Tensor, smooth: float = 1e-8) -> torch.Tensor:
    """3D (whole-batch) dice between one-hot (B,H,W,C) maps → (C,)."""
    inter = torch.sum(label * pred, dim=(0, 1, 2)).float()
    sums = (torch.sum(label, dim=(0, 1, 2)) + torch.sum(pred, dim=(0, 1, 2))).float()
    return (2.0 * inter + smooth) / (sums + smooth)


def fix_all_seed(seed: int) -> torch.Generator:
    """Seed ``random``, ``np.random`` and torch, and return a CPU
    ``torch.Generator`` seeded with ``seed`` (dct_tpu returns a root JAX
    key). The host RNGs drive the split math."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def fold_in(seed: int, data: int) -> int:
    """A seed for stream ``data`` of the run seeded with ``seed`` (the role
    of ``jax.random.fold_in`` on a root key): a torch generator seeded with
    ``fold_in(seed, e)`` draws the same numbers in any run that reaches e."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0])


def save_images(segs, names: Iterable[str], root: Union[str, Path], mode: str,
                iter: int, seg_num: Optional[str] = None) -> None:
    """Dump (B,H,W) class maps as 8-bit grayscale PNGs:
    ``root/iter###/mode[/seg_num]/name.png``."""
    from PIL import Image

    if isinstance(segs, torch.Tensor):
        segs = segs.cpu().numpy()
    segs = np.asarray(segs).astype(np.uint8)
    assert segs.ndim == 3, segs.shape
    for seg, name in zip(segs, names):
        if seg_num is None:
            save_path = Path(root, f"iter{iter:03d}", mode, name).with_suffix(".png")
        else:
            save_path = Path(root, f"iter{iter:03d}", mode, seg_num, name).with_suffix(".png")
        save_path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(seg).save(str(save_path))


def check_finite_losses(losses: dict, epoch: int, policy: str = "warn") -> bool:
    """Per-epoch training-loss health guard on metrics already on the host.

    ``policy``: "warn" (default) prints a loud line and keeps going,
    "abort" raises FloatingPointError, "ignore" disables. Returns True when
    every entry is finite."""
    bad = sorted(k for k, v in losses.items()
                 if not np.all(np.isfinite(np.asarray(v))))
    if not bad:
        return True
    msg = f"!! non-finite training losses at epoch {epoch}: {bad}"
    if policy == "abort":
        raise FloatingPointError(msg)
    if policy != "ignore":
        print(msg, flush=True)
    return False
