"""One-hot conversions, predicates and dice, class axis last, and the
host-side helpers of the trainers (``dct_tpu/utils/general.py``).

The simplex and one-hot checks sync with the host, so ``assert_simplex``
(and the ``utils/decorators.py`` guards) act only after
``set_debug(True)``, and never on a value being traced by ``torch.jit`` or
``torch.fx``, where dct_tpu skips its JAX tracers."""
from __future__ import annotations

import random
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence, TypeVar, Union

import numpy as np
import torch
import torch.nn.functional as F

A = TypeVar("A")
B = TypeVar("B")

_DEBUG = False


def set_debug(flag: bool) -> None:
    global _DEBUG
    _DEBUG = bool(flag)


def debug_enabled() -> bool:
    return _DEBUG


def _is_traced(x) -> bool:
    """True while ``torch.jit`` traces or for a ``torch.fx`` proxy: values
    with no data to check."""
    return torch.jit.is_tracing() or isinstance(x, torch.fx.Proxy)


def map_(fn: Callable[[A], B], iter_: Iterable[A]) -> List[B]:
    return list(map(fn, iter_))


def simplex(t: torch.Tensor, axis: int = -1) -> bool:
    """True iff ``t`` sums to one along ``axis`` (within 1e-4)."""
    s = torch.sum(torch.as_tensor(t).float(), dim=axis)
    return bool(torch.allclose(s, torch.ones_like(s), atol=1e-4))


def sset(t, values: Sequence[float]) -> bool:
    """True iff every element of ``t`` is in ``values``."""
    u = torch.unique(torch.as_tensor(t)).tolist()
    return set(u).issubset(set(values))


def one_hot(t: torch.Tensor, axis: int = -1) -> bool:
    return simplex(t, axis) and sset(t, [0, 1])


def assert_simplex(t: torch.Tensor, axis: int = -1, name: str = "tensor") -> None:
    """Asserts ``simplex(t, axis)`` after ``set_debug(True)``; else nothing."""
    if _DEBUG and not _is_traced(t):
        assert simplex(t, axis), f"{name} is not a simplex along axis {axis}"


def class2one_hot(seg: torch.Tensor, C: int, dtype=torch.float32) -> torch.Tensor:
    """(B,H,W) int map → (B,H,W,C) one-hot."""
    return F.one_hot(seg.long(), C).to(dtype)


def probs2one_hot(probs: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) probs → (B,H,W,C) hard one-hot of the argmax (first max on
    ties)."""
    return class2one_hot(torch.argmax(probs, dim=-1), probs.shape[-1], dtype=probs.dtype)


def probs2class(probs: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) probabilities → (B,H,W) argmax class."""
    return torch.argmax(probs, dim=-1)


def pred2class(pred: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) logits or probabilities → (B,H,W) class."""
    return torch.argmax(pred, dim=-1)


def meta_dice(sum_axes: tuple, label: torch.Tensor, pred: torch.Tensor,
              smooth: float = 1e-8) -> torch.Tensor:
    """Dice between one-hot ``label`` and ``pred`` (B,H,W,C), reduced over
    ``sum_axes``: (1, 2) per image and class, (0, 1, 2) per class."""
    inter = torch.sum(label * pred, dim=sum_axes).float()
    sums = (torch.sum(label, dim=sum_axes) + torch.sum(pred, dim=sum_axes)).float()
    return (2.0 * inter + smooth) / (sums + smooth)


def dice_coef(label: torch.Tensor, pred: torch.Tensor, smooth: float = 1e-8) -> torch.Tensor:
    """2D (per-slice) dice between one-hot (B,H,W,C) maps → (B,C)."""
    return meta_dice((1, 2), label, pred, smooth)


def dice_batch(label: torch.Tensor, pred: torch.Tensor, smooth: float = 1e-8) -> torch.Tensor:
    """3D (whole-batch) dice between one-hot (B,H,W,C) maps → (C,)."""
    return meta_dice((0, 1, 2), label, pred, smooth)


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


def colormap(n: int) -> np.ndarray:
    """The Pascal VOC colour map: (n, 3) uint8, class i's colour from the
    bits of i."""
    cmap = np.zeros([n, 3]).astype(np.uint8)
    for i in np.arange(n, dtype=np.int64):
        r, g, b = 0, 0, 0
        for j in np.arange(8):
            r = r + (1 << (7 - j)) * ((i & (1 << (3 * j))) >> (3 * j))
            g = g + (1 << (7 - j)) * ((i & (1 << (3 * j + 1))) >> (3 * j + 1))
            b = b + (1 << (7 - j)) * ((i & (1 << (3 * j + 2))) >> (3 * j + 2))
        cmap[i, :] = np.array([r, g, b])
    return cmap


def colorize(seg, n: int = 22) -> np.ndarray:
    """(H,W) class map (array or tensor) → (H,W,3) uint8 RGB."""
    if isinstance(seg, torch.Tensor):
        seg = seg.cpu().numpy()
    return colormap(n)[np.asarray(seg).astype(np.int64)]


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
