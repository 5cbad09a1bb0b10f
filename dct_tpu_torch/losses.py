"""Segmentation losses, class axis last (B,H,W,C) (``dct_tpu/losses.py``).

The probability-space functions take probs, ``cross_entropy2d`` takes raw
logits.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

EPS_KL = 1e-10
EPS_ENT = 1e-16


def cross_entropy2d(logits: torch.Tensor, target: torch.Tensor,
                    weight: Optional[Sequence[float]] = None,
                    ignore_index: int = 255,
                    den_reduce: Optional[Callable] = None) -> torch.Tensor:
    """Weighted 2D cross-entropy, torch-NLLLoss semantics: the weighted mean
    sum(w[y]·nll) / sum(w[y]) over the pixels whose target is not
    ``ignore_index``. logits (..., H, W, C); target (..., H, W) ints.
    ``den_reduce``, when given, maps the denominator (which has no
    gradient) before the division: the data-parallel steps sum it over
    the ranks, so each rank's value is its share of the global mean."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = target != ignore_index
    safe = torch.where(valid, target, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=logits.dtype, device=logits.device)
        pix_w = w[safe] * valid
    else:
        pix_w = valid.to(logits.dtype)
    den = torch.sum(pix_w)
    if den_reduce is not None:
        den = den_reduce(den)
    return torch.sum(nll * pix_w) / torch.clamp_min(den, 1e-12)


def partial_cross_entropy2d(logits: torch.Tensor, target: torch.Tensor,
                            den_reduce: Optional[Callable] = None) -> torch.Tensor:
    """CE with class 0 weighted out (weight [0, 1, …, 1]) and no ignored
    index."""
    w = [0.0] + [1.0] * (logits.shape[-1] - 1)
    return cross_entropy2d(logits, target, weight=w, ignore_index=-100,
                           den_reduce=den_reduce)


def entropy_2d(probs: torch.Tensor) -> torch.Tensor:
    """Pixelwise entropy map: (..., C) probs → (...)."""
    return -torch.sum(probs * torch.log(probs + EPS_ENT), dim=-1)


def kl_div_2d(p_prob: torch.Tensor, y_prob: torch.Tensor,
              reduce: bool = False) -> torch.Tensor:
    """KL(y ‖ p) pixelwise map in prob space; ``p_prob`` is pulled toward
    ``y_prob``. Gradient flows through both unless the caller detaches."""
    logp = torch.log(p_prob + EPS_KL)
    logy = torch.log(y_prob + EPS_KL)
    out = torch.sum(y_prob * logy, dim=-1) - torch.sum(y_prob * logp, dim=-1)
    return out.mean() if reduce else out


def kl_div_2d_logits(p_logit: torch.Tensor, y_logit: torch.Tensor,
                     reduce: bool = False) -> torch.Tensor:
    """KL(softmax(y) ‖ softmax(p)) pixelwise map from logits, with log-softmax
    on both sides (the VAT power iteration's divergence)."""
    logp = torch.log_softmax(p_logit, dim=-1)
    logy = torch.log_softmax(y_logit, dim=-1)
    out = torch.sum(torch.exp(logy) * (logy - logp), dim=-1)
    return out.mean() if reduce else out


def jsd_2d(probs) -> torch.Tensor:
    """Jensen-Shannon divergence map over K distributions: probs (K, ..., C)
    (or a list of (..., C)) → (...) map H(mean_k p_k) − mean_k H(p_k)."""
    if isinstance(probs, (list, tuple)):
        probs = torch.stack(probs, dim=0)
    return entropy_2d(probs.mean(dim=0)) - entropy_2d(probs).mean(dim=0)


def mse_2d(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE between the class-1 probability and the target (a binary helper)."""
    prob = torch.softmax(logits, dim=-1)[..., 1]
    return torch.mean((prob - target.to(prob.dtype)) ** 2)


def mse_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two prob tensors (the Mean-Teacher
    consistency)."""
    return torch.mean((p - q) ** 2)


def dice_coefficient(logits: torch.Tensor, target_onehot: torch.Tensor,
                     smooth: float = 1.0) -> torch.Tensor:
    """Soft multiclass dice (B,H,W,C) → (B,C). The target is one-hot, as in
    dct_tpu: a class-index map that does not broadcast against the probs
    raises ValueError, as jnp's broadcasting does."""
    probs = torch.softmax(logits, dim=-1)
    tgt = target_onehot.to(probs.dtype)
    try:
        torch.broadcast_shapes(probs.shape, tgt.shape)
    except RuntimeError as e:
        raise ValueError(f"Incompatible shapes for broadcasting: {tuple(probs.shape)} "
                         f"and {tuple(tgt.shape)} (dice_loss takes a one-hot target)") from e
    num = torch.sum(probs * tgt, dim=(1, 2))
    den1 = torch.sum(probs * probs, dim=(1, 2))
    den2 = torch.sum(tgt * tgt, dim=(1, 2))
    return (2.0 * num + smooth) / (den1 + den2 + smooth)


def dice_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
              optimize_bg: bool = False, weight: Optional[Sequence[float]] = None,
              smooth: float = 1.0, size_average: bool = True,
              reduce: bool = True) -> torch.Tensor:
    """1 − the mean (foreground, unless ``optimize_bg``) soft dice of each
    image; ``weight`` rescales the classes to a mean of 1."""
    dice = dice_coefficient(logits, target_onehot, smooth)
    if not optimize_bg:
        dice = dice[:, 1:]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=dice.dtype, device=dice.device)
        if not optimize_bg:
            w = w[1:]
        dice = dice * (w.shape[0] * w / torch.sum(w))
    loss = 1.0 - torch.mean(dice, dim=1)
    if not reduce:
        return loss
    return torch.mean(loss) if size_average else torch.sum(loss)


def enet_weighing(labels, num_classes: int, c: float = 1.02) -> np.ndarray:
    """ENet's class weights 1/ln(c + p_class), the class frequencies p taken
    on the host over an iterable of int label arrays (values outside
    [0, num_classes) are skipped)."""
    class_count = np.zeros(num_classes, dtype=np.int64)
    total = 0
    for label in labels:
        flat = np.asarray(label).flatten()
        flat = flat[(flat >= 0) & (flat < num_classes)]
        class_count += np.bincount(flat, minlength=num_classes)
        total += flat.size
    return 1.0 / np.log(c + class_count / max(total, 1))


def get_loss_fn(name: str, **kwargs):
    """String → loss callable taking (logits, target)."""
    if name == "cross_entropy":
        return partial(cross_entropy2d, **kwargs)
    if name == "partial_ce":
        return partial_cross_entropy2d
    if name == "mse_2d":
        return mse_2d
    if name == "jsd":
        return jsd_2d
    if name == "dice_loss":
        return partial(dice_loss, **kwargs)
    raise ValueError(f"unknown loss {name!r}")
