"""Segmentation losses, class axis last (B,H,W,C) (``dct_tpu/losses.py``).

The probability-space functions take probs, ``cross_entropy2d`` takes raw
logits.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch

EPS_KL = 1e-10
EPS_ENT = 1e-16


def cross_entropy2d(logits: torch.Tensor, target: torch.Tensor,
                    weight: Optional[Sequence[float]] = None,
                    ignore_index: int = 255) -> torch.Tensor:
    """Weighted 2D cross-entropy, torch-NLLLoss semantics: the weighted mean
    sum(w[y]·nll) / sum(w[y]) over the pixels whose target is not
    ``ignore_index``. logits (..., H, W, C); target (..., H, W) ints."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = target != ignore_index
    safe = torch.where(valid, target, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=logits.dtype, device=logits.device)
        pix_w = w[safe] * valid
    else:
        pix_w = valid.to(logits.dtype)
    return torch.sum(nll * pix_w) / torch.clamp_min(torch.sum(pix_w), 1e-12)


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


def mse_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two prob tensors (the Mean-Teacher
    consistency)."""
    return torch.mean((p - q) ** 2)


def get_loss_fn(name: str, **kwargs):
    """String → loss callable taking (logits, target)."""
    if name == "cross_entropy":
        return partial(cross_entropy2d, **kwargs)
    if name == "jsd":
        return jsd_2d
    raise NotImplementedError(
        f"loss {name!r} is not ported yet (a later slice); available: "
        "cross_entropy, jsd")
