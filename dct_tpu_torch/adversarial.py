"""Adversarial inputs from a Segmentator's input gradient: FGSM and VAT
(``dct_tpu/adversarial.py``).

Both differentiate with respect to the input only (``torch.autograd.grad``),
so no parameter's ``.grad`` is filled, and both return detached tensors, as
dct_tpu stop-gradients its generators' outputs. Every forward runs in train
mode (batch statistics), as dct_tpu's in-training attacks do.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .losses import kl_div_2d_logits
from .models.segmentator import Segmentator


def fgsm(seg: Segmentator, img: torch.Tensor, gt: torch.Tensor,
         loss_fn: Callable, epsilon: float = 0.05, update_stats: bool = True,
         dtype: Optional[torch.dtype] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FGSM: ``img + ε·sign(∇_img loss)``. When ``img`` has more rows than
    ``gt``, the extra rows are labeled with the model's own argmax. The
    forward updates BatchNorm's running statistics, as dct_tpu keeps that
    forward's in the co-training step, unless ``update_stats`` is False (the
    Cityscapes step, which throws them away). ``dtype`` overrides the
    Segmentator's compute dtype for the forward and its input gradient
    (dct_tpu's ``adv_dtype``). Returns (adversarial image, noise, softmax
    probabilities of the clean forward)."""
    x = img.detach().requires_grad_(True)
    logits = seg.apply_train(x, update_stats=update_stats, dtype=dtype)
    if gt.shape[0] < x.shape[0]:
        pseudo = torch.argmax(logits[gt.shape[0]:].detach(), dim=-1)
        gt = torch.cat([gt, pseudo], dim=0)
    (g,) = torch.autograd.grad(loss_fn(logits, gt), [x])
    noise = epsilon * torch.sign(g)
    return (img + noise).detach(), noise, torch.softmax(logits.detach(), dim=-1)


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    """Per-sample L2 normalisation."""
    norms = torch.sqrt(torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=1) + 1e-16)
    return d / norms.reshape((-1,) + (1,) * (d.dim() - 1))


def vat_perturbation(seg: Segmentator, img: torch.Tensor, xi: float = 1e-6,
                     epsilon: float = 10.0, ip: int = 1, clamp: bool = True,
                     d: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     update_stats: bool = True, mean: Callable = torch.mean
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Virtual adversarial perturbation by ``ip`` power iterations
    (arXiv 1704.03976), as dct_tpu computes it.

    The clean forward runs without a graph and updates BatchNorm's running
    statistics (unless ``update_stats`` is False: the Cityscapes step keeps
    none of VAT's); each perturbed forward normalises with its batch statistics
    and updates nothing (dct_tpu throws their statistics away). The starting
    noise ``d``, of ``img``'s shape, is drawn from ``generator`` unless
    given. Returns (adversarial image, clamped to [0, 1] when ``clamp``;
    ``r_adv``), both detached; ``r_adv`` has L2 norm ``epsilon`` per sample
    unless the power iteration's gradient is exactly zero. ``mean`` reduces
    the power iteration's KL map (a data-parallel step passes its rank's
    share of the global mean)."""
    with torch.no_grad():
        clean_logits = seg.apply_train(img, update_stats=update_stats)
    if d is None:
        d = torch.randn(img.shape, generator=generator, device=img.device,
                        dtype=img.dtype)
    d = _l2_normalize(d)
    for _ in range(ip):
        dd = (xi * _l2_normalize(d)).requires_grad_(True)
        y_hat = seg.apply_train(img + dd, update_stats=False)
        (d,) = torch.autograd.grad(
            mean(kl_div_2d_logits(y_hat, clean_logits)), [dd])
    r_adv = epsilon * _l2_normalize(d)
    adv_img = img + r_adv
    if clamp:
        adv_img = torch.clamp(adv_img, 0.0, 1.0)
    return adv_img.detach(), r_adv.detach()


class FSGMGenerator:
    """dct_tpu's object form of :func:`fgsm` (the reference's spelling),
    around a Segmentator instead of an apply function.
    ``gen(img, gt, criterion)`` returns :func:`fgsm`'s (adversarial image,
    noise, softmax probabilities) and updates the Segmentator's running
    statistics in place; dct_tpu's returns the new statistics as a fourth
    value."""

    def __init__(self, seg: Segmentator, eplision: float = 0.05) -> None:
        self.seg = seg
        self.eplision = eplision

    def __call__(self, img: torch.Tensor, gt: torch.Tensor, criterion: Callable
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return fgsm(self.seg, img, gt, criterion, self.eplision)


class VATGenerator:
    """dct_tpu's object form of :func:`vat_perturbation` (power iterations
    ``ip`` from ``xi``-scaled noise, an ``eplision`` step), around a
    Segmentator. ``gen(img, generator=None, d=None)`` draws the starting
    noise from ``generator`` unless ``d`` is given (one of the two is
    required; dct_tpu takes a key) and returns (adversarial image clamped
    to [0, 1], ``r_adv``); the clean forward updates the Segmentator's
    running statistics in place, where dct_tpu returns them as a third
    value."""

    def __init__(self, seg: Segmentator, xi: float = 1e-6,
                 eplision: float = 10.0, ip: int = 1) -> None:
        self.seg = seg
        self.xi = xi
        self.eps = eplision
        self.ip = ip

    def __call__(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                 d: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if generator is None and d is None:
            raise ValueError("VATGenerator needs a generator or the noise d")
        return vat_perturbation(self.seg, img, self.xi, self.eps, self.ip,
                                d=d, generator=generator)
