"""Shared building blocks with dct_tpu's semantics (``dct_tpu/models/layers.py``).

Activations are NCHW tensors in ``torch.channels_last`` memory format. Every
layer casts its parameters to the activation's dtype at use, as
``Segmentator`` in dct_tpu casts parameters to its compute dtype, so one set
of fp32 parameters serves fp32 and bf16 forwards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.9   # flax convention: new = m·old + (1 − m)·batch


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class PReLU(nn.Module):
    """Per-channel PReLU, ``where(x >= 0, x, α·x)``, α initialised to 0.25."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)[None, :, None, None]
        return torch.where(x >= 0, x, alpha * x)


class BatchNorm(nn.Module):
    """BatchNorm2d with flax's semantics (eps 1e-3, momentum 0.9).

    Train mode normalises with the batch statistics in one stock
    ``native_batch_norm`` pass (statistics in fp32 whatever the activation
    dtype) and folds the *biased* batch variance, recovered from the saved
    inverse std, into the running variance — torch's ``nn.BatchNorm2d`` folds
    the unbiased one. Running statistics stay fp32 whatever the activation
    dtype; the output takes the input's dtype. With ``update_stats`` False,
    train mode normalises with the batch statistics and leaves the running
    ones as they are (VAT's perturbed forwards, whose statistics dct_tpu
    throws away).

    With ``groups`` = 2 (the fused two-group forward of
    ``dct_tpu/train/steps.py:make_cotrain_epoch``), the batch is the
    labeled images stacked on the unlabeled ones: each half is normalised
    with its own batch statistics (one ``native_batch_norm`` over each
    half's view, so ``channels_last`` stays as it is), and the running
    statistics take the halves in order, labeled first:
    r1 = m·r0 + (1 − m)·b_lab, then r2 = m·r1 + (1 − m)·b_unlab, which
    is dct_tpu's composed ``m·kg[:,0] + kg[:,1] − m·r0`` up to float
    reassociation."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM) -> None:
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.groups = 1
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wdt = torch.promote_types(x.dtype, torch.float32)
        weight, bias = self.weight.to(wdt), self.bias.to(wdt)
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(wdt),
                                self.running_var.to(wdt), weight, bias,
                                False, 0.0, self.eps)
        parts = x.chunk(self.groups, dim=0) if self.groups > 1 else (x,)
        if any(p.shape[0] != parts[0].shape[0] for p in parts):
            raise ValueError(f"a batch of {x.shape[0]} does not split into "
                             f"{self.groups} equal groups")
        ys = []
        for part in parts:
            y, mean, invstd = torch.native_batch_norm(part, weight, bias, None, None,
                                                      True, 0.0, self.eps)
            ys.append(y)
            if self.update_stats:
                with torch.no_grad():     # running = m·running + (1 − m)·batch
                    var = invstd.pow(-2) - self.eps
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                            1 - self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype),
                                           1 - self.momentum)
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)`` in train mode: an element-wise Bernoulli
    keep mask, ``where(keep, x / keep_prob, 0)``; identity in eval mode.

    The mask is drawn from ``generator``, which the Segmentator sets for one
    train-mode forward (``apply_train(dropout_generator=...)``); a
    train-mode forward without one raises, as flax raises without a
    "dropout" RNG. ``keep_mask``, when set, is used instead of a draw: a
    bool tensor of the activation's NHWC shape (dct_tpu's layout), the way
    tests hand both frameworks the same masks."""

    def __init__(self, rate: float = 0.5) -> None:
        super().__init__()
        self.rate = rate
        self.generator = None
        self.keep_mask = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        keep_prob = 1.0 - self.rate
        if self.keep_mask is not None:
            keep = self.keep_mask.to(x.device).permute(0, 3, 1, 2)
        elif self.generator is None:
            raise RuntimeError(
                "Dropout needs a generator for 'dropout' in train mode (dct_tpu "
                "passes a dropout RNG only in the supervised step and the "
                "Mean-Teacher student)")
        else:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)


def remat(stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``stage(x)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``; dct_tpu's ``nn.remat``): the same outputs
    and gradients. The recomputation normalises with the batch statistics
    and the groups of the first pass and leaves the running statistics as
    that pass left them."""
    from torch.utils.checkpoint import checkpoint

    bns = [m for m in stage.modules() if isinstance(m, BatchNorm)]
    first = [(m.update_stats, m.groups) for m in bns]
    calls = []

    def run(h):
        if not calls:
            calls.append(1)
            return stage(h)
        saved = [(m.update_stats, m.groups) for m in bns]
        for m, (_, groups) in zip(bns, first):
            m.update_stats, m.groups = False, groups
        try:
            return stage(h)
        finally:
            for m, st in zip(bns, saved):
                m.update_stats, m.groups = st

    if not torch.is_grad_enabled():
        return stage(x)
    return checkpoint(run, x, use_reentrant=False)


@torch.no_grad()
def init_weights_(net: nn.Module, generator: torch.Generator) -> None:
    """dct_tpu's init: xavier-normal conv kernels, zero conv biases, BN scale
    drawn from N(1, 0.02), zero BN bias, PReLU α 0.25. Draws follow
    ``net.modules()`` order from ``generator``."""
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_normal_(mod.weight, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.normal_(1.0, 0.02, generator=generator)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, PReLU):
            mod.alpha.fill_(0.25)
