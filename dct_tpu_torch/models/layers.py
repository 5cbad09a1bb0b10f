"""Shared building blocks with dct_tpu's semantics (``dct_tpu/models/layers.py``).

Activations are NCHW tensors in ``torch.channels_last`` memory format. Every
layer casts its parameters to the activation's dtype at use, as
``Segmentator`` in dct_tpu casts parameters to its compute dtype, so one set
of fp32 parameters serves fp32 and bf16 forwards.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm

BN_EPS = 1e-3
BN_MOMENTUM = 0.9   # flax convention: new = m·old + (1 − m)·batch


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose kernel ``init_weights_`` draws from the family
    named by ``init``: ``"xavier"`` (dct_tpu's ``conv_kernel_init``),
    ``"lecun"`` (flax's default) or ``("normal", std)``."""

    def __init__(self, *args, init="xavier", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.init = init

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


class Dense(nn.Linear):
    """flax's ``nn.Dense``: lecun-normal kernel, zero bias."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.init = "lecun"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


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
    reassociation.

    With ``group`` set (a data-parallel process group, ``data_parallel.py``)
    train mode normalises with the statistics of the global batch: each
    rank's per-channel mean and centred sum of squares of each half are
    all-gathered with their gradient and combined (Chan's formula, equal
    chunks), and the one-value-a-channel case is decided on the global
    count. flax's rules stay: the biased variance folds into the running
    one, halves labeled first. ``nn.SyncBatchNorm`` folds the unbiased one.

    ``scale_init`` is the family ``init_weights_`` draws the scale from:
    ``"normal"``, N(1, 0.02) (dct_tpu's ``layers.batch_norm``), or
    ``"ones"`` (flax's ``nn.BatchNorm`` default, which DeepLab's, PSPNet's
    and ResNet18's use, with eps 1e-5)."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM, scale_init: str = "normal") -> None:
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale_init = scale_init
        self.update_stats = True
        self.groups = 1
        self.group = None
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
        if comm.group_size(self.group) > 1:
            return self._global(parts, weight, bias, wdt)
        ys = []
        for part in parts:
            if part.numel() == part.shape[1]:
                # one value a channel: flax's (x − mean)·rsqrt(var + eps) is
                # exactly 0 and so has no gradient, the output exactly the
                # bias; native_batch_norm's fused form leaves ~1e-13 there,
                # which a following ReLU would turn into gradient
                y = ((part - part).to(wdt) * weight[None, :, None, None]
                     + bias[None, :, None, None]).to(part.dtype)
                mean, var = part.detach().reshape(-1), torch.zeros_like(weight)
            else:
                y, mean, invstd = torch.native_batch_norm(part, weight, bias, None, None,
                                                          True, 0.0, self.eps)
                var = None
            ys.append(y)
            if self.update_stats:
                with torch.no_grad():     # running = m·running + (1 − m)·batch
                    if var is None:
                        var = invstd.pow(-2) - self.eps
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                            1 - self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype),
                                           1 - self.momentum)
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)

    def _global(self, parts, weight, bias, wdt):
        """Train mode over the global batch of ``group`` (its ranks hold
        equal chunks)."""
        n_rank = comm.group_size(self.group)
        c = parts[0].shape[1]
        local = []
        for part in parts:
            xf = part.to(wdt)
            mean = xf.mean(dim=(0, 2, 3))
            m2 = ((xf - mean[None, :, None, None]) ** 2).sum(dim=(0, 2, 3))
            local.append(torch.cat([mean, m2]))
        every = comm.all_gather(torch.stack(local), self.group)   # (ranks, groups, 2C)
        ys = []
        for i, part in enumerate(parts):
            n = part.numel() // c                                  # a rank's count
            means, m2s = every[:, i, :c], every[:, i, c:]
            mean = means.mean(0)
            var = (m2s.sum(0) + n * ((means - mean) ** 2).sum(0)) / (n * n_rank)
            if n * n_rank == 1:
                y = (part - part).to(wdt) * weight[None, :, None, None]
            else:
                y = ((part.to(wdt) - mean[None, :, None, None])
                     * torch.rsqrt(var + self.eps)[None, :, None, None]
                     * weight[None, :, None, None])
            ys.append((y + bias[None, :, None, None]).to(part.dtype))
            if self.update_stats:
                with torch.no_grad():
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
    "dropout" RNG. With ``shard`` set (a ``data_parallel.DataShard``) the
    mask is drawn for the global batch and cut to this rank's rows, as one
    process would draw it. ``keep_mask``, when set, is used instead of a draw: a
    bool tensor of the activation's NHWC shape (dct_tpu's layout), the way
    tests hand both frameworks the same masks. A 2-D activation (a
    classifier's features) takes a 2-D mask as it is."""

    def __init__(self, rate: float = 0.5) -> None:
        super().__init__()
        self.rate = rate
        self.generator = None
        self.keep_mask = None
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        keep_prob = 1.0 - self.rate
        if self.keep_mask is not None:
            keep = self.keep_mask.to(x.device)
            if x.dim() == 4:
                keep = keep.permute(0, 3, 1, 2)
        elif self.generator is None:
            raise RuntimeError(
                "Dropout needs a generator for 'dropout' in train mode (dct_tpu "
                "passes a dropout RNG only in the supervised step and the "
                "Mean-Teacher student)")
        elif self.shard is not None:    # the global batch's draw, this rank's rows
            keep = self.shard.draw(lambda n: torch.rand(
                (n,) + x.shape[1:], generator=self.generator, device=x.device),
                x.shape[0]) < keep_prob
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


# flax's lecun_normal and xavier_normal are normals truncated at ±2σ, σ
# rescaled by this factor so that the draws' standard deviation is
# sqrt(1 / fan_in), resp. sqrt(2 / (fan_in + fan_out))
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(net: nn.Module, generator: torch.Generator) -> None:
    """dct_tpu's init, each module's own family: conv kernels xavier-normal
    (dct_tpu's ``conv_kernel_init``), N(0, std) or lecun-normal as their
    ``init`` says, Dense kernels lecun-normal, zero biases; BN scale drawn
    from N(1, 0.02) or ones as its ``scale_init`` says, zero BN bias; PReLU
    α 0.25. lecun and xavier are flax's truncated normals
    (``variance_scaling(1, "fan_in" | "fan_avg", "truncated_normal")``).
    Draws follow ``net.modules()`` order from ``generator``."""
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            init = getattr(mod, "init", "xavier")
            if init in ("xavier", "lecun"):
                # a kernel's fans; under fan_avg their sum is the same in
                # torch's transposed-conv (in, out, kh, kw) layout as in flax's
                fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(mod.weight)
                var = 2.0 / (fan_in + fan_out) if init == "xavier" else 1.0 / fan_in
                std = math.sqrt(var) / _TRUNCATED_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            else:
                family, std = init
                if family != "normal":
                    raise ValueError(f"unknown init {init!r}")
                mod.weight.normal_(0.0, std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            if mod.scale_init == "ones":
                mod.weight.fill_(1.0)
            else:
                mod.weight.normal_(1.0, 0.02, generator=generator)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, PReLU):
            mod.alpha.fill_(0.25)
