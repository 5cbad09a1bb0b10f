"""Optimizer builders (``dct_tpu/optim.py``).

dct_tpu builds each optimizer as an lr-less optax chain that turns the
gradient into a direction; the step applies ``params −= lr(epoch) ·
direction``. The port follows optax's formulas, not torch's classes, where
they differ:

* ``Adam(weight_decay=w)`` folds L2 into the gradient ahead of the moments
  (``add_decayed_weights`` + ``scale_by_adam``), as ``torch.optim.Adam``
  does, so it is torch's Adam.
* ``AdamW`` adds ``w·p`` to Adam's direction, which the step then scales by
  the lr.
* ``SGD`` is L2 then ``optax.trace``: ``t = g + m·t``, the direction ``t``,
  or ``g + m·t`` with ``nesterov`` (torch's SGD with dampening 0).
* ``RMSprop`` is L2 then ``optax.scale_by_rms``: ``ν = α·ν + (1 − α)·g²``
  from ν = 0, the direction ``g·rsqrt(ν + ε)`` (torch divides by
  ``√ν + ε``).
* ``AdaBound`` is L2 then ``scale_by_adabound``: Adam's moments, the
  per-element step ``clip(√bc2/bc1 / (√ν + ε), lower, upper)`` times μ, the
  bounds multiples of the base lr (``final_lr / lr``), ε outside the bias
  correction; ``amsbound`` takes the running maximum of ν. The bias
  corrections and bounds are computed in float32, as dct_tpu casts the
  count to float32 (torch's float32 ``pow`` and XLA's agree at the counts
  the tests reach, ≤ 13; at count 31 they part by one ulp for β = 0.9).
* ``AdaBoundW`` adds ``(w / base_lr)·p`` to AdaBound's direction: exact
  decoupled decay at the base lr, scaled by lr/base_lr under a schedule,
  as in dct_tpu.

``fused: true`` changes dct_tpu's optimizer state into one flat vector per
dtype, not its update (every chain is elementwise): the port accepts it for
every optimizer with the same update, and only the checkpoint layout
follows it (``utils/convert.py``). The training step sets the learning rate
of every parameter group from the epoch's schedule before it steps.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch

OPTIMIZERS = ("Adam", "AdamW", "SGD", "RMSprop", "AdaBound", "AdaBoundW")


class DirectionOptimizer(torch.optim.Optimizer):
    """dct_tpu's optax chains for AdamW, SGD, RMSprop, AdaBound and
    AdaBoundW as a ``torch.optim.Optimizer``: ``p −= lr · direction``.

    State per parameter, in optax's terms: ``step`` (optax's ``count``,
    a Python int), ``exp_avg``/``exp_avg_sq`` (``mu``/``nu`` of Adam and
    AdaBound), ``max_exp_avg_sq`` (AdaBound's ``max_nu``), ``trace`` (SGD)
    and ``square_avg`` (RMSprop's ``nu``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str, lr: float,
                 weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.0, nesterov: bool = False, alpha: float = 0.99,
                 final_lr: float = 0.1, gamma: float = 1e-3,
                 amsbound: bool = False) -> None:
        if name not in OPTIMIZERS[1:]:
            raise KeyError(f"unknown optimizer {name!r}")
        defaults = dict(name=name, lr=lr, base_lr=lr, weight_decay=weight_decay,
                        betas=tuple(betas), eps=eps, momentum=momentum,
                        nesterov=nesterov, alpha=alpha, final_lr=final_lr,
                        gamma=gamma, amsbound=amsbound)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(self._direction(group, p, p.grad, self.state[p]),
                           alpha=-group["lr"])

    def _direction(self, group: Dict[str, Any], p: torch.Tensor, g: torch.Tensor,
                   st: Dict[str, Any]) -> torch.Tensor:
        name, wd = group["name"], group["weight_decay"]
        if wd and name in ("SGD", "RMSprop", "AdaBound"):
            g = g + wd * p                      # L2 ahead of the chain
        if name == "SGD":
            m = group["momentum"]
            if not m:
                return g
            trace = g + m * st["trace"] if "trace" in st else g.clone()
            st["trace"] = trace
            return g + m * trace if group["nesterov"] else trace
        if name == "RMSprop":
            a = group["alpha"]
            nu = (1 - a) * g ** 2 + a * st.get("square_avg", torch.zeros_like(p))
            st["square_avg"] = nu
            return g * torch.rsqrt(nu + group["eps"])
        b1, b2 = group["betas"]
        count = st.get("step", 0) + 1
        zeros = torch.zeros_like(p)
        if name == "AdamW":                 # optax's update_moment order
            mu = (1 - b1) * g + b1 * st.get("exp_avg", zeros)
            nu = (1 - b2) * g ** 2 + b2 * st.get("exp_avg_sq", zeros)
        else:                               # scale_by_adabound's
            mu = b1 * st.get("exp_avg", zeros) + (1 - b1) * g
            nu = b2 * st.get("exp_avg_sq", zeros) + (1 - b2) * g * g
        st.update(step=count, exp_avg=mu, exp_avg_sq=nu)
        if name == "AdamW":
            d = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count)) + group["eps"])
            return d + wd * p if wd else d
        if group["amsbound"]:
            nu = torch.maximum(st.get("max_exp_avg_sq", zeros), nu)
            st["max_exp_avg_sq"] = nu
        ratio, gamma = group["final_lr"] / group["base_lr"], group["gamma"]
        t = torch.tensor(float(count), dtype=torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        scale = float(torch.sqrt(bc2) / bc1)
        # dct_tpu's compiled step fuses γ·t + 1 into one multiply-add, which
        # rounds once: the float32 γ times the count is exact in a double
        fma = torch.tensor(float(np.float32(gamma)) * count + 1.0, dtype=torch.float32)
        lower = float(ratio * (1 - 1 / fma))
        upper = float(ratio * (1 + 1 / (gamma * t)))
        d = torch.clamp(scale / (torch.sqrt(nu) + group["eps"]), lower, upper) * mu
        if name == "AdaBoundW" and wd:
            d = d + (wd / group["base_lr"]) * p
        return d


def build_optimizer(optim_dict: Dict[str, Any],
                    params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Config dict {'name': 'Adam', 'lr': ..., ...} → optimizer over params.
    ``fused`` is read by the checkpoint bridge only."""
    name = optim_dict["name"]
    lr = float(optim_dict["lr"])
    wd = float(optim_dict.get("weight_decay", 0.0))
    betas = tuple(float(b) for b in optim_dict.get("betas", (0.9, 0.999)))
    eps = float(optim_dict.get("eps", 1e-8))
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: {list(OPTIMIZERS)}")
    return DirectionOptimizer(
        params, name, lr, weight_decay=wd, betas=betas, eps=eps,
        momentum=float(optim_dict.get("momentum", 0.0)),
        nesterov=bool(optim_dict.get("nesterov", False)),
        alpha=float(optim_dict.get("alpha", 0.99)),
        final_lr=float(optim_dict.get("final_lr", 0.1)),
        gamma=float(optim_dict.get("gamma", 1e-3)),
        amsbound=bool(optim_dict.get("amsbound", False)))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
