"""Optimizer builders (``dct_tpu/optim.py``).

``Adam(weight_decay=w)`` folds L2 into the gradient before the moments, as
dct_tpu's ``add_decayed_weights`` + ``scale_by_adam`` chain does, and as
``torch.optim.Adam`` does. The training step sets the learning rate of every
parameter group from the epoch's schedule before it steps. The other
optimizers come in a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch


def build_optimizer(optim_dict: Dict[str, Any],
                    params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Config dict {'name': 'Adam', 'lr': ..., ...} → optimizer over params."""
    name = optim_dict["name"]
    if name != "Adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (a later slice ports SGD, "
            "AdamW, RMSprop and AdaBound); only 'Adam' is available")
    betas = tuple(optim_dict.get("betas", (0.9, 0.999)))
    return torch.optim.Adam(params, lr=float(optim_dict["lr"]), betas=betas,
                            eps=float(optim_dict.get("eps", 1e-8)),
                            weight_decay=float(optim_dict.get("weight_decay", 0.0)))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
