"""Segmentator: net + optimizer + LR schedule bundled from config dicts
(``dct_tpu/models/segmentator.py``).

dct_tpu keeps the state as an explicit pytree threaded through pure steps;
here the state is the module's parameters and buffers and the optimizer's
state, updated in place by the training step.

``compute_dtype`` (config ``Arch.compute_dtype``) is the mixed-precision
knob: parameters and optimizer state stay fp32, every layer casts its
parameters and the input to this dtype at use (dct_tpu casts both), BatchNorm
running statistics stay fp32, and logits come back as fp32.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import resolve_device
from ..optim import build_optimizer
from ..schedules import get_lr_schedule
from . import get_arch
from .layers import init_weights_

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Segmentator:
    def __init__(self, arch_dict: Dict[str, Any], optim_dict: Dict[str, Any],
                 scheduler_dict: Dict[str, Any], generator: torch.Generator,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.arch_dict = dict(arch_dict)
        self.optim_dict = dict(optim_dict)
        self.scheduler_dict = dict(scheduler_dict)
        self.arch_name = arch_dict["name"]
        arch_params = {k: v for k, v in arch_dict.items() if k != "name"}
        dtype_name = str(arch_params.pop("compute_dtype", "float32"))
        if dtype_name not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype_name!r}")
        self.compute_dtype = _DTYPES[dtype_name]

        net = get_arch(self.arch_name, arch_params)
        init_weights_(net, generator)      # on the CPU: draws are device-free
        self.net = net.to(self.device, memory_format=torch.channels_last)
        self.optimizer = build_optimizer(optim_dict, self.net.parameters())
        self.lr_fn = get_lr_schedule(scheduler_dict, float(optim_dict["lr"]))

    def apply_train(self, x: torch.Tensor) -> torch.Tensor:
        """Forward in train mode: BatchNorm normalises with the batch
        statistics and updates its running ones. Returns fp32 logits."""
        self.net.train()
        return self.net(x.to(self.compute_dtype)).float()

    def apply_eval(self, x: torch.Tensor) -> torch.Tensor:
        """Forward in eval mode (running BatchNorm statistics)."""
        self.net.eval()
        return self.net(x.to(self.compute_dtype)).float()
