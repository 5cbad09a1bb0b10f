"""Segmentator: net + optimizer + LR schedule bundled from config dicts
(``dct_tpu/models/segmentator.py``).

dct_tpu keeps the state as an explicit pytree threaded through pure steps;
here the state is the module's parameters and buffers and the optimizer's
state, updated in place by the training step.

``compute_dtype`` (config ``Arch.compute_dtype``) is the mixed-precision
knob: parameters and optimizer state stay fp32, every layer casts its
parameters and the input to this dtype at use (dct_tpu casts both), BatchNorm
running statistics stay fp32, and logits come back as fp32.

``in_channels``, when given, is the data's channel count and overrides the
config's: dct_tpu's flax modules take theirs from the input they are
initialised on (1 for the medical CLIs, 3 for Cityscapes), whatever
``Arch.in_channels`` says (SegNet and FCN declare 3).

An arch with dropout (``unet``, ``unet_bn``, the FCNs) draws its masks in a
train-mode forward from the generator the caller passes, as dct_tpu passes
a dropout RNG; without one it raises, as flax does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..optim import build_optimizer
from ..schedules import get_lr_schedule
from ..utils.convert import (load_optim_state, optim_state_to_jax, params_from_jax,
                             params_to_jax)
from ..utils.general import fold_in
from . import BN_MOMENTUM, get_arch
from .layers import BatchNorm, Dropout, init_weights_

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a dtype, its name ("float32", "bfloat16",
    "float64") or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name not in (*_DTYPES, "float64"):
        raise ValueError(f"unknown dtype {dtype!r}")
    return getattr(torch, name)


class Segmentator:
    def __init__(self, arch_dict: Dict[str, Any], optim_dict: Dict[str, Any],
                 scheduler_dict: Dict[str, Any], generator: torch.Generator,
                 device=None, in_channels: Optional[int] = None) -> None:
        self.device = resolve_device(device)
        self.arch_dict = dict(arch_dict)
        self.optim_dict = dict(optim_dict)
        self.scheduler_dict = dict(scheduler_dict)
        self.arch_name = arch_dict["name"]
        # the arch's uniform BatchNorm momentum; None disables the fused
        # two-group co-training forward, as in dct_tpu
        self.bn_momentum = BN_MOMENTUM.get(self.arch_name)
        arch_params = {k: v for k, v in arch_dict.items() if k != "name"}
        dtype_name = str(arch_params.pop("compute_dtype", "float32"))
        if dtype_name not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype_name!r}")
        self.compute_dtype = _DTYPES[dtype_name]
        if in_channels is not None:
            arch_params["in_channels"] = int(in_channels)

        net = get_arch(self.arch_name, arch_params)
        init_weights_(net, generator)      # on the CPU: draws are device-free
        self.net = net.to(self.device, memory_format=torch.channels_last)
        self._batch_norms = [m for m in net.modules() if isinstance(m, BatchNorm)]
        self._dropouts = [m for m in net.modules() if isinstance(m, Dropout)]
        self.optimizer = build_optimizer(optim_dict, self.net.parameters())
        self.lr_fn = get_lr_schedule(scheduler_dict, float(optim_dict["lr"]))
        self.epoch = 0

    def set_data_parallel(self, shard) -> None:
        """Run every train-mode forward as this rank's chunk of a
        data-parallel global batch (a ``parallel.data_parallel.DataShard``,
        or None for one process): BatchNorm over the global batch, dropout
        masks cut from the global batch's draw."""
        for m in self._batch_norms:
            m.group = None if shard is None or shard.n == 1 else shard.group
        for m in self._dropouts:
            m.shard = None if shard is None or shard.n == 1 else shard

    def apply_train(self, x: torch.Tensor, update_stats: bool = True,
                    groups: int = 1, dtype: Optional[torch.dtype] = None,
                    dropout_generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """Forward in train mode: BatchNorm normalises with the batch
        statistics and updates its running ones, unless ``update_stats`` is
        False. ``groups`` = 2 runs the fused two-group forward: the batch is
        two equal groups (labeled, then unlabeled), each normalised with its
        own statistics, the running ones updated group by group
        (``layers.BatchNorm``). ``dtype`` overrides ``compute_dtype`` for
        this forward (dct_tpu's ``adv_dtype``). Dropout draws its masks from
        ``dropout_generator`` and raises without one. Returns fp32 logits."""
        self.net.train()
        for m in self._batch_norms:
            m.update_stats, m.groups = update_stats, groups
        for m in self._dropouts:
            m.generator = dropout_generator
        try:
            return self.net(x.to(dtype or self.compute_dtype)).float()
        finally:
            for m in self._batch_norms:
                m.update_stats, m.groups = True, 1
            for m in self._dropouts:
                m.generator = None

    def dropout_generator(self, generator: Optional[torch.Generator],
                          *stream: int) -> Optional[torch.Generator]:
        """A generator for one forward's dropout masks, seeded from
        ``generator``'s seed and ``stream`` (dct_tpu's ``fold_in`` of the
        step's key), on the net's device; None for an arch without dropout
        or without ``generator``. It draws nothing from ``generator``."""
        if not self._dropouts or generator is None:
            return None
        seed = generator.initial_seed()
        for s in stream:
            seed = fold_in(seed, s)
        return torch.Generator(device=self.device).manual_seed(seed)

    def apply_eval(self, x: torch.Tensor) -> torch.Tensor:
        """Forward in eval mode (running BatchNorm statistics)."""
        self.net.eval()
        return self.net(x.to(self.compute_dtype)).float()

    def predict(self, img: torch.Tensor, logit: bool = True) -> torch.Tensor:
        """Eval-mode logits, or with ``logit`` False their softmax over the
        last (class) axis, under ``torch.inference_mode``."""
        with torch.inference_mode():
            out = self.apply_eval(img)
            return out if logit else torch.softmax(out, dim=-1)

    def lr(self, epoch: Optional[int] = None) -> float:
        return self.lr_fn(self.epoch if epoch is None else epoch)

    def scheduler_step(self) -> None:
        self.epoch += 1

    # self-describing checkpoint payload (a checkpoint's ``segmentator``
    # entry), in dct_tpu's layout: flax parameter trees, and the optimizer
    # state as dct_tpu's tree layout in plain dicts (``utils/convert.py``)
    @property
    def state_dict(self) -> Dict[str, Any]:
        params, batch_stats = params_to_jax(self.net.state_dict())
        return {"arch_dict": self.arch_dict,
                "optim_dict": self.optim_dict,
                "scheduler_dict": self.scheduler_dict,
                "net_state_dict": params,
                "batch_stats": batch_stats,
                "optim_state_dict": optim_state_to_jax(self.optimizer, self.net,
                                                        self.optim_dict),
                "scheduler_state_dict": {"epoch": self.epoch}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Weights, LR epoch and, where the payload has it (dct_tpu's optax
        state or the port's), the optimizer state."""
        self.net.load_state_dict(params_from_jax(sd["net_state_dict"],
                                                 sd["batch_stats"]))
        if "optim_state_dict" in sd:
            load_optim_state(self.optimizer, self.net, sd["optim_state_dict"],
                             self.optim_dict)
        self.epoch = int(sd["scheduler_state_dict"]["epoch"])

    @classmethod
    def from_state_dict(cls, sd: Dict[str, Any], device=None,
                        in_channels: Optional[int] = None) -> "Segmentator":
        """Rebuild a Segmentator from a checkpoint alone."""
        seg = cls(sd["arch_dict"], sd["optim_dict"], sd["scheduler_dict"],
                  torch.Generator().manual_seed(0), device=device,
                  in_channels=in_channels)
        seg.load_state_dict(sd)
        return seg
