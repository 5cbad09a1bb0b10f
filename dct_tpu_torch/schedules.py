"""Loss-weight ramps and epoch-indexed LR schedules (``dct_tpu/schedules.py``).

Each is a pure function of the epoch index, read on the host and passed to
the training step as a number. This slice ports StepLR and RampScheduler.
"""
from __future__ import annotations

import math
from typing import Any, Dict


class WeightScheduler:
    """Base: epoch-stepped scalar schedule with a state_dict round trip."""

    def __init__(self) -> None:
        self.epoch = 0

    def step(self) -> None:
        self.epoch += 1

    @property
    def value(self) -> float:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.__dict__.update(state_dict)


class RampScheduler(WeightScheduler):
    """Exponential ramp-up to ``max_value``."""

    def __init__(self, begin_epoch: int, max_epoch: int, max_value: float,
                 ramp_mult: float) -> None:
        super().__init__()
        self.begin_epoch = int(begin_epoch)
        self.max_epoch = int(max_epoch)
        self.max_value = float(max_value)
        self.mult = float(ramp_mult)

    @property
    def value(self) -> float:
        return self.get_lr(self.epoch, self.begin_epoch, self.max_epoch,
                           self.max_value, self.mult)

    @staticmethod
    def get_lr(epoch: int, begin_epoch: int, max_epochs: int, max_val: float,
               mult: float) -> float:
        if epoch < begin_epoch:
            return 0.0
        if epoch >= max_epochs:
            return max_val
        frac = 1.0 - float(epoch - begin_epoch) / (max_epochs - begin_epoch)
        return max_val * math.exp(mult * frac ** 2)


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1):
    def lr(epoch: int) -> float:
        return base_lr * gamma ** (epoch // step_size)
    return lr


def get_lr_schedule(scheduler_dict: Dict[str, Any], base_lr: float):
    """lr(epoch) from a Scheduler config block."""
    name = scheduler_dict["name"]
    if name != "StepLR":
        raise NotImplementedError(
            f"LR scheduler {name!r} is not ported yet (a later slice); only "
            "'StepLR' is available")
    return step_lr(base_lr, int(scheduler_dict["step_size"]),
                   float(scheduler_dict.get("gamma", 0.1)))
