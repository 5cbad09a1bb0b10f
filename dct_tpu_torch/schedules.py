"""Loss-weight ramps and epoch-indexed LR schedules (``dct_tpu/schedules.py``).

Each is a pure function of the epoch index, read on the host and passed to
the training step as a number. Ported: the three loss-weight schedulers
and StepLR; the other LR schedules come in a later slice.
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


class ConstantScheduler(WeightScheduler):
    """0 until ``begin_epoch``, then ``max_value``."""

    def __init__(self, begin_epoch: int, max_value: float = 1.0) -> None:
        super().__init__()
        self.begin_epoch = int(begin_epoch)
        self.max_value = float(max_value)

    @property
    def value(self) -> float:
        return 0.0 if self.epoch < self.begin_epoch else self.max_value


class RampDownScheduler(WeightScheduler):
    """Exponential ramp-down to ``min_val``."""

    def __init__(self, max_epoch: int, max_value: float, ramp_mult: float,
                 min_val: float, cutoff: int) -> None:
        super().__init__()
        self.max_epoch = int(max_epoch)
        self.max_value = float(max_value)
        self.mult = float(ramp_mult)
        self.min_val = float(min_val)
        self.cutoff = int(cutoff)
        assert self.cutoff < self.max_epoch

    @property
    def value(self) -> float:
        e = self.epoch
        if e == 0:
            return self.max_value
        if e >= self.cutoff:
            return self.min_val
        return (self.max_value
                - self.max_value * math.exp(self.mult * (1.0 - float(e) / self.cutoff) ** 2)
                + self.min_val)


WEIGHT_SCHEDULERS = {
    "RampScheduler": RampScheduler,
    "ConstantScheduler": ConstantScheduler,
    "RampDownScheduler": RampDownScheduler,
}


def get_weight_scheduler(sched_dict: Dict[str, Any]) -> WeightScheduler:
    """Build by name from a config dict."""
    name = sched_dict["name"]
    kwargs = {k: v for k, v in sched_dict.items() if k != "name"}
    return WEIGHT_SCHEDULERS[name](**kwargs)


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
