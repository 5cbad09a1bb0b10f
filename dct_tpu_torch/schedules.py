"""Loss-weight ramps and epoch-indexed LR schedules (``dct_tpu/schedules.py``).

Each is a pure function of the epoch index, read on the host and passed to
the training step as a number: the three loss-weight schedulers and the
six LR schedules dct_tpu names (StepLR, MultiStepLR, ExponentialLR,
CosineAnnealingLR, PolynomialLR, ConstantLR), each stepped once an epoch.
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


def multi_step_lr(base_lr: float, milestones, gamma: float = 0.1):
    milestones = sorted(int(m) for m in milestones)

    def lr(epoch: int) -> float:
        return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)
    return lr


def exponential_lr(base_lr: float, gamma: float):
    def lr(epoch: int) -> float:
        return base_lr * gamma ** epoch
    return lr


def cosine_annealing_lr(base_lr: float, T_max: int, eta_min: float = 0.0):
    def lr(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max)) / 2
    return lr


def polynomial_lr(base_lr: float, max_epoch: int, power: float = 0.9):
    def lr(epoch: int) -> float:
        return base_lr * max(1.0 - epoch / max_epoch, 0.0) ** power
    return lr


def constant_lr(base_lr: float):
    def lr(epoch: int) -> float:
        return base_lr
    return lr


_LR_BUILDERS = {
    "StepLR": lambda base_lr, step_size, gamma=0.1, **_: step_lr(
        base_lr, int(step_size), float(gamma)),
    "MultiStepLR": lambda base_lr, milestones, gamma=0.1, **_: multi_step_lr(
        base_lr, milestones, float(gamma)),
    "ExponentialLR": lambda base_lr, gamma, **_: exponential_lr(base_lr, float(gamma)),
    "CosineAnnealingLR": lambda base_lr, T_max, eta_min=0.0, **_: cosine_annealing_lr(
        base_lr, T_max, float(eta_min)),
    "PolynomialLR": lambda base_lr, max_epoch, power=0.9, **_: polynomial_lr(
        base_lr, max_epoch, float(power)),
    "ConstantLR": lambda base_lr, **_: constant_lr(base_lr),
}


def get_lr_schedule(scheduler_dict: Dict[str, Any], base_lr: float):
    """lr(epoch) from a Scheduler config block; keys a schedule does not
    take are ignored, as in dct_tpu."""
    name = scheduler_dict["name"]
    kwargs = {k: v for k, v in scheduler_dict.items() if k != "name"}
    if name not in _LR_BUILDERS:
        raise KeyError(f"unknown LR scheduler {name!r}; available: {sorted(_LR_BUILDERS)}")
    return _LR_BUILDERS[name](base_lr=base_lr, **kwargs)
