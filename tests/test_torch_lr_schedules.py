"""Every LR schedule dct_tpu names, against dct_tpu's, exactly, for epochs
0–300: each is a pure function of the epoch."""
import pytest

from dct_tpu import schedules as jax_schedules
from dct_tpu_torch import schedules

CASES = [
    {"name": "StepLR", "step_size": 90, "gamma": 0.1},
    {"name": "StepLR", "step_size": 7},
    {"name": "MultiStepLR", "milestones": [30, 80, 250], "gamma": 0.5},
    {"name": "MultiStepLR", "milestones": [200, 10]},
    {"name": "ExponentialLR", "gamma": 0.98},
    {"name": "CosineAnnealingLR", "T_max": 100},
    {"name": "CosineAnnealingLR", "T_max": 300, "eta_min": 1e-5},
    {"name": "PolynomialLR", "max_epoch": 200},
    {"name": "PolynomialLR", "max_epoch": 300, "power": 2},
    {"name": "ConstantLR"},
    {"name": "ConstantLR", "factor": 0.5},        # keys a schedule does not take are ignored
]


@pytest.mark.parametrize("base_lr", [1e-3, 0.1])
@pytest.mark.parametrize("sched", CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_schedule_equals_dct_tpu(sched, base_lr):
    got = schedules.get_lr_schedule(sched, base_lr)
    ref = jax_schedules.get_lr_schedule(sched, base_lr)
    assert [got(e) for e in range(301)] == [ref(e) for e in range(301)]


def test_unknown_schedule_raises_in_both():
    with pytest.raises(KeyError, match="unknown LR scheduler"):
        schedules.get_lr_schedule({"name": "OneCycleLR"}, 0.1)
    with pytest.raises(KeyError, match="unknown LR scheduler"):
        jax_schedules.get_lr_schedule({"name": "OneCycleLR"}, 0.1)
