"""The plain reference against the port at CPU sizes, the bf16 control and
the planted faults against the comparison, and the control on the card at
the cells' own sizes."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate, check
from benchmark.run import build_driver, cell_of, spec_of
from benchmark.tests.conftest import CELLS, TINY_CELLS

CPU = torch.device("cpu")


def readings(tiny, cell, seed, side):
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    return calibrate.reading(spec, cell, seed, side, CPU, bench=tiny)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_reference_follows_the_port(tiny, cell):
    """Both sides in float32 on the CPU, at CPU sizes: the first step's
    losses, gradients and batch statistics agree to float32 round-off (the
    Cityscapes adversarial term to 1e-2: VAT's direction, a power iteration
    from a 1e-6 step, is float32 round-off itself); after three Adam steps
    every leaf moves by the same order on both sides (Adam's step is about
    ±lr an element, so round-off flips the sign of some small gradient
    elements)."""
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    found = cell_of(spec, cell, tiny)
    drv = build_driver(found, 5, CPU, bench=tiny)
    drv.setup()
    prog = drv.program
    ref = drv.run_reference()
    step1 = (prog.losses[0] - ref.losses[0]).abs() / ref.losses[0].abs()
    vat = cell.startswith("deeplabv3p-city")
    assert float(step1[:-1].max() if vat else step1.max()) < 1e-4
    assert float(step1[-1]) < 1e-2
    numbers = check.compare(prog, ref, found.cfg["classifier"])
    assert numbers["sup_loss_gap"] < 1e-5
    assert numbers["grad_gap_median"] < 1e-4 and numbers["stats_gap_median"] < 1e-4
    assert numbers["grad_angle_median"] < 1e-6 and numbers["head_grad_angle"] < 1e-6
    assert numbers["head_grad_gap"] < 1e-4
    assert numbers["update_gap"] < 0.5
    assert set(prog.change) == set(ref.change) and set(prog.stats_change) == set(ref.stats_change)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_bf16_control_reads_apart(tiny, cell):
    """The program at compute_dtype bfloat16, at CPU sizes: its batch
    statistics read at least ten times as far from the reference as the
    program's as configured. (The committed limits are set at the cells'
    own sizes on the card, where ``test_control_fails_on_the_card`` holds
    the control to them.)"""
    sound = readings(tiny, cell, 5, "program")
    control = readings(tiny, cell, 5, "control")
    assert control["stats_gap_median"] > 10 * sound["stats_gap_median"]


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_fault_fails_the_run(tiny, cell, fault):
    """A whole run on the CPU (no card looked for) with the timed path
    broken underneath: a step that returns its state unchanged, or a
    supervised loss that leaves out half of the batch and takes the mean
    over the rest. ``correct`` comes out false, by a number that exceeds
    its limit and that a sound run at this size reads three times lower."""
    from benchmark.run import run_cell

    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    out = run_cell(spec, cell, 7, 0.1, False, CPU, fault=fault, bench=tiny)
    assert out["correct"] is False
    sound = readings(tiny, cell, 7, "program")
    failing = [k for k, c in out["checks"].items()
               if c["value"] > c["limit"] and c["value"] > 3 * sound.get(k, 0.0)]
    assert failing, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    """At the cell's own size on the card: the bf16 control fails the
    committed limits on three seeds, and the program passes them."""
    spec = spec_of()
    limits = cell_of(spec, cell).limits
    for seed in (101, 102, 103):
        control = calibrate.reading(spec, cell, seed, "control", card)
        assert any(control[k] > v for k, v in limits.items()), control
    sound = calibrate.reading(spec, cell, 104, "program", card)
    assert all(sound[k] <= v for k, v in limits.items()), sound
