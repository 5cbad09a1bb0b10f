"""A CPU rehearsal of each step driver through the harness's own code: a
whole run, untraced and traced, at CPU sizes."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.conftest import TINY_CELLS


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu(tiny, cell, traced):
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    out = run_cell(spec, cell, 2**31 + 12345, 0.2, traced, torch.device("cpu"), bench=tiny)
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    if traced:
        assert "step.host_enqueue_ms" in out["metrics"]
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    else:
        assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
        assert out["metrics"]["train_images_per_s"]["value"] > 0
    for c in out["checks"].values():
        assert c["value"] == c["value"]          # no NaN
