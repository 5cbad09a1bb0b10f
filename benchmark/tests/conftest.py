"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's layout
cut to sizes the CPU holds, with a cell of the supervised step added, and
the ``card`` marker for tests that need the
NVIDIA card (they decide inside a fixture, and skip here)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent

# per configuration, the keys a CPU run shrinks: depth, size and data set
TINY_CONFIG = {
    "enet-acdc": {"height": 32, "width": 32, "dataset_images": 48},
    "deeplabv3p-city": {"height": 32, "width": 64, "dataset_images": 64,
                        "arch": {"name": "deeplabv3plus", "num_classes": 19, "output_stride": 8,
                                 "n_blocks": [1, 1, 1, 1], "grids": [1]}},
}
TINY_TRAFFIC = {"batch": 2, "unlabeled_batch": 2, "adversarial_batch": 2,
                "iterations_per_call": 2, "trace_iterations": 1, "pool_calls": 2}
# DeepLab's mix keeps its batch of 4, so that a half-batch fault shows
TINY_BY_TRAFFIC = {"city-cotrain-b4": {"batch": 4, "unlabeled_batch": 4, "adversarial_batch": 4}}
# the supervised step, which no committed cell runs yet, in a cell of the copy
SUP_CELL = "enet-acdc-sup-tiny"
SUP_TRAFFIC = {"step": "sup", "models": 1, "batch": 2, "iterations_per_call": 2,
               "trace_iterations": 1, "pool_calls": 2, "augment": True}
# the cells that the CPU tests run: the committed ones and the supervised one
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
TINY_CELLS = CELLS + [SUP_CELL]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def write_tiny(root: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's files under ``root``,
    its configurations and traffic cut to CPU sizes; returns the copy's
    benchmark directory."""
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, change in TINY_CONFIG.items():
        path = bench / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(change)
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
        traffic.update(TINY_BY_TRAFFIC.get(path.stem, {}))
        path.write_text(json.dumps(traffic))
    (bench / "traffic" / "sup-tiny.json").write_text(json.dumps(SUP_TRAFFIC))
    shutil.copy(bench / "workloads" / "enet-acdc-cotrain-b64.json",
                bench / "workloads" / f"{SUP_CELL}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": SUP_CELL, "config": "enet-acdc", "traffic": "sup-tiny",
                              "chips": 1, "why": "the supervised step at CPU sizes"})
    for m in spec["per_layer"]:           # what the ENet cell reports
        if "enet-acdc-cotrain-b64" in m.get("workloads", [SUP_CELL]):
            m["workloads"].append(SUP_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture
def tiny(tmp_path) -> Path:
    torch.set_num_threads(2)
    return write_tiny(tmp_path)
