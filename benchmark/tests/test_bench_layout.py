"""The harness is driven by data: BENCHMARK.json's names find every file,
a new configuration, traffic mix, cell and per-layer metric are run by
name from new files alone, and every name and unit keeps to the allowed
characters."""
from __future__ import annotations

import json
import re
import shutil

import torch

from benchmark.run import BENCH, ROOT, metrics_for, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_units_and_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['step']}.py").exists()
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["limits"], w["name"]
        reported = {m["name"] for m in metrics_for(spec, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert metrics_for(spec, w["name"], "per_layer")
    for m in metrics:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in spec["workloads"]}
    for f in BENCH.rglob("*"):
        if "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_/.\-]+$", str(f.relative_to(ROOT))), f


def test_new_cell_and_metric_from_new_files_alone(tiny):
    """A copy of the layout gains a configuration, a traffic mix, a cell and
    a per-layer metric as new files and new BENCHMARK.json entries; the
    existing files are byte for byte as they were, and the harness runs
    the new cell and reports the new metric by name."""
    before = {p: p.read_bytes() for p in tiny.rglob("*") if p.is_file()}
    cfg = json.loads((tiny / "configs" / "enet-acdc.json").read_text())
    cfg.update(name="enet-acdc-48", height=48, width=48)
    (tiny / "configs" / "enet-acdc-48.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny / "traffic" / "sup-tiny.json").read_text())
    traffic.update(batch=3, augment=False)
    (tiny / "traffic" / "sup-b3-plain.json").write_text(json.dumps(traffic))
    shutil.copy(tiny / "workloads" / "enet-acdc-cotrain-b64.json",
                tiny / "workloads" / "enet-acdc-48-sup-b3.json")
    (tiny / "metrics" / "window.calls.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    spec_path = tiny.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "enet-acdc-48", "source": cfg["source"],
                            "file": "benchmark/configs/enet-acdc-48.json", "reduced": [],
                            "why": "a new configuration"})
    spec["workloads"].append({"name": "enet-acdc-48-sup-b3", "config": "enet-acdc-48",
                              "traffic": "sup-b3-plain", "chips": 1, "why": "a new cell"})
    spec["end_to_end"].append({"name": "window.calls", "unit": "calls", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["enet-acdc-48-sup-b3"]})
    spec_path.write_text(json.dumps(spec))
    out = run_cell(spec, "enet-acdc-48-sup-b3", 3, 0.2, False, torch.device("cpu"), bench=tiny)
    assert out["metrics"]["window.calls"]["value"] >= 1
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s", "window.calls"}
    assert out["attempted"] >= 1 and "checks" in out
    for p, data in before.items():
        assert p.read_bytes() == data, p
