"""Run one cell of the port's benchmark once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``), its limits
(``benchmark/workloads/<cell>.json``), the step driver the mix names
(``benchmark/drivers/<step>.py``) and each metric's reader
(``benchmark/metrics/<metric>.py``) are found by the names in
``BENCHMARK.json``.

A run builds the program's models, gives them weights drawn from the seed,
drives the three checked steps through the window's own call, counts one
iteration's FLOPs (set-up, ``setup_s``), then calls the step's epoch
function with T iterations a call, each call ending in
``torch.cuda.synchronize()``, until ``--seconds`` have passed (the window).
With ``--trace 1`` a few more iterations then run under ``torch.profiler``.
Then it frees the program's state, runs the plain reference's three steps
on the same inputs and compares (``check.py``). It prints the numbers
compared beside their limits on standard error, and one JSON line on
standard output: the end-to-end metrics with ``--trace 0``, the per-layer
ones with ``--trace 1``.

It exits non-zero, printing no result, without a card (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dct_tpu")

# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

import torch  # noqa: E402

from benchmark import check, trace  # noqa: E402


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file, by path (file names hold dots and dashes)."""
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def spec_of(bench: Path = BENCH) -> dict:
    return load_json(bench.parent / "BENCHMARK.json")


def cell_of(spec: dict, name: str, bench: Path = BENCH) -> SimpleNamespace:
    """The cell ``name``: its entry, configuration, traffic and limits."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    entry = entries[name]
    cell_file = bench / "workloads" / f"{name}.json"
    return SimpleNamespace(
        name=name, entry=entry,
        cfg=load_json(bench / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(cell_file).get("limits", {}) if cell_file.exists() else {})


def metrics_for(spec: dict, cell: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell`` reports."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def host_note(calls, T: int, proc_s: float, window_s: float) -> str:
    """One line on what the host did in the window: its enqueue time an
    iteration (median over the calls) and this process's CPU share."""
    enqueue = sorted((tr - ts) / T * 1e3 for ts, tr, _ in calls)
    return (f"host: enqueue_ms_per_iteration_median {enqueue[len(enqueue) // 2]!r} "
            f"process_cpu_share {proc_s / window_s!r}")


def build_driver(cell: SimpleNamespace, seed: int, device: torch.device,
                 fault: Optional[str] = None, compute_dtype: Optional[str] = None,
                 bench: Path = BENCH):
    ctx = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, seed=seed, device=device,
                          fault=fault, compute_dtype=compute_dtype)
    return load_module(bench / "drivers" / f"{cell.traffic['step']}.py").build(ctx)


def set_precision(cfg: dict, device: torch.device) -> None:
    """Run the program as the configuration states its precision."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = bool(cfg["precision"]["cudnn_tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["precision"]["matmul_tf32"])


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, fault: Optional[str] = None,
             compute_dtype: Optional[str] = None, bench: Path = BENCH,
             t_start: float = T_START) -> dict:
    """One run of cell ``name``; returns the result line's dict."""
    cell = cell_of(spec, name, bench)
    set_precision(cell.cfg, device)
    drv = build_driver(cell, seed, device, fault, compute_dtype, bench)
    drv.setup()
    drv.count_flops()
    sync(device)
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    calls, losses = [], []
    proc0 = time.process_time()
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        out = drv.call(i)
        tr = time.perf_counter()
        sync(device)
        calls.append((ts, tr, time.perf_counter()))
        losses.append(drv.losses(out))
        i += 1
        if calls[-1][2] - t0 >= seconds:
            break
    window_s = calls[-1][2] - t0
    note = host_note(calls, drv.T, time.process_time() - proc0, window_s)
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    iterations = len(calls) * drv.T

    tr_data, traced_iterations = None, 0
    if traced:
        traced_iterations = int(cell.traffic["trace_iterations"])
        path = bench.parent / "build" / "benchmark" / f"trace-{name}.json"
        tr_data = trace.record(lambda: drv.call(i, traced_iterations), path, device)

    window_losses = torch.cat(losses).double().cpu()
    failed = int((~torch.isfinite(window_losses)).any(dim=1).sum())
    del losses, out
    run = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, cell=name, bench=bench,
                          driver=drv, setup_s=setup_s, calls=calls, window_s=window_s,
                          iterations=iterations,
                          images=iterations * drv.images_per_iteration,
                          peak_bytes=peak_bytes, trace=tr_data,
                          traced_iterations=traced_iterations,
                          device_name=torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")
    kind = "per_layer" if traced else "end_to_end"
    metrics: Dict[str, dict] = {}
    for m in metrics_for(spec, name, kind):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    drv.release()
    gc.collect()
    numbers = check.compare(drv.program, drv.run_reference(), cell.cfg["classifier"])
    numbers["nonfinite_window_steps"] = float(failed)
    limits = dict(cell.limits, nonfinite_window_steps=0.0)
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}
    correct = bool(cell.limits) and all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_name, "count": 1, "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": correct, "attempted": iterations, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr_data is not None:
        dev["busy_s"] = tr_data.busy_s()
        dev["window_s"] = tr_data.window_s
        result["breakdown"] = {"device_ops": tr_data.top_device_ops(),
                               "idle_gaps": tr_data.longest_gaps()}
    result["host_note"] = note
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = spec_of()
    chips = cell_of(spec, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    print(result.pop("host_note"), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
