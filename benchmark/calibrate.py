"""The readings that a cell's limits are set from: for each seed, the
numbers that ``check.compare`` gives for the program as the configuration
states it, for the control (the program at ``compute_dtype`` bfloat16) and
for the planted faults, with no measured window (training's readings need
none). On the card, one process for all seeds:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--fault-seeds 7 8 9] [--out <file.jsonl>]

prints one JSON line a reading: {"workload", "seed", "side", numbers...},
``side`` one of "program", "control", "half_batch", "frozen_state". Then

    python3 -m benchmark.calibrate --workload <cell> --limits-from <file.jsonl>

writes the cell's limits (``workloads/<cell>.json``) from those readings,
by :func:`limits`.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from benchmark import check
from benchmark.run import build_driver, cell_of, set_precision, spec_of

SIDES = {"program": {}, "control": {"compute_dtype": "bfloat16"},
         "half_batch": {"fault": "half_batch"}, "frozen_state": {"fault": "frozen_state"}}
# how far above the program's largest reading a side's smallest has to lie
# to set a number's upper reading
APART = {"control": 3.0, "half_batch": 10.0, "frozen_state": 3.0}


def reading(spec: dict, name: str, seed: int, side: str, device: torch.device,
            bench: Optional[Path] = None, keep_raw: bool = False) -> dict:
    """One side's numbers on one seed; with ``keep_raw`` also both sides'
    readings by leaf."""
    cell = cell_of(spec, name, *(() if bench is None else (bench,)))
    set_precision(cell.cfg, device)
    t0 = time.perf_counter()
    kwargs = dict(SIDES[side])
    if bench is not None:
        kwargs["bench"] = bench
    drv = build_driver(cell, seed, device, **kwargs)
    drv.setup()
    program = drv.program
    drv.release()
    ref = drv.run_reference()
    numbers = check.compare(program, ref, cell.cfg["classifier"])
    raw = {"program": program.as_dict(), "reference": ref.as_dict()} if keep_raw else {}
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return {"workload": name, "seed": seed, "side": side, "card": card,
            "seconds": time.perf_counter() - t0, **numbers, **raw}


def limits(name: str, rows: List[dict]) -> dict:
    """A cell's limits from its readings. For each number: the lower
    reading is the program's largest over its seeds; the upper the least,
    over the control and the faults, of a side's smallest reading where
    that lies far enough above the lower (3 times for the control and
    the frozen state, 10 times for the half batch); the limit
    lower^(1/3) · upper^(2/3), to two significant digits. A number with
    no upper reading is not compared, and is kept with its readings."""
    by: dict = {}
    for r in rows:
        by.setdefault(r["side"], []).append(r)
    numbers = [k for k in by["program"][0]
               if k not in ("workload", "seed", "side", "card", "seconds", "program", "reference")]
    out: dict = {"cell": name, "limits": {}, "readings": {}, "not_compared": {}}
    for k in numbers:
        lower = max(r[k] for r in by["program"] if k in r)
        entry = {"lower": lower,
                 "lower_seeds": sorted({r["seed"] for r in by["program"] if k in r})}
        entry.update({f"{side}_min": min(r[k] for r in by[side] if k in r) for side in by})
        ups = {side: entry[f"{side}_min"] for side in APART
               if side in by and entry[f"{side}_min"] >= APART[side] * lower}
        if ups:
            side = min(ups, key=ups.get)
            limit = float(f"{lower ** (1 / 3) * ups[side] ** (2 / 3):.2g}")
            entry.update(upper=ups[side], upper_from=side, limit=limit)
            out["limits"][k] = limit
            out["readings"][k] = entry
        else:
            out["not_compared"][k] = entry
    out["seeds"] = {side: sorted({r["seed"] for r in by[side]}) for side in by if side != "program"}
    out["card"] = sorted({r.get("card", "?") for r in rows})
    out["how"] = " ".join(limits.__doc__.split())
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--frozen-seeds", type=int, nargs="*", default=[])
    p.add_argument("--raw", action="store_true", help="add both sides' readings by leaf")
    p.add_argument("--out")
    p.add_argument("--limits-from", help="write the cell's limits from these readings")
    args = p.parse_args(argv)
    if args.limits_from:
        with open(args.limits_from) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        cell = limits(args.workload, [r for r in rows if r["workload"] == args.workload])
        path = Path(__file__).resolve().parent / "workloads" / f"{args.workload}.json"
        path.write_text(json.dumps(cell, indent=1) + "\n")
        print(json.dumps(cell["limits"]))
        return 0
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = spec_of()
    plan = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, "half_batch") for s in args.fault_seeds]
            + [(s, "frozen_state") for s in args.frozen_seeds])
    for seed, side in plan:
        line = json.dumps(reading(spec, args.workload, seed, side, device, keep_raw=args.raw))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
