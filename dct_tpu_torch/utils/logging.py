"""Run observability (``dct_tpu/utils/logging.py``): scalar writers, a
throughput meter, an on-demand profiler trace and the metrics CSV the
trainers write and resume.

* ``ScalarWriter``: JSONL always; TensorBoard events too when
  ``torch.utils.tensorboard`` imports. Epoch granularity only.
* ``RateMeter``: images/s with exponential smoothing.
* ``trace_epoch``: a ``torch.profiler`` trace of the wrapped code, written
  in the TensorBoard profiler's layout.
* ``write_metrics_csv`` / ``resume_records``: the per-epoch CSV with the
  standard library's ``csv`` (no pandas), in pandas' ``to_csv(
  float_format="%.4f")`` layout: the ``epoch`` index first, floats with four
  decimals, NaN as an empty field.
* ``write_rows`` with ``format_4f`` or ``format_float32``: any other table
  in pandas' ``to_csv`` layout, with or without ``float_format="%.4f"``.
"""
from __future__ import annotations

import contextlib
import csv
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class ScalarWriter:
    def __init__(self, logdir: Union[str, Path]) -> None:
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "scalars.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(str(self.logdir))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, main_tag: str, tag_scalar_dict: Dict[str, float],
                    step: int) -> None:
        for k, v in tag_scalar_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class RateMeter:
    """Streaming images/s with exponential smoothing: ``stop(n)`` returns
    the rate since ``start()`` and folds it into ``rate`` as
    ``alpha·rate + (1 − alpha)·instant`` (the first reading alone)."""

    def __init__(self, alpha: float = 0.9) -> None:
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_images: int) -> float:
        assert self._t0 is not None, "call start() first"
        dt = time.perf_counter() - self._t0
        inst = n_images / max(dt, 1e-9)
        self.rate = inst if self.rate is None else (
            self.alpha * self.rate + (1 - self.alpha) * inst)
        self._t0 = None
        return inst


@contextlib.contextmanager
def trace_epoch(logdir: Union[str, Path, None], device=None):
    """``with trace_epoch("runs/x/trace"): ...`` records a ``torch.profiler``
    trace of the wrapped code: CPU activity, and CUDA activity when
    ``device`` resolves to the card (``resolve_device``: the card unless the
    caller asks for the CPU). On exit the trace is written under ``logdir``
    as ``<worker>.<time>.pt.trace.json`` (``tensorboard_trace_handler``):
    view it with TensorBoard's profiler plugin (``tensorboard --logdir``) or
    open the JSON in Perfetto or ``chrome://tracing``. Yields the profiler
    (``key_averages()`` for a table). ``logdir`` None records nothing and
    yields None, as dct_tpu's context does."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from .. import resolve_device
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def format_4f(v: float) -> str:
    """A float as pandas writes it with ``float_format="%.4f"``."""
    v = float(v)
    return "" if math.isnan(v) else "%.4f" % v


def format_float32(v: float) -> str:
    """A float32 value as pandas writes it with no float format: the
    shortest repr of the float32 (``5.6179776e-11``, ``1.0``), NaN empty."""
    v = np.float32(v)
    return "" if np.isnan(v) else str(v)


def write_rows(path: Union[str, Path], header: Sequence[str],
               rows: Sequence[Sequence[str]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_metrics_csv(path: Union[str, Path], records: List[dict],
                      columns: Sequence[str]) -> None:
    """``records`` (dicts with an ``epoch`` key and float values) → a CSV
    of ``epoch`` and ``columns``."""
    write_rows(path, ["epoch", *columns],
               [[str(int(r["epoch"]))] + [format_4f(r.get(c, math.nan)) for c in columns]
                for r in records])


def resume_records(csv_path: Union[str, Path], start_epoch: int) -> list:
    """Rows (dicts with their absolute ``epoch``) of a prior run's metrics
    CSV before ``start_epoch``, so a resumed trainer appends to its history
    instead of restarting the CSV at epoch 0."""
    path = Path(csv_path)
    if start_epoch <= 0 or not path.exists():
        return []
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows or "epoch" not in rows[0]:
        return []
    out = []
    for row in rows:
        rec = {"epoch": int(row["epoch"])}
        for k, v in row.items():
            if k != "epoch":
                rec[k] = float(v) if v != "" else math.nan
        if rec["epoch"] < start_epoch:
            out.append(rec)
    return out
