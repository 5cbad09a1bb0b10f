"""Run observability (``dct_tpu/utils/logging.py``): scalar writers and
the metrics CSV the trainers write and resume.

* ``ScalarWriter``: JSONL always; TensorBoard events too when
  ``torch.utils.tensorboard`` imports. Epoch granularity only.
* ``write_metrics_csv`` / ``resume_records``: the per-epoch CSV with the
  standard library's ``csv`` (no pandas), in pandas' ``to_csv(
  float_format="%.4f")`` layout: the ``epoch`` index first, floats with four
  decimals, NaN as an empty field.
* ``write_rows`` with ``format_4f`` or ``format_float32``: any other table
  in pandas' ``to_csv`` layout, with or without ``float_format="%.4f"``.
"""
from __future__ import annotations

import csv
import json
import math
from pathlib import Path
from typing import Dict, List, Sequence, Union

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
