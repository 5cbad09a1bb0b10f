"""Learning curves from the trainers' metric CSVs or ``.npy`` dumps
(``dct_tpu/postprocessing/plot.py``). matplotlib is imported inside the
function, and the CSV is read with the standard library (dct_tpu reads it
with pandas): the first column is the index (the epoch), empty fields are
NaN.

    python -m dct_tpu_torch.postprocessing.plot --folders <run> [<run> ...] \\
        [--file metrics.csv] [--columns ...] [--out curves.png] [--smooth 1]
"""
from __future__ import annotations

import argparse
import csv
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _number(v: str):
    """A CSV field as pandas parses a numeric column's entry."""
    try:
        return int(v)
    except ValueError:
        return float(v) if v != "" else math.nan


def read_table(path: Path) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(index, {column: float64 values}) of a metrics CSV (first column the
    index) or of an ``.npy`` array (its rows; columns "0", "1", …)."""
    if path.suffix == ".csv":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        index = np.array([_number(r[0]) for r in body])
        return index, {name: np.array([_number(r[j]) for r in body], dtype=np.float64)
                       for j, name in enumerate(header) if j > 0}
    arr = np.load(path)
    arr = arr.reshape(arr.shape[0], -1)
    return np.arange(arr.shape[0]), {str(j): arr[:, j] for j in range(arr.shape[1])}


def rolling_mean(y: np.ndarray, window: int) -> np.ndarray:
    """Trailing mean over ``window`` values, NaNs skipped, from the first
    value on (pandas' ``rolling(window, min_periods=1).mean()``)."""
    out = np.empty(len(y), dtype=np.float64)
    for i in range(len(y)):
        w = y[max(0, i - window + 1):i + 1]
        w = w[~np.isnan(w)]
        out[i] = w.mean() if w.size else math.nan
    return out


def plot_learning_curves(folders: Sequence[str], file: str = "metrics.csv",
                         columns: Optional[List[str]] = None,
                         out: Optional[str] = None, y_lim=None,
                         smooth: int = 1, show: bool = False):
    """One figure of the chosen columns (by default every column whose name
    holds "dice") of ``file`` in each folder, a colour a folder and a line
    style a column, saved to ``out`` (default
    ``<first folder>/learning_curves.png``); returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = ["c", "r", "g", "b", "m", "y", "k", "chartreuse", "coral"]
    fig, ax = plt.subplots(figsize=(8, 5))
    for folder, color in zip(folders, colors):
        path = Path(folder) / file
        assert path.exists(), path
        index, table = read_table(path)
        cols = columns or [c for c in table if "dice" in c.lower()]
        for i, col in enumerate(cols):
            if col not in table:
                continue
            y = rolling_mean(table[col], smooth) if smooth > 1 else table[col]
            ax.plot(index, y, color=color, linestyle=["-", "--", ":", "-."][i % 4],
                    label=f"{Path(folder).name}:{col}")
    ax.set_xlabel("epoch")
    ax.grid(True, alpha=0.3)
    if y_lim:
        ax.set_ylim(y_lim)
    ax.legend(fontsize=7)
    fig.tight_layout()
    out = out or str(Path(folders[0]) / "learning_curves.png")
    fig.savefig(out, dpi=120)
    if show:
        plt.show()
    plt.close(fig)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--folders", nargs="+", required=True)
    parser.add_argument("--file", default="metrics.csv")
    parser.add_argument("--columns", nargs="*", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--y_lim", nargs=2, type=float, default=None)
    parser.add_argument("--smooth", type=int, default=1)
    args = parser.parse_args(argv)
    return plot_learning_curves(args.folders, args.file, args.columns,
                                args.out, args.y_lim, args.smooth)


if __name__ == "__main__":
    main()
