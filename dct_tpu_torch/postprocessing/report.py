"""Rank runs by their ensemble CSVs (``dct_tpu/postprocessing/report.py``):

    python -m dct_tpu_torch.postprocessing.report --folder runs [--file bsummary.csv]

Walks ``folder/**/<file>`` (each run's ``bsummary.csv`` and the sibling
``div.csv`` that ``summary`` writes), ranks the runs by the mean of their
ensemble dice columns (``ens_DSC*``) and, separately, of their per-model
dice columns, both from the ``mean`` row, appends each run's mean kappa, and
writes ``ensemble_results.csv`` and ``mean_score_results.csv`` (``%.4f``)
in pandas' layout, with the standard library's ``csv``.
"""
from __future__ import annotations

import argparse
import csv
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..utils.logging import format_4f, write_rows

Table = Dict[str, Dict[str, float]]


def _read(path: Path, index_col: bool = True) -> Table:
    """A CSV as {row label: {column: value}} (NaN for an empty field); rows
    are labelled 0.. without an index column."""
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    start = 1 if index_col else 0
    return {(r[0] if index_col else str(i)):
            {c: float(v) if v != "" else math.nan for c, v in zip(header[start:], r[start:])}
            for i, r in enumerate(rows)}


def _mean(values: List[float]) -> float:
    """pandas' mean: NaN skipped, NaN when nothing is left."""
    kept = [v for v in values if not math.isnan(v)]
    return sum(kept) / len(kept) if kept else math.nan


def _scores(summary: Table, keep: Callable[[str], bool]) -> Dict[str, float]:
    """The ``mean`` row's columns that ``keep`` selects (each column's mean
    when there is no such row), and their mean as ``mean_score``."""
    columns = [c for c in next(iter(summary.values())) if keep(c)]
    if "mean" in summary:
        s = {c: summary["mean"][c] for c in columns}
    else:
        s = {c: _mean([row[c] for row in summary.values()]) for c in columns}
    s["mean_score"] = _mean(list(s.values()))
    return s


def aggregate_ensemble_results(folder: str, file: str = "bsummary.csv"
                               ) -> Dict[str, Table]:
    """{"ensemble": ..., "average": ...}, each {run: {column: value}} in rank
    order, with ``mean_score`` and ``kappa`` (NaN without a ``div.csv``)."""
    folder_path = Path(folder)
    if not folder_path.exists():
        raise FileNotFoundError(folder_path)
    file_list = sorted(folder_path.glob(f"**/{file}"))
    if not file_list:
        raise FileNotFoundError(f"no {file} under {folder}")

    # name each run by its parent directory when unique, else by its path
    if len({f.parent.name for f in file_list}) == len(file_list):
        name_dict = {f.parent.name: f for f in file_list}
    else:
        name_dict = {str(f): f for f in file_list}

    kappa = {}
    for name, path in name_dict.items():
        div_path = path.parent / "div.csv"
        if div_path.exists():
            kappa[name] = _mean(list(_read(div_path, index_col=False)["0"].values()))

    def build(keep: Callable[[str], bool]) -> Table:
        results = {name: _scores(_read(path), keep) for name, path in name_dict.items()}
        row_sets = [list(r) for r in results.values()]
        rows = row_sets[0] if all(r == row_sets[0] for r in row_sets) \
            else sorted(set().union(*row_sets))          # pandas' index union
        ranked = [n for n in results if not math.isnan(results[n]["mean_score"])]
        ranked.sort(key=lambda n: -results[n]["mean_score"])
        ranked += [n for n in results if math.isnan(results[n]["mean_score"])]
        return {n: {**{r: results[n].get(r, math.nan) for r in rows},
                    "kappa": kappa.get(n, math.nan)} for n in ranked}

    ensemble = build(lambda c: c.startswith("ens_DSC"))
    average = build(lambda c: "_DSC" in c and not c.startswith("ens"))
    for table, out_name in ((ensemble, "ensemble_results.csv"),
                            (average, "mean_score_results.csv")):
        columns = list(next(iter(table.values())))
        write_rows(folder_path / out_name, ["", *columns],
                   [[n] + [format_4f(row[c]) for c in columns] for n, row in table.items()])
    for title, table in (("Ensemble score", ensemble), ("Average score", average)):
        print(f"\n{title}:")
        for n, row in table.items():
            print(f"  {n}: " + " ".join(f"{c} {format_4f(v)}" for c, v in row.items()))
    return {"ensemble": ensemble, "average": average}


def main(argv: Optional[List[str]] = None) -> Dict[str, Table]:
    parser = argparse.ArgumentParser(description="aggregate run folders")
    parser.add_argument("--folder", type=str, required=True)
    parser.add_argument("--file", type=str, default="bsummary.csv")
    args = parser.parse_args(argv)
    return aggregate_ensemble_results(args.folder, args.file)


if __name__ == "__main__":
    main(sys.argv[1:])
