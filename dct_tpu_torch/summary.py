"""Ensemble evaluation of a co-training run (the root ``summary.py`` of
dct_tpu), on the card:

    python -m dct_tpu_torch.summary --input_dir runs/exp [--device cuda|cpu]
        [--ensemble_method soft|hard] [--dataset_root path]
        [--axises 1 2 3] [--patient_info patient_info.csv]

It loads every ``best_*.ckpt`` of the run directory (else ``best.ckpt``)
and the run's ``config.yml``, runs the val set patient by patient through
``train/steps.py:make_summary_step`` and reports, as dct_tpu does:

* per-model and ensemble (soft or hard vote) 2D dice per slice and 3D dice
  per patient;
* the Hausdorff distance per patient, on the host with scipy's distance
  transform over the masks' bounding box, the voxel spacing from the headerless ``patient_info.csv``
  (``patientXXX,<spacing>``) looked up by the patient name's first
  ``_``-separated part;
* each model's Cohen kappa against the ensemble vote on the considered
  classes (``metrics.py``).

It writes the files, names, headers, row labels and number formats of
dct_tpu's: ``summary.csv`` (2D), ``bsummary.csv`` (3D and Hausdorff),
``div.csv`` (kappa), ``summary_std.csv``, ``bsummary_std.csv`` (``%.4f``),
``log_{2D,3D}dice_{ensemble,model_s}.csv`` (float32 values unformatted),
and the class maps as PNGs under ``iter1000/val/<s>`` and ``voting``. The
CSVs go through the standard library's ``csv``; pandas is not needed.
``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import csv
import sys
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import resolve_device
from .checkpoint import load_checkpoint
from .cli import grp_regex
from .config import load_yaml
from .data.dataset import MedicalImageDataset
from .data.pipeline import DeviceDataset, PatientBuckets
from .data.splits import get_gmc_split_datasets
from .metrics import KappaMetrics
from .models import Segmentator
from .train.steps import make_summary_step
from .utils.general import save_images
from .utils.logging import format_4f, format_float32, write_rows


def hausdorff_distance(a: np.ndarray, b: np.ndarray, spacing=None) -> float:
    """Symmetric Hausdorff distance between two binary masks (2D or 3D),
    from distance transforms: 0 when both are empty, NaN when one is.

    The transforms run on the bounding box of a ∪ b: every point of either
    mask lies inside it, so each point's nearest point of the other mask,
    and its distance, are those of the whole volume (the root
    ``summary.py`` transforms the whole volume; a 16×256² val volume's
    masks fill a few percent of it)."""
    from scipy.ndimage import distance_transform_edt

    a = a.astype(bool)
    b = b.astype(bool)
    if not a.any() and not b.any():
        return 0.0
    if not a.any() or not b.any():
        return float("nan")
    box = tuple(slice(int(ix.min()), int(ix.max()) + 1) for ix in np.nonzero(a | b))
    a, b = a[box], b[box]
    dt_b = distance_transform_edt(~b, sampling=spacing)
    dt_a = distance_transform_edt(~a, sampling=spacing)
    return float(max(dt_b[a].max(), dt_a[b].max()))


def _nanmean(values) -> float:
    """numpy's nanmean, quiet when every value is NaN (→ NaN)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(np.asarray(values))


def _write_indexed(path: Path, index_label: str, table: Dict[str, Dict[str, float]]) -> None:
    """{row label: {column: value}} → pandas' ``to_csv(float_format="%.4f")``
    layout, index first."""
    columns = list(next(iter(table.values())))
    write_rows(path, [index_label, *columns],
               [[label] + [format_4f(row[c]) for c in columns] for label, row in table.items()])


def _write_log(path: Path, values: np.ndarray) -> None:
    """A (rows, C) float32 array as pandas writes its DataFrame with no
    float format: a 0..C-1 header, a 0.. index."""
    write_rows(path, ["", *map(str, range(values.shape[1]))],
               [[str(i)] + [format_float32(v) for v in row] for i, row in enumerate(values)])


def _with_mean(rows: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """The table plus a ``mean`` row: each column's mean, NaN skipped."""
    columns = list(next(iter(rows.values())))
    return {**rows, "mean": {c: _nanmean([r[c] for r in rows.values()]) for c in columns}}


def _read_spacings(path: Path) -> Dict[str, float]:
    with open(path, newline="") as f:
        return {row[0]: float(row[1]) for row in csv.reader(f) if row}


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--ensemble_method", default="soft", choices=["soft", "hard"])
    parser.add_argument("--dataset_root", default=None,
                        help="override Dataset.root_dir from the run config")
    parser.add_argument("--axises", "--kappa_considered_class", dest="axises",
                        nargs="+", type=int, default=[1, 2, 3])
    parser.add_argument("--patient_info", default=None,
                        help="csv with per-patient voxel spacing for Hausdorff")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the current card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    run_dir = Path(args.input_dir)
    config = load_yaml(run_dir / "config.yml")
    ckpts = sorted(run_dir.glob("best_*.ckpt")) or sorted(run_dir.glob("best.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no best checkpoints under {run_dir}")
    print(f"found {len(ckpts)} checkpoints: {[c.name for c in ckpts]}")

    ds_cfg = dict(config["Dataset"])
    root = args.dataset_root or ds_cfg.pop("root_dir")
    ds_cfg.pop("root_dir", None)
    if ds_cfg.pop("name", None) == "gm":
        # GM has no val/ folder: its val set is the site3/site4 part of train
        cfg = {**config, "Dataset": {**config["Dataset"], "root_dir": root}}
        _, _, val_set = get_gmc_split_datasets(cfg)
    else:
        val_set = MedicalImageDataset(root, "val", **{**ds_cfg, "quite": True})

    segs = []
    for p in ckpts:
        sd = load_checkpoint(p)["segmentator"]
        sd.setdefault("scheduler_state_dict", {"epoch": 0})
        segs.append(Segmentator.from_state_dict(sd, device=device, in_channels=1))
    C = int(segs[0].arch_dict["num_classes"])
    K = len(segs)

    buckets = PatientBuckets(val_set, grp_regex(config, "Lab_Dataloader"))
    dev = DeviceDataset(val_set, device)
    info_path = Path(args.patient_info or Path(root, "patient_info.csv"))
    spacing_by_patient = _read_spacings(info_path) if info_path.exists() else {}

    out = make_summary_step(segs, C, args.ensemble_method)(
        dev.img, dev.gt, buckets.indices, buckets.mask)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    preds, ens_preds = out["pred"], out["ens"]              # uint8
    dice2d, dice3d = out["dice2d"], out["dice3d"]           # (P,K,L,C), (P,K,C)
    ens_dice2d, ens_dice3d = out["ens_dice2d"], out["ens_dice3d"]

    kappa_meter = KappaMetrics()
    rows2d, rows3d = {}, {}
    logs2d: List[List[np.ndarray]] = [[] for _ in range(K + 1)]
    for p, name in enumerate(buckets.patients):
        mask = buckets.mask[p]
        idx = buckets.indices[p][mask]
        gt = val_set.data["gt"][idx].astype(np.int64)
        model_preds = preds[p][:, mask]                      # (K,L,H,W)
        ens = ens_preds[p][mask]
        kappa_meter.add(list(model_preds), ens, considered_classes=args.axises)

        slice_names = [val_set.filenames[i] for i in idx]
        for s in range(K):
            save_images(model_preds[s], slice_names, run_dir, "val", 1000, str(s))
            logs2d[s].append(dice2d[p, s][mask])
        save_images(ens, slice_names, run_dir, "val", 1000, "voting")
        logs2d[K].append(ens_dice2d[p][mask])

        spacing = spacing_by_patient.get(name.split("_")[0])
        row2d, row3d = {}, {}
        for s in range(K):
            for i in args.axises:
                row2d[f"S{s}_DSC{i}"] = dice2d[p, s][mask, i].mean()
                row3d[f"S{s}_DSC{i}"] = dice3d[p, s, i]
            row3d[f"S{s}_HD"] = _nanmean([
                hausdorff_distance(model_preds[s] == i, gt == i, spacing)
                for i in args.axises])
        for i in args.axises:
            row2d[f"ens_DSC{i}"] = ens_dice2d[p][mask, i].mean()
            row3d[f"ens_DSC{i}"] = ens_dice3d[p, i]
        row3d["ens_HD"] = _nanmean([hausdorff_distance(ens == i, gt == i, spacing)
                                    for i in args.axises])
        rows2d[name], rows3d[name] = row2d, row3d
        print(f"  {name}: ens 3D fg dice "
              f"{np.mean([ens_dice3d[p, i] for i in args.axises]):.4f}")

    summary, bsummary = _with_mean(rows2d), _with_mean(rows3d)
    div = kappa_meter.summary()
    _write_indexed(run_dir / "summary.csv", "patient", summary)
    _write_indexed(run_dir / "bsummary.csv", "patient", bsummary)
    write_rows(run_dir / "div.csv", list(div), [[format_4f(v) for v in div.values()]])

    # the std tables and the raw per-slice / per-patient dice logs
    all2d = [np.concatenate(logs2d[i], axis=0) for i in range(K + 1)]   # (ΣL,C)
    names2d = {"ensemble": all2d[K], **{f"model_{s}": all2d[s] for s in range(K)}}
    names3d = {"ensemble": ens_dice3d, **{f"model_{s}": dice3d[:, s] for s in range(K)}}
    summary_std, bsummary_std = ({f"DSC{c}": {nm: v[:, c].std() for nm, v in table.items()}
                                  for c in range(C)} for table in (names2d, names3d))
    _write_indexed(run_dir / "summary_std.csv", "", summary_std)
    _write_indexed(run_dir / "bsummary_std.csv", "", bsummary_std)
    for nm in names2d:
        _write_log(run_dir / f"log_2Ddice_{nm}.csv", names2d[nm])
        _write_log(run_dir / f"log_3Ddice_{nm}.csv", names3d[nm])
    print(f"wrote {run_dir}/summary.csv, bsummary.csv, div.csv, *_std.csv, "
          f"log_{{2,3}}Ddice_*.csv, iter1000/val PNGs")
    print("  ".join(f"{c} {format_4f(v)}" for c, v in bsummary["mean"].items()))
    return {"summary": summary, "bsummary": bsummary, "div": div,
            "summary_std": summary_std, "bsummary_std": bsummary_std}


if __name__ == "__main__":
    main(sys.argv[1:])
