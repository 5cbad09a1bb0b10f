"""Cohen's kappa diversity of the ensemble evaluation
(``dct_tpu/metrics.py:cohen_kappa``, ``KappaMetrics``, ``Kappa2Annotator``),
the streaming confusion matrix and IoU of the Cityscapes trainers
(``dct_tpu/metrics.py:ConfusionMatrix``, ``IoU``;
``dct_tpu/train/city.py:iou_from_confusion``), and dct_tpu's host meters
(``AverageValueMeter``, ``DiceMeter``, ``AggregatedMeter``,
``ListAggregatedMeter``). The two aggregated meters return pandas
DataFrames, as dct_tpu's do; pandas is imported inside those methods only,
so nothing else here needs it.

Kappa: plain host functions on class maps given as numpy arrays or tensors. They
keep dct_tpu's semantics, quirks included: the classes are the unique
values of both inputs together; fewer than two classes give NaN for empty
input and 1.0 otherwise; ``pe == 1`` gives 1.0; and ``KappaMetrics.add``
keeps the pixels whose *target* (the ensemble vote) is a considered class,
so with one considered class a model scores exactly 0.0 unless it agrees
everywhere.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def _flat(y) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().flatten()
    return torch.from_numpy(np.ascontiguousarray(y)).flatten()


def cohen_kappa(y1, y2) -> float:
    a, b = _flat(y1), _flat(y2)
    dtype = torch.promote_types(a.dtype, b.dtype)
    classes, inverse = torch.unique(torch.cat([a.to(dtype), b.to(dtype)]),
                                    return_inverse=True)
    if classes.numel() < 2:
        return math.nan if a.numel() == 0 else 1.0
    k = classes.numel()
    ia, ib = inverse[:a.numel()], inverse[a.numel():]
    conf = torch.bincount(ia * k + ib, minlength=k * k).reshape(k, k).double()
    n = conf.sum()
    po = conf.diagonal().sum() / n
    pe = (conf.sum(0) * conf.sum(1)).sum() / (n * n)
    if float(pe) == 1.0:
        return 1.0
    return float((po - pe) / (1 - pe))


class KappaMetrics:
    """Per-model kappa against the ensemble vote on the pixels whose vote
    is a considered class, one row per patient."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.kappa: List[List[float]] = []

    def add(self, predicts: Sequence, target, considered_classes: Sequence[int]) -> None:
        tgt = _flat(target)
        mask = torch.isin(tgt, torch.as_tensor(list(considered_classes), dtype=tgt.dtype))
        self.kappa.append([cohen_kappa(_flat(p)[mask], tgt[mask]) for p in predicts])

    def value(self) -> np.ndarray:
        """The nanmean over patients, per model."""
        return torch.nanmean(torch.tensor(self.kappa, dtype=torch.float64), dim=0).numpy()

    def summary(self) -> Dict[str, float]:
        v = self.value()
        return {f"kappa{i}": float(v[i]) for i in range(len(v))}


def iou_from_confusion(hist: np.ndarray) -> Dict[str, np.ndarray]:
    """Overall and mean class accuracy, frequency-weighted accuracy, the
    IoU of each class and their ``nanmean`` from a (C,C) confusion matrix
    (rows ground truth, columns prediction). A class absent from both
    gives NaN and is left out of the mean, as in dct_tpu."""
    hist = np.asarray(hist).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(1))
        iu = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
        freq = hist.sum(1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return {"Overall_Acc": acc, "Mean_Acc": acc_cls, "FreqW_Acc": fwavacc,
            "Mean_IoU": np.nanmean(iu), "Class_IoU": iu}


class ConfusionMatrix:
    """(C,C) int64 counts, rows ground truth, columns prediction; targets
    outside [0, C) or equal to ``ignore_index`` are dropped."""

    def __init__(self, num_classes: int, normalized: bool = False,
                 ignore_index: Optional[int] = 255) -> None:
        self.num_classes = num_classes
        self.normalized = normalized
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def add(self, predicted, target) -> None:
        p, t = _flat(predicted).numpy(), _flat(target).numpy()
        assert p.shape == t.shape, (p.shape, t.shape)
        keep = (t >= 0) & (t < self.num_classes)
        if self.ignore_index is not None:
            keep &= t != self.ignore_index
        idx = t[keep].astype(np.int64) * self.num_classes + p[keep]
        self.conf += np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

    def value(self) -> np.ndarray:
        if self.normalized:
            conf = self.conf.astype(np.float64)
            return conf / np.maximum(conf.sum(axis=1, keepdims=True), 1e-12)
        return self.conf


class IoU:
    """Streaming IoU over a ConfusionMatrix: ``add`` takes (N,H,W) class maps
    or (N,H,W,C) scores and (N,H,W) targets."""

    def __init__(self, num_classes: int, normalized: bool = False,
                 ignore_index: Optional[int] = 255) -> None:
        self.conf_metric = ConfusionMatrix(num_classes, normalized, ignore_index)

    def reset(self) -> None:
        self.conf_metric.reset()

    def add(self, predicted, target) -> None:
        p = predicted.detach().cpu() if isinstance(predicted, torch.Tensor) else np.asarray(predicted)
        if p.ndim == 4:
            p = p.argmax(-1)
        self.conf_metric.add(p, target)

    def value(self) -> Dict[str, np.ndarray]:
        """``iou_from_confusion``'s keys and ``Validated_Mean_IoU``, the mean
        over the classes present in the targets."""
        out = iou_from_confusion(self.conf_metric.value())
        valid = self.conf_metric.value().sum(axis=1) > 0
        with np.errstate(invalid="ignore"):
            out["Validated_Mean_IoU"] = (np.nanmean(out["Class_IoU"][valid])
                                         if valid.any() else np.nan)
        return out


class Kappa2Annotator:
    """Pairwise kappa between two models' maps, on the pixels whose ground
    truth is a considered class (all pixels when ``considered_classes`` is
    None); ``value()`` is the mean over the ``add`` calls."""

    def __init__(self) -> None:
        self.kappa: List[float] = []

    def reset(self) -> None:
        self.kappa = []

    def add(self, predict1, predict2, gt, considered_classes=(1, 2, 3)) -> None:
        p1, p2 = _flat(predict1), _flat(predict2)
        if considered_classes is not None:
            g = _flat(gt)
            mask = torch.isin(g, torch.as_tensor(list(considered_classes), dtype=g.dtype))
            p1, p2 = p1[mask], p2[mask]
        self.kappa.append(cohen_kappa(p1, p2))

    def value(self) -> float:
        return float(np.mean(self.kappa))


class AverageValueMeter:
    """Streaming mean and (population) standard deviation of weighted
    scalars: ``add(value, n)`` counts ``value`` ``n`` times; ``value()`` →
    (mean, std), NaNs before the first ``add``."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.sum = 0.0
        self.var = 0.0

    def add(self, value: float, n: int = 1) -> None:
        value = float(value)
        self.n += n
        self.sum += value * n
        self.var += value * value * n

    def value(self):
        if self.n == 0:
            return np.nan, np.nan
        mean = self.sum / self.n
        std = np.sqrt(max(self.var / self.n - mean * mean, 0.0))
        return mean, std


class DiceMeter:
    """Accumulates dice rows on the host: ``method="2d"`` takes (B,C) rows of
    per-slice dice an ``add``, ``"3d"`` one (C,) row of a volume. ``value()``
    → ((mean, std) of the rows' mean over ``report_axises`` (all classes
    by default), (per-class means, per-class stds))."""

    def __init__(self, method: str = "2d", report_axises: Union[str, List[int]] = "all",
                 C: int = 4) -> None:
        assert method in ("2d", "3d")
        assert report_axises == "all" or isinstance(report_axises, list)
        self.method = method
        self.report_axis = report_axises
        self.C = C
        self.reset()

    def reset(self) -> None:
        self._log: List[np.ndarray] = []

    def add(self, dice_values) -> None:
        if isinstance(dice_values, torch.Tensor):
            dice_values = dice_values.detach().cpu().numpy()
        d = np.asarray(dice_values, dtype=np.float32)
        if d.ndim == 1:
            d = d[None, :]
        assert d.ndim == 2 and d.shape[1] == self.C, d.shape
        self._log.append(d)

    @property
    def log(self) -> np.ndarray:
        if not self._log:
            return np.zeros((1, self.C), np.float32)
        return np.concatenate(self._log, axis=0)

    def value(self):
        log = self.log
        means = log.mean(0)
        stds = log.std(0)
        if self.report_axis == "all":
            report = log.mean(1)
        else:
            report = log[:, self.report_axis].mean(1)
        return (report.mean(), report.std()), (means, stds)

    def summary(self, detailed: bool = False) -> Dict[str, float]:
        """{"mDSC", "mVars"}, or with ``detailed`` {"mDSC", "DSC<i>" for the
        reported classes}."""
        (mean, std), (cls_means, _) = self.value()
        if detailed:
            axes = range(self.C) if self.report_axis == "all" else self.report_axis
            return {"mDSC": float(mean), **{f"DSC{i}": float(cls_means[i]) for i in axes}}
        return {"mDSC": float(mean), "mVars": float(std)}

    def detailed_summary(self) -> Dict[str, float]:
        _, (means, _) = self.value()
        return {f"DSC{i}": float(means[i]) for i in range(len(means))}


class AggregatedMeter:
    """One summary dict per epoch; ``summary()`` → a pandas DataFrame."""

    def __init__(self) -> None:
        self.record: List[Dict[str, float]] = []

    def add(self, summary: Dict[str, float]) -> None:
        self.record.append(dict(summary))

    def summary(self):
        import pandas as pd
        return pd.DataFrame(self.record)

    def state_dict(self) -> Dict:
        return {"record": self.record}

    def load_state_dict(self, sd: Dict) -> None:
        self.record = list(sd["record"])


class ListAggregatedMeter:
    """Several AggregatedMeters side by side, their columns prefixed by each
    meter's name; ``to_csv`` writes them with an ``epoch`` index and four
    decimals."""

    def __init__(self, names: List[str], meters: List[AggregatedMeter]) -> None:
        assert len(names) == len(meters)
        self.names = names
        self.meters = meters

    def summary(self):
        import pandas as pd
        frames = []
        for name, meter in zip(self.names, self.meters):
            df = meter.summary()
            df.columns = [f"{name}_{c}" for c in df.columns]
            frames.append(df)
        return pd.concat(frames, axis=1)

    def to_csv(self, path) -> None:
        self.summary().to_csv(path, index_label="epoch", float_format="%.4f")

    def state_dict(self) -> Dict:
        return {name: m.state_dict() for name, m in zip(self.names, self.meters)}

    def load_state_dict(self, sd: Dict) -> None:
        for name, m in zip(self.names, self.meters):
            m.load_state_dict(sd[name])
