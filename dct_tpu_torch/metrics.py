"""Cohen's kappa diversity of the ensemble evaluation
(``dct_tpu/metrics.py:cohen_kappa``, ``KappaMetrics``), and the streaming
confusion matrix and IoU of the Cityscapes trainers
(``dct_tpu/metrics.py:ConfusionMatrix``, ``IoU``;
``dct_tpu/train/city.py:iou_from_confusion``).

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
from typing import Dict, List, Optional, Sequence

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
