"""Cohen's kappa diversity of the ensemble evaluation
(``dct_tpu/metrics.py:cohen_kappa``, ``KappaMetrics``).

Plain host functions on class maps given as numpy arrays or tensors. They
keep dct_tpu's semantics, quirks included: the classes are the unique
values of both inputs together; fewer than two classes give NaN for empty
input and 1.0 otherwise; ``pe == 1`` gives 1.0; and ``KappaMetrics.add``
keeps the pixels whose *target* (the ensemble vote) is a considered class,
so with one considered class a model scores exactly 0.0 unless it agrees
everywhere.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

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
