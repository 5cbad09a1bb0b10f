"""Per-sample metadata generators (``dct_tpu/data/metainfo.py``): class
pixel counts, and the pass-through of the un-augmented pair. The datasets
take ``metainfo=`` and ignore it, as dct_tpu's do; these exist for the
class-size statistics and the API."""
from __future__ import annotations

from typing import Sequence

import numpy as np


class classSizeCalulator:
    """Class pixel counts of one label map: (C,) int64 (the reference's
    spelling of the name)."""

    def __init__(self, C: int, foldernames: Sequence[str] = ("gt",)) -> None:
        self.C = C
        self.foldernames = list(foldernames)

    def __call__(self, gt) -> np.ndarray:
        gt = np.asarray(gt)
        return np.bincount(gt.reshape(-1).astype(np.int64),
                           minlength=self.C)[:self.C]


class getImage_GT:
    """The un-augmented (img, gt) pair, passed through."""

    def __init__(self, foldernames: Sequence[str] = ("img", "gt")) -> None:
        self.foldernames = list(foldernames)

    def __call__(self, x):
        return x


def get_metainfo_generator(name: str, **kwargs):
    registry = {"classSizeCalulator": classSizeCalulator,
                "getImage_GT": getImage_GT}
    return registry[name](**kwargs)
