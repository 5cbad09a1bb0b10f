"""PNG-tree medical dataset, preloaded to packed uint8 arrays
(``dct_tpu/data/dataset.py``).

The whole ``root/mode/<sub>/*.png`` tree is decoded once into packed uint8
numpy arrays, later uploaded to the device in one transfer
(``data/pipeline.py:DeviceDataset``). Normalisation and augmentation happen
on the device.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image, ImageOps

DATASET_MODES = ["train", "val", "test", "unlabeled"]
ALLOWED_EXTENSIONS = {".jpg", ".png"}


def parse_transform_size(transform: Union[str, Tuple[int, int], None],
                         default: Tuple[int, int] = (256, 256)) -> Tuple[int, int]:
    """The target size in a config string such as
    ``"segment_transform((256,256))"``, without eval."""
    if transform is None:
        return default
    if isinstance(transform, (tuple, list)):
        return int(transform[0]), int(transform[1])
    m = re.search(r"\((\d+)\s*,\s*(\d+)\)", transform)
    if not m:
        raise ValueError(f"cannot parse transform size from {transform!r}")
    return int(m.group(1)), int(m.group(2))


def _scan_tree(root: Union[str, Path], mode: str,
               subfolders: Sequence[str]) -> Dict[str, List[Path]]:
    """List and sort the images per subfolder, asserting equal counts."""
    assert mode in DATASET_MODES, mode
    files: Dict[str, List[Path]] = {}
    for sub in subfolders:
        d = Path(root, mode, sub)
        assert d.exists(), f"missing dataset folder {d}"
        files[sub] = sorted(p for p in d.iterdir() if p.suffix in ALLOWED_EXTENSIONS)
    counts = {len(v) for v in files.values()}
    assert len(counts) == 1, {k: len(v) for k, v in files.items()}
    return files


class MedicalImageDataset:
    """Packed-array dataset.

    Attributes:
      data:      {subfolder: uint8 (N,H,W)}: 'img' bilinear-resized,
                 'gt' (and any other mask folder) nearest-resized.
      filenames: list of N file stems (used by the patient sampler/regex).
    """

    def __init__(self, root_dir: Union[str, Path], mode: str,
                 subfolders: Sequence[str] = ("img", "gt"),
                 transform: Union[str, Tuple[int, int], None] = None,
                 augment: Optional[str] = None,
                 equalize: Union[str, Sequence[str], None] = None,
                 pin_memory: bool = True, metainfo=None, quite: bool = False,
                 **_ignored) -> None:
        assert len(set(subfolders)) == len(subfolders), subfolders
        self.root_dir = str(root_dir)
        self.mode = mode
        self.name = f"{mode}_dataset"
        self.subfolders = list(subfolders)
        self.size = parse_transform_size(transform)
        self.augment = augment          # recorded for config parity; applied on device
        self.equalize = equalize
        files = _scan_tree(root_dir, mode, subfolders)
        self.filenames: List[str] = [p.stem for p in files[self.subfolders[0]]]
        for sub in self.subfolders[1:]:
            assert [p.stem for p in files[sub]] == self.filenames, \
                f"filename mismatch between {self.subfolders[0]} and {sub}"
        if not quite:
            print(f"->> Building {self.name}: {len(self.filenames)} images "
                  f"per subfolder {self.subfolders}")
        self.data: Dict[str, np.ndarray] = {
            sub: self._load_stack(files[sub], is_mask=(sub != "img"),
                                  equalize=self._want_equalize(sub))
            for sub in self.subfolders
        }

    def _want_equalize(self, sub: str) -> bool:
        if self.equalize is None:
            return False
        eq = [self.equalize] if isinstance(self.equalize, str) else list(self.equalize)
        return sub in eq

    def _load_stack(self, paths: Sequence[Path], is_mask: bool,
                    equalize: bool) -> np.ndarray:
        h, w = self.size
        out = np.empty((len(paths), h, w), np.uint8)
        resample = Image.NEAREST if is_mask else Image.BILINEAR
        for i, p in enumerate(paths):
            img = Image.open(p).convert("L")
            if equalize:
                img = ImageOps.equalize(img)
            if img.size != (w, h):
                img = img.resize((w, h), resample)
            out[i] = np.asarray(img, np.uint8)
        return out

    def __len__(self) -> int:
        return len(self.filenames)

    def patient_of(self, grp_regex: str) -> List[str]:
        pattern = re.compile(grp_regex)
        groups = []
        for stem in self.filenames:
            m = pattern.match(stem)
            assert m, f"{stem} does not match {grp_regex}"
            groups.append(m.group(1))
        return groups

    def subset(self, indices: Sequence[int]) -> "MedicalImageDataset":
        """A filtered shallow copy (shares no arrays with the parent)."""
        new = object.__new__(MedicalImageDataset)
        new.__dict__.update({k: v for k, v in self.__dict__.items()
                             if k not in ("data", "filenames")})
        idx = np.asarray(indices, np.int64)
        new.filenames = [self.filenames[i] for i in idx]
        new.data = {k: v[idx].copy() for k, v in self.data.items()}
        return new

    def filter_by_patterns(self, patterns: Sequence[str]) -> "MedicalImageDataset":
        """Keep files whose stem matches any pattern (regex search)."""
        joint = re.compile("|".join(patterns))
        keep = [i for i, s in enumerate(self.filenames) if joint.search(s)]
        return self.subset(keep)


class ConcatDataset:
    """Zip-style multi-dataset."""

    def __init__(self, *datasets) -> None:
        self.datasets = datasets

    def __getitem__(self, i: int):
        return tuple(d[i] for d in self.datasets)

    def __len__(self) -> int:
        return min(len(d) for d in self.datasets)
