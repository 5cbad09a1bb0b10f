"""Synthetic PNG trees in the stem formats of the spleen, prostate and GM
datasets, shared by ``test_torch_splits.py`` and ``test_torch_summary.py``.
It holds no test of its own.

Each slice is a set of concentric rings (gt) at a random centre and a noisy
rendering of them (img), as ``tests/helpers.py:make_synthetic_acdc`` draws
ACDC's; the stems follow each dataset's slicer:

* spleen: ``Patient_PP_00_0_S`` (``(Patient_\\d+)_\\d+`` groups
  ``Patient_PP``), patients numbered from 1, two digits at least;
* prostate: ``CaseCC_0_SS`` (``(Case\\d+_\\d+)_\\d+`` groups ``CaseCC_0``);
* GM: ``siteN-scNN-image_S`` (``(site\\d-sc\\d\\d)-image_\\d+``), the
  labeled sites under ``train`` and an ``unlabeled`` folder, each with the
  ``img`` and ``gt`` subfolders the dataset reads.

``write_city_tree`` writes a Cityscapes tree instead (``leftImg8bit`` RGB
and ``gtFine`` raw label ids, void ids included), for the Cityscapes tests.
"""
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np
from PIL import Image


def write_tree(root: Path, layout: Dict[str, List[str]], size: int = 32,
               n_classes: int = 2, seed: int = 0) -> Path:
    """root/<mode>/{img,gt}/<stem>.png for each mode's stems."""
    rs = np.random.RandomState(seed)
    root = Path(root)
    yy, xx = np.mgrid[0:size, 0:size]
    for mode, stems in layout.items():
        for sub in ("img", "gt"):
            (root / mode / sub).mkdir(parents=True, exist_ok=True)
        for stem in stems:
            cy = size / 2 + rs.randint(-size // 8, size // 8 + 1)
            cx = size / 2 + rs.randint(-size // 8, size // 8 + 1)
            r = np.hypot(yy - cy, xx - cx)
            gt = np.zeros((size, size), np.uint8)
            for c in range(1, n_classes):
                gt[r < size * (0.4 - 0.1 * (c - 1))] = c
            img = (gt.astype(np.float32) / (n_classes - 1) * 180
                   + rs.randn(size, size) * 12 + 40).clip(0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / mode / "img" / f"{stem}.png")
            Image.fromarray(gt).save(root / mode / "gt" / f"{stem}.png")
    return root


def _slices(stem_of, ids: Iterable[int], counts) -> List[str]:
    ids = list(ids)
    counts = [counts] * len(ids) if isinstance(counts, int) else list(counts)
    return [stem_of(i, s) for i, n in zip(ids, counts) for s in range(n)]


def spleen_layout(train: Iterable[int], val: Iterable[int], slices=2,
                  val_slices=2) -> Dict[str, List[str]]:
    def stem(p, s):
        return f"Patient_{p:02d}_00_0_{s}"
    return {"train": _slices(stem, train, slices), "val": _slices(stem, val, val_slices)}


def prostate_layout(train: Iterable[int], val: Iterable[int], slices=2,
                    val_slices=2) -> Dict[str, List[str]]:
    def stem(c, s):
        return f"Case{c:02d}_0_{s:02d}"
    return {"train": _slices(stem, train, slices), "val": _slices(stem, val, val_slices)}


def gm_layout(subjects: Dict[int, Iterable[int]], unlabeled: Dict[int, Iterable[int]],
              slices=2) -> Dict[str, List[str]]:
    """``subjects`` / ``unlabeled``: {site: subject numbers}."""
    def stems(by_site):
        return [f"site{site}-sc{sc:02d}-image_{s}" for site, scs in by_site.items()
                for sc in scs for s in range(slices)]
    return {"train": stems(subjects), "unlabeled": stems(unlabeled)}


# raw Cityscapes label ids the synthetic scenes use: road, sidewalk,
# building, vegetation, sky, person, car, bicycle, and the void ids 0, 1, 4
CITY_RAW_IDS = [7, 8, 11, 21, 23, 24, 26, 33, 0, 1, 4]


def write_city_tree(root: Path, cities=("aachen", "bochum", "bremen"),
                    counts=None, size=(40, 88), seed: int = 0) -> Path:
    """root/leftImg8bit/<mode>/<city>/<stem>_leftImg8bit.png and
    root/gtFine/<mode>/<city>/<stem>_gtFine_labelIds.png at ``size`` (H, W):
    horizontal bands of raw ids with a disc of another id, and an RGB
    rendering of them (one colour an id, plus noise). ``counts``: images a
    city for each mode (default: train 4, val 2)."""
    rs = np.random.RandomState(seed)
    root = Path(root)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    palette = rs.randint(0, 256, (256, 3))
    for mode, n in (counts or {"train": 4, "val": 2}).items():
        for city in cities:
            img_dir = root / "leftImg8bit" / mode / city
            gt_dir = root / "gtFine" / mode / city
            img_dir.mkdir(parents=True, exist_ok=True)
            gt_dir.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                bands = rs.choice(CITY_RAW_IDS, 4)
                raw = bands[np.minimum(yy * 4 // h + (xx * rs.randint(0, 3) // w), 3)]
                cy, cx, r = rs.randint(0, h), rs.randint(0, w), rs.randint(h // 6, h // 3)
                raw[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rs.choice(CITY_RAW_IDS)
                img = (palette[raw] + rs.randn(h, w, 3) * 20).clip(0, 255)
                stem = f"{city}_{i:06d}_000019"
                Image.fromarray(img.astype(np.uint8)).save(img_dir / f"{stem}_leftImg8bit.png")
                Image.fromarray(raw.astype(np.uint8)).save(gt_dir / f"{stem}_gtFine_labelIds.png")
    return root
