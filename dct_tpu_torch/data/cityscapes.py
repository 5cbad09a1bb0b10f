"""Cityscapes dataset, preloaded to packed uint8 arrays
(``dct_tpu/data/cityscapes.py``).

Tree layout: ``root/leftImg8bit/{split}/{city}/*.png`` with the matching
``root/gtFine/{split}/{city}/*_gtFine_labelIds.png``. The 33 raw label ids
map to 19 train classes, void to ``IGNORE_INDEX`` (250). ``subsample``
keeps every n-th file of the sorted list (the reference's 1/20 of the
files). RGB images resize bilinearly to ``image_size`` (H, W), labels
nearest, with Pillow as dct_tpu resizes them, so the arrays are dct_tpu's.

Host code only: the arrays go to the device in one transfer each
(``data/pipeline.py:DeviceDataset``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

VOID_CLASSES = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
                 31, 32, 33]
CLASS_NAMES = ["road", "sidewalk", "building", "wall", "fence", "pole",
               "traffic_light", "traffic_sign", "vegetation", "terrain", "sky",
               "person", "rider", "car", "truck", "bus", "train", "motorcycle",
               "bicycle"]
IGNORE_INDEX = 250
NUM_CLASSES = 19
CITYSCAPES_MEAN = (0.290101, 0.328081, 0.286964)
CITYSCAPES_STD = (0.182954, 0.186566, 0.184475)
COLORS = np.array([[128, 64, 128], [244, 35, 232], [70, 70, 70],
                   [102, 102, 156], [190, 153, 153], [153, 153, 153],
                   [250, 170, 30], [220, 220, 0], [107, 142, 35],
                   [152, 251, 152], [0, 130, 180], [220, 20, 60],
                   [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
                   [0, 80, 100], [0, 0, 230], [119, 11, 32]], np.uint8)

# raw label id → train id, every other id → IGNORE_INDEX
_LUT = np.full(256, IGNORE_INDEX, np.uint8)
_LUT[VALID_CLASSES] = np.arange(NUM_CLASSES, dtype=np.uint8)


def encode_segmap(mask: np.ndarray) -> np.ndarray:
    """Raw labelIds → 19 train ids as uint8, void (and any id outside
    0–255) → 250."""
    mask = np.asarray(mask)
    out = np.full(mask.shape, IGNORE_INDEX, np.uint8)
    inside = (mask >= 0) & (mask < 256)
    out[inside] = _LUT[mask[inside]]
    return out


def decode_segmap(mask: np.ndarray) -> np.ndarray:
    """19-class map → RGB picture; other values stay black."""
    mask = np.asarray(mask)
    out = np.zeros(mask.shape + (3,), np.uint8)
    known = (mask >= 0) & (mask < NUM_CLASSES)
    out[known] = COLORS[mask[known]]
    return out


class CityscapesDataset:
    """Packed RGB arrays: ``data["img"]`` uint8 (N,H,W,3), ``data["gt"]``
    uint8 (N,H,W) of train ids and 250."""

    def __init__(self, root_path, mode: str = "train",
                 image_size: Tuple[int, int] = (256, 512),
                 subsample: int = 20, quite: bool = False) -> None:
        self.root = Path(root_path)
        assert self.root.exists(), self.root
        assert mode in ("train", "test", "val"), mode
        self.mode = mode
        self.image_size = tuple(int(s) for s in image_size)
        self.num_classes = NUM_CLASSES
        self.ignore_index = IGNORE_INDEX

        images_base = self.root / "leftImg8bit" / mode
        annotations_base = self.root / "gtFine" / mode
        assert images_base.exists(), images_base
        files = sorted(str(p) for p in images_base.rglob("*.png"))
        if not files:
            raise FileNotFoundError(f"No files for split={mode} found in {images_base}")
        if subsample > 1:
            files = files[::subsample]
        if not quite:
            print(f"Found {len(files)} {mode} images (subsample={subsample})")

        self.img_paths: List[str] = files
        self.gt_paths = [str(annotations_base / Path(f).parent.name /
                             Path(f).name.replace("leftImg8bit", "gtFine_labelIds"))
                         for f in files]
        self.filenames = [Path(f).stem for f in files]
        self.cities = [Path(f).parent.name for f in files]
        h, w = self.image_size
        img = np.empty((len(files), h, w, 3), np.uint8)
        gt = np.empty((len(files), h, w), np.uint8)
        for i, (ip, gp) in enumerate(zip(self.img_paths, self.gt_paths)):
            with Image.open(ip) as im:
                img[i] = np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR))
            with Image.open(gp) as im:
                gt[i] = encode_segmap(np.asarray(im.resize((w, h), Image.NEAREST)))
        self.data: Dict[str, np.ndarray] = {"img": img, "gt": gt}

    def __len__(self) -> int:
        return len(self.filenames)

    def subset(self, indices: Sequence[int]) -> "CityscapesDataset":
        new = object.__new__(CityscapesDataset)
        new.__dict__.update({k: v for k, v in self.__dict__.items()
                             if k not in ("data", "filenames", "cities",
                                          "img_paths", "gt_paths")})
        idx = np.asarray(indices, np.int64)
        new.filenames = [self.filenames[i] for i in idx]
        new.cities = [self.cities[i] for i in idx]
        new.img_paths = [self.img_paths[i] for i in idx]
        new.gt_paths = [self.gt_paths[i] for i in idx]
        new.data = {k: v[idx].copy() for k, v in self.data.items()}
        return new

    def extract_cities(self, cities: Sequence[str]) -> "CityscapesDataset":
        keep = set(cities)
        return self.subset([i for i, c in enumerate(self.cities) if c in keep])

    def split_by_proportion(self, p: float, seed: int = 0
                            ) -> Tuple["CityscapesDataset", "CityscapesDataset"]:
        """(labeled, unlabeled): a share ``p`` of a ``RandomState(seed)``
        permutation, each side in file order."""
        order = np.random.RandomState(seed).permutation(len(self))
        n_lab = int(len(self) * p)
        return self.subset(sorted(order[:n_lab])), self.subset(sorted(order[n_lab:]))


def get_cityscapes_split(config: Dict):
    """K labeled, the unlabeled and the val CityscapesDataset from a config's
    ``Dataset`` and ``Lab_Partitions`` blocks: the train split's share
    ``partition_sets`` is labeled (``RandomState(Seed)``); a share
    ``partition_overlap`` of it, drawn with ``RandomState(Seed + 1)``, is
    common to every model, and the rest is dealt out model by model."""
    ds_cfg = dict(config["Dataset"])
    root = ds_cfg.pop("root_dir")
    size = ds_cfg.get("image_size", (256, 512))
    subsample = int(ds_cfg.get("subsample", 20))
    train = CityscapesDataset(root, "train", size, subsample)
    val = CityscapesDataset(root, "val", size, subsample, quite=True)
    parts = config["Lab_Partitions"]
    n_models = int(parts["num_models"])
    seed = int(config.get("Seed", 1234))
    lab_all, unlab = train.split_by_proportion(float(parts["partition_sets"]), seed=seed)
    n = len(lab_all)
    rs = np.random.RandomState(seed + 1)
    common = set(rs.choice(n, int(n * float(parts["partition_overlap"])),
                           replace=False).tolist())
    exclusive = [i for i in range(n) if i not in common]
    labeled = [lab_all.subset(sorted(list(common) + exclusive[i::n_models]))
               for i in range(n_models)]
    return labeled, unlab, val
