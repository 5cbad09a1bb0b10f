"""Offline nii → PNG slicers (``dct_tpu/datapreprocessing/slicers.py``),
numpy and Pillow only.

Per dataset (ACDC, PROMISE12, the spinal-cord GM challenge, Task09
Spleen): normalise each 3D volume to uint8, slice along the last axis,
resize, optionally write augmented copies, and write
``dest/{train,val}/{img,gt}/<pid>_<frame>_<aug>_<slice>.png``. The slicing
functions take numpy volumes; nibabel is imported only inside the loaders
that read ``.nii`` files, as dct_tpu does.

    python -m dct_tpu_torch.datapreprocessing.slicers --source_dir <ACDC training> \
        --dest_dir <tree> [--shape 256 256] [--retain 25] [--n_augment 0] [--seed 0]
"""
from __future__ import annotations

import argparse
import random
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def norm_arr(img: np.ndarray) -> np.ndarray:
    """Volume-wide normalization to uint8 [0,255] (ref:slice_acdc.py:21-28)."""
    casted = img.astype(np.float32)
    shifted = casted - casted.min()
    norm = shifted / max(shifted.max(), 1e-12)
    return (255 * norm).astype(np.uint8)


def get_frame(filename: str, regex: str = r".*_frame(\d+)(_gt)?\.nii.*") -> str:
    m = re.match(regex, filename)
    if m:
        return m.group(1)
    raise ValueError(regex, filename)


def _augment_pair(img: Image.Image, gt: Image.Image,
                  rng: random.Random) -> Tuple[Image.Image, Image.Image]:
    """PIL flip/mirror/rotate pair augmentation for offline n_augment copies
    (ref:datapreprocessing/utils.py augment)."""
    from PIL import ImageOps
    if rng.random() > 0.5:
        img, gt = ImageOps.flip(img), ImageOps.flip(gt)
    if rng.random() > 0.5:
        img, gt = ImageOps.mirror(img), ImageOps.mirror(gt)
    if rng.random() > 0.5:
        angle = rng.random() * 90 - 45
        img = img.rotate(angle, resample=Image.NEAREST)
        gt = gt.rotate(angle, resample=Image.NEAREST)
    return img, gt


def save_volume_slices(img: np.ndarray, gt: np.ndarray, p_id: str, f_id: str,
                       dest_dir: Path, shape: Tuple[int, int] = (256, 256),
                       n_augment: int = 0, img_dir: str = "img",
                       gt_dir: str = "gt", seed: int = 0) -> List[str]:
    """Slice one (H,W,S) volume pair to PNGs; returns written stems
    (ref:slice_acdc.py:52-110 semantics: whole-volume normalization, nearest
    gt resize, ``{pid}_{frame}_{aug}_{slice}.png`` naming)."""
    assert img.shape == gt.shape, (img.shape, gt.shape)
    norm_img = norm_arr(img)
    rng = random.Random(seed)
    (Path(dest_dir, img_dir)).mkdir(parents=True, exist_ok=True)
    (Path(dest_dir, gt_dir)).mkdir(parents=True, exist_ok=True)
    stems: List[str] = []
    for j in range(img.shape[-1]):
        img_s = Image.fromarray(norm_img[:, :, j]).resize(shape[::-1], Image.BILINEAR)
        gt_s = Image.fromarray(gt[:, :, j].astype(np.uint8)).resize(
            shape[::-1], Image.NEAREST)
        for a in range(n_augment + 1):
            im, g = (img_s, gt_s) if a == 0 else _augment_pair(img_s, gt_s, rng)
            stem = f"{p_id}_{f_id}_{a}_{j}"
            im.save(Path(dest_dir, img_dir, stem + ".png"))
            g.save(Path(dest_dir, gt_dir, stem + ".png"))
            stems.append(stem)
    return stems


def _load_nii(path: Path) -> np.ndarray:
    try:
        import nibabel as nib
    except ImportError as e:  # pragma: no cover - env without nibabel
        raise ImportError(
            "nibabel is required for .nii slicing; install it or pre-slice "
            "volumes with save_volume_slices on raw arrays") from e
    return np.asarray(nib.load(str(path)).dataobj)


def slice_acdc(source_dir: str, dest_dir: str, shape=(256, 256),
               retain: int = 25, n_augment: int = 0, seed: int = 0) -> None:
    """ACDC training set → train/val PNG trees; ``retain`` patients go to val
    (ref:slice_acdc.py main flow)."""
    src = Path(source_dir)
    patients = sorted(p for p in src.iterdir() if p.is_dir())
    random.Random(seed).shuffle(patients)
    val_patients = set(p.name for p in patients[:retain])
    for pdir in patients:
        mode = "val" if pdir.name in val_patients else "train"
        for img_p in sorted(pdir.glob("*_frame*.nii*")):
            if "_gt" in img_p.name or "_4d" in img_p.name:
                continue
            gt_p = Path(str(img_p).replace(".nii", "_gt.nii"))
            if not gt_p.exists():
                continue
            save_volume_slices(_load_nii(img_p), _load_nii(gt_p), pdir.name,
                               get_frame(img_p.name), Path(dest_dir, mode),
                               shape, n_augment if mode == "train" else 0, seed=seed)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="nii → PNG slicer")
    parser.add_argument("--source_dir", required=True)
    parser.add_argument("--dest_dir", required=True)
    parser.add_argument("--shape", type=int, nargs=2, default=[256, 256])
    parser.add_argument("--retain", type=int, default=25)
    parser.add_argument("--n_augment", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    slice_acdc(args.source_dir, args.dest_dir, tuple(args.shape), args.retain,
               args.n_augment, args.seed)



def one_hot2dist(seg: np.ndarray) -> np.ndarray:
    """Signed distance map per one-hot class plane
    (ref:generalframework/datapreprocessing/utils.py:205-215; used by
    boundary-loss style preprocessing)."""
    from scipy.ndimage import distance_transform_edt as distance

    C = len(seg)
    res = np.zeros_like(seg, dtype=np.float64)
    for c in range(C):
        posmask = seg[c].astype(bool)
        if posmask.any():
            negmask = ~posmask
            res[c] = (distance(negmask) * negmask
                      - (distance(posmask) - 1) * posmask)
    return res


def slice_promise(source_dir: str, dest_dir: str, shape=(256, 256),
                  retain: int = 10, n_augment: int = 0, seed: int = 0) -> None:
    """PROMISE12 prostate volumes → PNG tree (ref:slice_promise.py flow:
    CaseXX.mhd/nii pairs with *_segmentation gt)."""
    src = Path(source_dir)
    cases = sorted(p for p in src.glob("Case*") if "_segmentation" not in p.name
                   and p.suffix in (".nii", ".gz", ".mhd"))
    random.Random(seed).shuffle(cases)
    val = {c.name for c in cases[:retain]}
    for img_p in cases:
        stem = img_p.name.split(".")[0]
        gt_candidates = list(src.glob(f"{stem}_segmentation.*"))
        if not gt_candidates:
            continue
        mode = "val" if img_p.name in val else "train"
        save_volume_slices(_load_nii(img_p), _load_nii(gt_candidates[0]),
                           stem, "00", Path(dest_dir, mode), shape,
                           n_augment if mode == "train" else 0, seed=seed)


def resize_by_resolution(arr2d: np.ndarray, pixeldim: Tuple[float, float],
                         t_pixeldim: Tuple[float, float] = (0.25, 0.25),
                         ) -> np.ndarray:
    """Resample a 2D slice from its voxel spacing to a target spacing
    (ref:slice_spin.py:30-47 Resize: PIL size = shape·pixeldim/t_pixeldim)."""
    ratio = (pixeldim[0] / t_pixeldim[0], pixeldim[1] / t_pixeldim[1])
    size = (int(arr2d.shape[0] * ratio[0]), int(arr2d.shape[1] * ratio[1]))
    return np.array(Image.fromarray(arr2d.astype(np.uint8)).resize(size))


def center_crop(arr2d: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Center crop with zero-pad when smaller (torchvision F.center_crop
    semantics, ref:slice_spin.py:50-74)."""
    th, tw = size
    h, w = arr2d.shape[:2]
    ph, pw = max(th - h, 0), max(tw - w, 0)
    if ph or pw:
        arr2d = np.pad(arr2d, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)))
        h, w = arr2d.shape[:2]
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return arr2d[y0:y0 + th, x0:x0 + tw]


def save_spin_slices(img: np.ndarray, gt: Optional[np.ndarray], stem: str,
                     dest_dir: Path, pixeldim: Tuple[float, float],
                     crop_size: Tuple[int, int] = (200, 200),
                     t_pixeldim: Tuple[float, float] = (0.25, 0.25),
                     gt_stem: Optional[str] = None) -> List[str]:
    """Slice one spinal-cord GM volume: whole-volume norm → per-slice
    resolution resample → center crop → ``{stem}_{slice}.png``
    (ref:slice_spin.py:107-139 save_slices). ``gt`` may be None for the
    unlabeled pool (then no gt/ folder is written)."""
    (Path(dest_dir, "img")).mkdir(parents=True, exist_ok=True)
    if gt is not None:
        (Path(dest_dir, "gt")).mkdir(parents=True, exist_ok=True)
        assert img.shape == gt.shape, (img.shape, gt.shape)
    norm_img = norm_arr(img)
    stems: List[str] = []
    for j in range(img.shape[-1]):
        c_img = center_crop(
            resize_by_resolution(norm_img[:, :, j], pixeldim, t_pixeldim),
            crop_size)
        Image.fromarray(c_img).save(Path(dest_dir, "img", f"{stem}_{j}.png"))
        if gt is not None:
            c_gt = center_crop(
                resize_by_resolution(gt[:, :, j], pixeldim, t_pixeldim),
                crop_size)
            Image.fromarray(c_gt.astype(np.uint8)).save(
                Path(dest_dir, "gt", f"{gt_stem or stem}_{j}.png"))
        stems.append(f"{stem}_{j}")
    return stems


_SPIN_SITE_RE = re.compile(r"(site\d-sc\d\d)-image")


def slice_spin(source_dir: str, dest_dir: str, crop_size=(200, 200),
               t_pixeldim=(0.25, 0.25)) -> None:
    """Spinal-cord GM challenge layout → PNG trees
    (ref:slice_spin.py:142-166 main): ``train/`` holds
    ``site{S}-sc{NN}-image.nii.gz`` + ``site{S}-sc{NN}-mask-r1.nii.gz``
    pairs, ``unlabel/`` holds images only; output ``dest/{train,unlabeled}``.
    """
    src = Path(source_dir)
    assert (src / "train").exists() and (src / "unlabel").exists(), src
    train_nii = list((src / "train").glob("*.nii*"))
    img_nii = sorted(p for p in train_nii if "-image" in p.name)
    gt_nii = sorted(p for p in train_nii if "mask-r1" in p.name)
    assert len(img_nii) == len(gt_nii), (len(img_nii), len(gt_nii))
    unlabeled = sorted((src / "unlabel").glob("*image.nii*"))
    print(f"found {len(img_nii)} paired + {len(unlabeled)} unlabeled volumes")

    def _spacing(p: Path) -> Tuple[float, float]:
        import nibabel as nib
        return tuple(nib.load(str(p)).header.get_zooms()[:2])

    for img_p, gt_p in zip(img_nii, gt_nii):
        m = _SPIN_SITE_RE.match(img_p.name)
        assert m, img_p.name
        assert gt_p.name.startswith(m.group(1)), (img_p.name, gt_p.name)
        save_spin_slices(_load_nii(img_p), _load_nii(gt_p),
                         img_p.name.split(".")[0], Path(dest_dir, "train"),
                         _spacing(img_p), crop_size, t_pixeldim,
                         gt_stem=gt_p.name.split(".")[0])
    for img_p in unlabeled:
        save_spin_slices(_load_nii(img_p), None, img_p.name.split(".")[0],
                         Path(dest_dir, "unlabeled"), _spacing(img_p),
                         crop_size, t_pixeldim)


def slice_spleen(source_dir: str, dest_dir: str, shape=(512, 512),
                 retain: int = 8, seed: int = 0) -> None:
    """Task09 Spleen CT volumes → 512x512 PNG tree
    (ref:dataset/Spleen/slice_spleen.py:30-40: nib load, per-volume norm)."""
    src = Path(source_dir)
    imgs = sorted((src / "imagesTr").glob("spleen_*.nii*"))
    random.Random(seed).shuffle(imgs)
    val = {p.name for p in imgs[:retain]}
    for i, img_p in enumerate(imgs):
        gt_p = src / "labelsTr" / img_p.name
        if not gt_p.exists():
            continue
        mode = "val" if img_p.name in val else "train"
        pid = f"Patient_{i:02d}"
        save_volume_slices(_load_nii(img_p), _load_nii(gt_p), pid, "00",
                           Path(dest_dir, mode), shape, 0, seed=seed)


if __name__ == "__main__":
    main()
