"""Cityscapes offline preprocessing (``dct_tpu/datapreprocessing/
cityscapes_tools.py``): a parallel resize of a PNG tree with the label
remap to the 19 train ids (``data/cityscapes.py:encode_segmap``), and the
selection of the coarse extra frames. The datasets resize and remap at
load, so these serve the offline workflow: bake a resized tree once.

    python -m dct_tpu_torch.datapreprocessing.cityscapes_tools resize \
        --source <tree> --dest <tree> [--size 512 1024] [--workers 4] [--no_remap]
    python -m dct_tpu_torch.datapreprocessing.cityscapes_tools extradata \
        --images_path <root> [--dest dataset/Cityscapes_extra] [--n_images 2000]
"""
from __future__ import annotations

import argparse
from multiprocessing import Pool
from pathlib import Path
from typing import Tuple

import numpy as np
from PIL import Image

from ..data.cityscapes import encode_segmap


def _resize_one(args) -> str:
    src, dst, size, is_label, remap = args
    img = Image.open(src)
    resample = Image.NEAREST if is_label else Image.BILINEAR
    img = img.resize((size[1], size[0]), resample)
    if is_label and remap:
        img = Image.fromarray(encode_segmap(np.asarray(img)))
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    img.save(dst)
    return dst


def resize_tree(source: str, dest: str, size: Tuple[int, int] = (512, 1024),
                workers: int = 4, remap_labels: bool = True) -> int:
    """Mirror ``source`` PNG tree into ``dest`` at ``size`` (H,W); gtFine
    labelIds get NEAREST + 19-class remap, images get BILINEAR."""
    source_p = Path(source)
    jobs = []
    for src in source_p.rglob("*.png"):
        rel = src.relative_to(source_p)
        is_label = "gtFine" in str(rel) and "labelIds" in src.name
        jobs.append((str(src), str(Path(dest) / rel), size, is_label,
                     remap_labels))
    if workers > 1:
        with Pool(workers) as pool:
            done = pool.map(_resize_one, jobs)
    else:
        done = [_resize_one(j) for j in jobs]
    return len(done)


def gt_path_for(img_path: Path) -> Path:
    """leftImg8bit image path → matching gtCoarse labelIds path
    (ref:cityscapes_extradata.py:40-42)."""
    return Path(str(img_path)
                .replace("/leftImg8bit", "/gtCoarse")
                .replace("_leftImg8bit", "_gtCoarse_labelIds"))


def select_extra_data(images_path: str, destiny_path: str,
                      n_images: int = 2000, size: Tuple[int, int] = (1024, 512),
                      resize: bool = True, seed: int = 1) -> int:
    """Cityscapes coarse extra-data selector
    (ref:generalframework/datapreprocessing/cityscapes_extradata.py): pick
    ``n_images`` random leftImg8bit_trainextra frames (np seed 1, choice
    without replacement), resize image BICUBIC / labels NEAREST to ``size``
    (W,H) — or plain copy with ``resize=False`` — preserving the last three
    path components under ``destiny_path``. Returns the number written."""
    root = Path(images_path) / "leftImg8bit"
    all_imgs = sorted(str(p) for p in root.rglob("*.png"))
    assert all_imgs, f"no PNGs under {root}"
    rng = np.random.RandomState(seed)
    chosen = [Path(p) for p in
              rng.choice(all_imgs, size=min(n_images, len(all_imgs)),
                         replace=False)]
    dst_root = Path(destiny_path)
    written = 0
    for img_p in chosen:
        gt_p = gt_path_for(img_p)
        dst_img = dst_root.joinpath(*img_p.parts[-4:])
        dst_gt = dst_root.joinpath(*gt_p.parts[-4:])
        dst_img.parent.mkdir(parents=True, exist_ok=True)
        dst_gt.parent.mkdir(parents=True, exist_ok=True)
        if resize:
            assert img_p.exists() and gt_p.exists(), (img_p, gt_p)
            Image.open(img_p).resize(size, Image.BICUBIC).save(dst_img)
            Image.open(gt_p).resize(size, Image.NEAREST).save(dst_gt)
        else:
            import shutil
            shutil.copy(img_p, dst_img)
            shutil.copy(gt_p, dst_gt)
        written += 1
    return written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd")
    rp = sub.add_parser("resize", help="resize a PNG tree")
    rp.add_argument("--source", required=True)
    rp.add_argument("--dest", required=True)
    rp.add_argument("--size", type=int, nargs=2, default=[512, 1024])
    rp.add_argument("--workers", type=int, default=4)
    rp.add_argument("--no_remap", action="store_true")
    ep = sub.add_parser("extradata",
                        help="select+resize coarse extra frames "
                             "(ref:cityscapes_extradata.py)")
    ep.add_argument("--images_path", required=True)
    ep.add_argument("--dest", default="dataset/Cityscapes_extra")
    ep.add_argument("--n_images", type=int, default=2000)
    ep.add_argument("--size", type=int, nargs=2, default=[1024, 512])
    ep.add_argument("--no_resize", action="store_true")
    args = parser.parse_args(argv)
    if args.cmd == "extradata":
        n = select_extra_data(args.images_path, args.dest, args.n_images,
                              tuple(args.size), not args.no_resize)
        print(f"selected {n} extra images into {args.dest}")
    else:
        n = resize_tree(args.source, args.dest, tuple(args.size),
                        args.workers, not args.no_remap)
        print(f"resized {n} images into {args.dest}")


if __name__ == "__main__":
    main()
