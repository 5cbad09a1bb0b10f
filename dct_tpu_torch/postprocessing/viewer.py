"""Multi-run slice viewer (``dct_tpu/postprocessing/viewer.py``): a grid
with sampled slices as rows and run folders as columns, each run's
predicted mask over the common background image, with optional contours,
crop, class remap and an id regex to pair the files. ``--out`` renders to
a PNG (batch mode, no display); ``--show`` opens matplotlib's window.
matplotlib is imported inside the functions.

    python -m dct_tpu_torch.postprocessing.viewer --img_source <images> \
        <predictions> [<predictions> ...] [-n 4] [--out grid.png]
"""
from __future__ import annotations

import argparse
import re

from pathlib import Path
from typing import Dict, List, Optional, Tuple


def extract(pattern: str, string: str) -> Optional[str]:
    m = re.match(pattern, string)
    return m.group(1) if m else None


def get_image_lists(img_source: str, folders: List[str], id_regex: str
                    ) -> Tuple[List[str], List[List[str]], List[str]]:
    background = sorted(str(p) for p in Path(img_source).glob("*"))
    segs = [sorted(str(p) for p in Path(f).glob("*")) for f in folders]

    def ex(path: str) -> Optional[str]:
        return extract(id_regex, Path(path).name)   # match on the basename

    background = [b for b in background if ex(b) is not None]
    segs = [[s for s in sl if ex(s) is not None] for sl in segs]
    ids = [ex(b) for b in background]
    for names, folder in zip(segs, folders):
        assert len(background) == len(names), \
            f"{folder}: {len(names)} files vs {len(background)} backgrounds"
        assert ids == [ex(n) for n in names], f"id mismatch in {folder}"
    return background, segs, ids


def display(background_names, segmentation_names, indexes, column_title,
            row_title, crop: int = 0, contour: bool = False,
            remap: Optional[Dict[int, int]] = None, fig=None):
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt
    import numpy as np
    from PIL import Image

    if fig is None:
        fig = plt.figure(figsize=(3 * len(segmentation_names), 3 * len(indexes)))
    gs = gridspec.GridSpec(len(indexes), len(segmentation_names), figure=fig)
    for i, idx in enumerate(indexes):
        img = np.asarray(Image.open(background_names[idx]).convert("L"))
        if crop > 0:
            img = img[crop:-crop, crop:-crop]
        for j, names in enumerate(segmentation_names):
            axe = fig.add_subplot(gs[i, j])
            seg = np.asarray(Image.open(names[idx])).copy()
            if seg.ndim == 3:
                seg = seg[:, :, 0]
            if crop > 0:
                seg = seg[crop:-crop, crop:-crop]
            if remap:
                for k, v in remap.items():
                    seg[seg == k] = v
            if seg.shape != img.shape:
                seg = np.asarray(Image.fromarray(seg).resize(
                    img.shape[::-1], Image.NEAREST))
            axe.imshow(img, cmap="gray")
            if contour:
                axe.contour(seg, cmap="rainbow")
            else:
                axe.imshow(seg, alpha=0.5)
            axe.axis("off")
            if j == 0:
                axe.text(-30, seg.shape[0] // 2, row_title[idx], rotation=90,
                         verticalalignment="center", fontsize=10)
            if i == 0:
                axe.set_title(column_title[j], fontsize=10)
    return fig


def main(argv=None):
    import matplotlib

    parser = argparse.ArgumentParser(description="compare segmentations across runs")
    parser.add_argument("--img_source", required=True, help="background image folder")
    parser.add_argument("folders", nargs="+", help="prediction folders to compare")
    parser.add_argument("--id_regex", default=r"(.*)\.png")
    parser.add_argument("-n", type=int, default=4, help="slices per page")
    parser.add_argument("--crop", type=int, default=0)
    parser.add_argument("--contour", action="store_true")
    parser.add_argument("--remap", type=str, default=None,
                        help="class remap as 'old:new,old:new'")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="save PNG instead of showing")
    parser.add_argument("--show", action="store_true")
    args = parser.parse_args(argv)

    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    remap = None
    if args.remap:
        remap = {int(a): int(b) for a, b in
                 (pair.split(":") for pair in args.remap.split(","))}

    background, segs, ids = get_image_lists(args.img_source, args.folders,
                                            args.id_regex)
    rs = np.random.RandomState(args.seed)
    indexes = sorted(rs.choice(len(background), min(args.n, len(background)),
                               replace=False).tolist())
    fig = display(background, segs, indexes,
                  [Path(f).parent.name + "/" + Path(f).name for f in args.folders],
                  ids, args.crop, args.contour, remap)
    if args.out:
        fig.savefig(args.out, dpi=120, bbox_inches="tight")
        print(f"saved {args.out}")
    if args.show:
        plt.show()
    return fig


if __name__ == "__main__":
    main()
