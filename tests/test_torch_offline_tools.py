"""The port's offline tools against dct_tpu's, on the CPU, on synthetic
volumes and trees made with numpy from seeds: the nii → PNG slicers and the
Cityscapes resize and extra-data tools (``datapreprocessing/``) write
byte-equal PNG trees, and the learning-curve plot and the slice viewer
(``postprocessing/``) plot the same data into byte-equal PNGs.

The tests need no nibabel: the ``.nii`` loaders run through their
``python -m`` entry points with each module's ``_load_nii`` reading ``.npy``
bytes instead, and their refusal without nibabel is checked as it ships.
"""
import csv
import sys

import numpy as np
import pytest
from PIL import Image

import dct_tpu.datapreprocessing.cityscapes_tools as jax_city_tools
import dct_tpu.datapreprocessing.slicers as jax_slicers
import dct_tpu.postprocessing.plot as jax_plot
import dct_tpu.postprocessing.viewer as jax_viewer
from dct_tpu_torch.datapreprocessing import cityscapes_tools, slicers
from dct_tpu_torch.postprocessing import plot, viewer

SIDES = {"dct_tpu": (jax_slicers, jax_city_tools, jax_plot, jax_viewer),
         "port": (slicers, cityscapes_tools, plot, viewer)}


def tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_trees(a, b, n_min=1):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert len(ta) >= n_min and sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def volume(seed, shape=(40, 36, 3), classes=4):
    rs = np.random.RandomState(seed)
    img = rs.normal(100.0, 40.0, shape).astype(np.float32)
    gt = rs.randint(0, classes, shape).astype(np.uint8)
    return img, gt


# ---- slicers -----------------------------------------------------------------

@pytest.mark.parametrize("n_augment", [0, 2])
def test_save_volume_slices_byte_equal(tmp_path, n_augment):
    img, gt = volume(n_augment)
    stems = {}
    for side, (mod, *_) in SIDES.items():
        stems[side] = mod.save_volume_slices(img, gt, "patient007", "01", tmp_path / side,
                                             (24, 20), n_augment=n_augment, seed=5)
    assert stems["port"] == stems["dct_tpu"]
    assert_same_trees(tmp_path / "dct_tpu", tmp_path / "port", 2 * 3 * (n_augment + 1))


@pytest.mark.parametrize("with_gt", [True, False])
def test_save_spin_slices_byte_equal(tmp_path, with_gt):
    img, gt = volume(3, (30, 26, 2))
    for side, (mod, *_) in SIDES.items():
        mod.save_spin_slices(img, gt if with_gt else None, "site1-sc01-image",
                             tmp_path / side, (0.5, 0.4), crop_size=(20, 24),
                             gt_stem="site1-sc01-mask-r1" if with_gt else None)
    assert_same_trees(tmp_path / "dct_tpu", tmp_path / "port", 2 * (2 if with_gt else 1))


def test_slicing_math_matches_dct_tpu():
    img, gt = volume(4, (17, 23, 1))
    np.testing.assert_array_equal(slicers.norm_arr(img), jax_slicers.norm_arr(img))
    for size in ((10, 12), (30, 8), (17, 23)):
        np.testing.assert_array_equal(slicers.center_crop(gt[..., 0], size),
                                      jax_slicers.center_crop(gt[..., 0], size))
    np.testing.assert_array_equal(slicers.resize_by_resolution(gt[..., 0], (0.7, 0.3)),
                                  jax_slicers.resize_by_resolution(gt[..., 0], (0.7, 0.3)))
    onehot = np.moveaxis(np.eye(4, dtype=np.uint8)[gt[..., 0]], -1, 0)
    np.testing.assert_array_equal(slicers.one_hot2dist(onehot), jax_slicers.one_hot2dist(onehot))
    assert slicers.get_frame("patient001_frame12.nii.gz") == "12"
    with pytest.raises(ValueError):
        slicers.get_frame("patient001.nii")


def write_acdc_source(root):
    """An ACDC training layout whose ``.nii`` files hold ``.npy`` bytes."""
    for p in range(4):
        pdir = root / f"patient{p:03d}"
        pdir.mkdir(parents=True)
        for frame in (1, 12):
            img, gt = volume(10 * p + frame, (20, 16, 2))
            for name, arr in ((f"patient{p:03d}_frame{frame:02d}.nii", img),
                              (f"patient{p:03d}_frame{frame:02d}_gt.nii", gt)):
                with open(pdir / name, "wb") as f:
                    np.save(f, arr)
        (pdir / f"patient{p:03d}_4d.nii").write_bytes(b"")


def test_slice_acdc_entry_point_byte_equal(tmp_path, monkeypatch):
    write_acdc_source(tmp_path / "src")
    for side, (mod, *_) in SIDES.items():
        monkeypatch.setattr(mod, "_load_nii", lambda path: np.load(path))
        mod.main(["--source_dir", str(tmp_path / "src"), "--dest_dir", str(tmp_path / side),
                  "--shape", "16", "12", "--retain", "1", "--n_augment", "1", "--seed", "2"])
    assert (tmp_path / "port" / "val" / "img").is_dir()
    assert_same_trees(tmp_path / "dct_tpu", tmp_path / "port", 30)


def test_nii_loaders_need_nibabel(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "nibabel", None)
    for mod in (jax_slicers, slicers):
        with pytest.raises(ImportError, match="nibabel"):
            mod._load_nii(tmp_path / "x.nii")


# ---- cityscapes_tools ----------------------------------------------------------

def write_city_source(root, seed=0, coarse=False):
    rs = np.random.RandomState(seed)
    for split, city, n in (("train", "aachen", 3), ("val", "bonn", 2)):
        for i in range(n):
            stem = f"{city}_{i:06d}_000019"
            img_p = root / "leftImg8bit" / split / city / f"{stem}_leftImg8bit.png"
            label = "gtCoarse" if coarse else "gtFine"
            gt_p = root / label / split / city / f"{stem}_{label}_labelIds.png"
            for p in (img_p, gt_p):
                p.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rs.randint(0, 256, (32, 64, 3)).astype(np.uint8)).save(img_p)
            Image.fromarray(rs.randint(0, 34, (32, 64)).astype(np.uint8)).save(gt_p)


@pytest.mark.parametrize("remap", [True, False])
def test_resize_tree_entry_point_byte_equal(tmp_path, remap):
    write_city_source(tmp_path / "src")
    for side, (_, mod, *_) in SIDES.items():
        mod.main(["resize", "--source", str(tmp_path / "src"), "--dest", str(tmp_path / side),
                  "--size", "16", "24", "--workers", "1"] + ([] if remap else ["--no_remap"]))
    assert_same_trees(tmp_path / "dct_tpu", tmp_path / "port", 10)
    labels = np.asarray(Image.open(next((tmp_path / "port" / "gtFine").rglob("*.png"))))
    assert labels.shape == (16, 24) and (labels.max() <= 18 or labels.max() == 250) == remap


def test_select_extra_data_entry_point_byte_equal(tmp_path):
    write_city_source(tmp_path / "src", seed=1, coarse=True)
    for side, (_, mod, *_) in SIDES.items():
        mod.main(["extradata", "--images_path", str(tmp_path / "src"), "--dest",
                  str(tmp_path / side), "--n_images", "3", "--size", "24", "12"])
    assert_same_trees(tmp_path / "dct_tpu", tmp_path / "port", 6)
    assert cityscapes_tools.gt_path_for(tmp_path / "leftImg8bit" / "a_leftImg8bit.png") == \
        jax_city_tools.gt_path_for(tmp_path / "leftImg8bit" / "a_leftImg8bit.png")


# ---- plot and viewer -------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """Every Axes.plot / imshow / contour call's data, in order."""
    from matplotlib.axes import Axes
    calls = []
    for name in ("plot", "imshow", "contour"):
        orig = getattr(Axes, name)

        def rec(self, *args, _orig=orig, _name=name, **kwargs):
            calls.append((_name, [np.asarray(a) for a in args],
                          {k: v for k, v in kwargs.items() if k != "cmap"}))
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(Axes, name, rec)
    return calls


def assert_same_calls(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (na, args_a, kw_a), (nb, args_b, kw_b) in zip(a, b):
        assert na == nb and kw_a == kw_b
        for x, y in zip(args_a, args_b):
            np.testing.assert_array_equal(x, y)


def write_runs(root, n_runs=2):
    rs = np.random.RandomState(7)
    folders = []
    for r in range(n_runs):
        run = root / f"run{r}"
        run.mkdir(parents=True)
        cols = ["val_dice_0_1", "val_dice_0_2", "tra_dice_0_1", "sup_loss_0"]
        with open(run / "metrics.csv", "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["epoch"] + cols)
            for e in range(6):
                w.writerow([e] + ["" if (e == 3 and c == "val_dice_0_2") else "%.4f" % rs.rand()
                                  for c in cols])
        np.save(run / "dice.npy", rs.rand(5, 2, 2))
        folders.append(str(run))
    return folders


@pytest.mark.parametrize("file,columns,smooth", [
    ("metrics.csv", None, 1), ("metrics.csv", ["sup_loss_0", "nope", "val_dice_0_2"], 1),
    ("dice.npy", ["0", "3"], 1)])
def test_plot_learning_curves_same_data_and_file(tmp_path, recorded, file, columns, smooth):
    folders = write_runs(tmp_path)
    out, calls = {}, {}
    for side, (*_, mod, _) in SIDES.items():
        recorded.clear()
        out[side] = mod.main(["--folders", *folders, "--file", file, "--smooth", str(smooth),
                              "--out", str(tmp_path / f"{side}.png")]
                             + (["--columns", *columns] if columns else []))
        calls[side] = list(recorded)
    assert_same_calls(calls["dct_tpu"], calls["port"])
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "dct_tpu.png").read_bytes()


def test_plot_smoothing_matches_pandas_rolling(tmp_path, recorded):
    """``--smooth 3``: the trailing mean that skips NaN, as pandas'
    ``rolling(3, min_periods=1).mean()`` (the same values up to the last
    bits of its running sums)."""
    folders = write_runs(tmp_path, 1)
    calls = {}
    for side, (*_, mod, _) in SIDES.items():
        recorded.clear()
        mod.plot_learning_curves(folders, smooth=3, out=str(tmp_path / f"{side}.png"))
        calls[side] = list(recorded)
    assert len(calls["port"]) == len(calls["dct_tpu"]) == 3
    for (_, (xa, ya), _), (_, (xb, yb), _) in zip(calls["dct_tpu"], calls["port"]):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_allclose(yb, ya, rtol=1e-12, atol=0)
    assert (tmp_path / "port.png").exists()


def write_viewer_tree(root):
    rs = np.random.RandomState(8)
    dirs = [root / "img", root / "runA" / "pred", root / "runB" / "pred"]
    for d in dirs:
        d.mkdir(parents=True)
    for i in range(5):
        name = f"patient{i:03d}_01_0_{i}.png"
        Image.fromarray(rs.randint(0, 256, (24, 24)).astype(np.uint8)).save(dirs[0] / name)
        for d in dirs[1:]:
            Image.fromarray(rs.randint(0, 4, (24, 24)).astype(np.uint8)).save(d / name)
    (dirs[1] / "notes.txt").write_text("not a slice")
    return [str(d) for d in dirs]


@pytest.mark.parametrize("extra", [[], ["--contour", "--crop", "2", "--remap", "1:3,2:0"]])
def test_viewer_batch_mode_same_data_and_file(tmp_path, recorded, extra):
    img_dir, *folders = write_viewer_tree(tmp_path)
    calls = {}
    for side, (*_, mod) in SIDES.items():
        recorded.clear()
        mod.main(["--img_source", img_dir, *folders, "-n", "3", "--seed", "1",
                  "--id_regex", r"(patient\d+_\d+_\d+_\d+)\.png",
                  "--out", str(tmp_path / f"{side}.png"), *extra])
        calls[side] = list(recorded)
    assert_same_calls(calls["dct_tpu"], calls["port"])
    assert len(calls["port"]) == 3 * 2 * 2
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "dct_tpu.png").read_bytes()
    lists = viewer.get_image_lists(img_dir, folders, r"(patient\d+_\d+_\d+_\d+)\.png")
    assert lists == jax_viewer.get_image_lists(img_dir, folders, r"(patient\d+_\d+_\d+_\d+)\.png")
