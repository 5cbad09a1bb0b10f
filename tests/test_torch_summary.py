"""The ensemble evaluation of the port held against dct_tpu on the CPU:

* ``make_summary_step`` against dct_tpu's on the committed trained weights
  (soft vote with ``results/ACDC_cotrain_r3``, K = 2; hard vote with
  ``results/ACDC_cotrain_k3_r4``, K = 3, where three-way ties occur; hard
  vote with the 2-class ``results/prostate_cotraining``), float64 network
  arithmetic on both sides, 32² synthetic slices;
* ``cohen_kappa``, ``KappaMetrics`` and ``hausdorff_distance`` against
  dct_tpu's and the root ``summary.py``'s on seeded random maps;
* the CLI end to end: the root ``summary.py`` and
  ``python -m dct_tpu_torch.summary --device cpu`` on copies of one run
  directory and tree; and the port's headers against the committed ones
  of all four runs;
* ``aggregate_ensemble_results`` against dct_tpu's.

dct_tpu's Segmentators are built around the committed weights without
their eager flax init (``test_torch_jaxref.py:jax_segmentator``), the root
``summary.py``'s too: its ``Segmentator(...)`` call, whose random init it
overwrites with the checkpoint, goes to that builder. One dct_tpu compile
per step variant.
"""
import csv
import math
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import dct_tpu.models
import summary as root_summary
from dct_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from dct_tpu.metrics import KappaMetrics as JaxKappaMetrics
from dct_tpu.metrics import cohen_kappa as jax_cohen_kappa
from dct_tpu.models.segmentator import stack_states
from dct_tpu.postprocessing.report import aggregate_ensemble_results as jax_aggregate
from dct_tpu.train.steps import make_summary_step as jax_make_summary_step
from dct_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from dct_tpu_torch.data.pipeline import PatientBuckets
from dct_tpu_torch.metrics import KappaMetrics, cohen_kappa
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.postprocessing.report import aggregate_ensemble_results
from dct_tpu_torch.summary import hausdorff_distance
from dct_tpu_torch.summary import main as summary_main
from dct_tpu_torch.train.steps import make_summary_step
from test_torch_jaxref import jax_segmentator, one_torch_thread, rings  # noqa: F401
from test_torch_trees import prostate_layout, spleen_layout, write_tree

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results"
H = 32
# (committed run, ensemble, the dataset's stem format, considered classes)
RUNS = {"ACDC_cotrain_r3": ("acdc", [1, 2, 3]),
        "ACDC_cotrain_k3_r4": ("acdc", [1, 2, 3]),
        "prostate_cotraining": ("prostate", [1]),
        "spleen512_r3/jsd_adv": ("spleen", [1])}
ACDC_REGEX = r"(patient\d+_\d+)_\d+"


def acdc_layout(counts):
    return {"val": [f"patient{p:03d}_01_0_{s}" for p, n in enumerate(counts, 1)
                    for s in range(n)]}


# ------------------------------------------------------- make_summary_step

def recentred_bias(payload, i, img):
    """Model ``i``'s last bias (``fullconv``) recentred on its mean logits
    over ``img``, plus a draw of 0.3 a class. On 32² rings the trained nets
    see background only; with the shift their class maps, votes and
    three-way ties are not trivial."""
    x = torch.from_numpy(img).float()[..., None] / 255.0
    mean = Segmentator.from_state_dict(payload, device="cpu").predict(x).mean(dim=(0, 1, 2))
    shift = np.random.RandomState(i).randn(len(mean)) * 0.3 - mean.double().numpy()
    return (payload["net_state_dict"]["fullconv"]["bias"] + shift).astype(np.float32)


def snapped(tree):
    """Every parameter and running statistic below 1e-7 in magnitude set to
    exactly 0. The trained weights hold weight decay's leftovers down to
    1e-36: in results/ACDC_cotrain_r3/best_1.ckpt they make a dead channel
    at bottleneck_2_0's input (7.5e-12) tie in every pool window up to the
    last float64 bit, so each framework's rounding picks the mask's corner,
    and the unpool moved 19,222 logits by up to 0.085 and 10 of the 10,240
    class-map pixels (measured at 32² in float64; in fp32, 3,402 logits by
    up to 0.053 and 4 pixels). With them at 0 those windows tie exactly,
    which both pools break alike, and the logits agree: equal in float64,
    within 7.6e-6 in fp32 (measured)."""
    if isinstance(tree, dict):
        return {k: snapped(v) for k, v in tree.items()}
    return np.where(np.abs(tree) < 1e-7, 0, tree).astype(tree.dtype)


def weights(run, img):
    """Both loaders' payloads of every best_*.ckpt of a committed run,
    snapped, with the same recentred last bias on both sides."""
    out = []
    for i, p in enumerate(sorted((RESULTS / run).glob("best_*.ckpt"))):
        jx, pt = jax_load_checkpoint(p)["segmentator"], load_checkpoint(p)["segmentator"]
        for payload in (jx, pt):
            for key in ("net_state_dict", "batch_stats"):
                payload[key] = snapped(payload[key])
        bias = recentred_bias(pt, i, img)
        for payload in (jx, pt):
            payload["net_state_dict"]["fullconv"]["bias"] = bias.copy()
        out.append((jx, pt))
    return out


@pytest.mark.parametrize("run,ensemble", [("ACDC_cotrain_r3", "soft"),
                                          ("ACDC_cotrain_k3_r4", "hard"),
                                          ("prostate_cotraining", "hard")])
def test_summary_step_matches_dct_tpu(run, ensemble):
    """3 patients of 3, 5 and 2 slices (bucket of 8). Class maps and votes
    equal; dice (fp32 ratios of integer counts) at 1e-6 (measured: 0)."""
    img, gt = rings(10, H, seed=11)
    payloads = weights(run, img)
    C = int(payloads[0][1]["arch_dict"]["num_classes"])
    gt = np.minimum(gt, C - 1)
    stems = [f"patient{p:03d}_01_0_{s}" for p, n in ((1, 3), (2, 5), (3, 2)) for s in range(n)]
    buckets = PatientBuckets(SimpleNamespace(filenames=stems), ACDC_REGEX)
    assert buckets.bucket_len == 8

    with jax.enable_x64(True):
        seg = jax_segmentator(payloads[0][0]["net_state_dict"], payloads[0][0]["batch_stats"],
                              arch=payloads[0][0]["arch_dict"])
        stacked = stack_states([{"params": jx["net_state_dict"],
                                 "batch_stats": jax.tree_util.tree_map(
                                     lambda a: np.asarray(a, np.float64), jx["batch_stats"])}
                                for jx, _ in payloads])
        ref = jax_make_summary_step(seg, C, ensemble)(
            stacked["params"], stacked["batch_stats"], jnp.asarray(img), jnp.asarray(gt),
            jnp.asarray(buckets.indices), jnp.asarray(buckets.mask))
        ref = {k: np.asarray(v) for k, v in ref.items()}

    segs = [Segmentator.from_state_dict(pt, device="cpu") for _, pt in payloads]
    for s in segs:
        s.compute_dtype = torch.float64          # the network arithmetic only
    got = make_summary_step(segs, C, ensemble)(torch.from_numpy(img), torch.from_numpy(gt),
                                               buckets.indices, buckets.mask)
    got = {k: v.numpy() for k, v in got.items()}
    K, m = len(segs), buckets.mask
    assert got.keys() == ref.keys()
    for k, shape in (("pred", (3, K, 8, H, H)), ("ens", (3, 8, H, H)),
                     ("dice2d", (3, K, 8, C)), ("dice3d", (3, K, C)),
                     ("ens_dice2d", (3, 8, C)), ("ens_dice3d", (3, C))):
        assert got[k].shape == ref[k].shape == shape, k
        assert got[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(got["pred"], ref["pred"])
    np.testing.assert_array_equal(got["ens"], ref["ens"])
    np.testing.assert_allclose(got["dice2d"].transpose(0, 2, 1, 3)[m],
                               ref["dice2d"].transpose(0, 2, 1, 3)[m], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["ens_dice2d"][m], ref["ens_dice2d"][m], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["dice3d"], ref["dice3d"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["ens_dice3d"], ref["ens_dice3d"], rtol=0, atol=1e-6)
    # every class occurs, and the models disagree on a share of the pixels
    assert (np.bincount(got["pred"].ravel(), minlength=C) > 0).all()
    assert (got["pred"][:, 0] != got["pred"][:, 1]).mean() > 0.1
    assert (got["ens"] != got["pred"][:, 0]).any()
    if K == 3:
        # three-way ties go to the smallest class id
        p = got["pred"]
        tie = (p[:, 0] != p[:, 1]) & (p[:, 1] != p[:, 2]) & (p[:, 0] != p[:, 2])
        assert tie.any()
        np.testing.assert_array_equal(got["ens"][tie], p.min(axis=1)[tie])


def test_summary_step_rejects_unknown_ensemble():
    with pytest.raises(ValueError, match="soft"):
        make_summary_step([], 4, "mean")


# ------------------------------------------------------ kappa, Hausdorff

def kappa_cases():
    rs = np.random.RandomState(5)
    cases = []
    for n, c in ((0, 3), (1, 1), (50, 1), (200, 2), (200, 4), (1000, 3)):
        a = rs.randint(0, c, n).astype(np.uint8)
        b = a.copy()
        flip = rs.rand(n) < 0.3
        b[flip] = rs.randint(0, c, flip.sum())
        cases.append((a, b))
    cases.append((np.array([1, 1, 1], np.uint8), np.array([1, 0, 1], np.uint8)))
    cases.append((np.array([2, 2], np.int64), np.array([2, 2], np.int64)))
    return cases


@pytest.mark.parametrize("case", range(len(kappa_cases())))
def test_cohen_kappa_matches_dct_tpu(case):
    """Equal to the last bit, NaN for empty input, 1.0 with one class."""
    a, b = kappa_cases()[case]
    ref, got = jax_cohen_kappa(a, b), cohen_kappa(a, b)
    assert (math.isnan(ref) and math.isnan(got)) or ref == got, (ref, got)
    assert cohen_kappa(torch.from_numpy(a), torch.from_numpy(b)) == got or math.isnan(got)


@pytest.mark.parametrize("considered", [[1], [1, 2, 3], [0, 1], [3]])
def test_kappa_metrics_match_dct_tpu(considered):
    """Three patients, K = 3 models against a vote. With one considered
    class a model scores exactly 0.0 unless it agrees everywhere; a patient
    whose vote has no considered pixel gives NaN, which the mean skips."""
    rs = np.random.RandomState(len(considered) + considered[0])
    ref, got = JaxKappaMetrics(), KappaMetrics()
    for p in range(3):
        vote = rs.randint(0, 3 if p == 2 else 4, (4, 8, 8)).astype(np.uint8)
        preds = [np.where(rs.rand(*vote.shape) < 0.2, rs.randint(0, 4, vote.shape), vote)
                 .astype(np.uint8) for _ in range(3)]
        preds[1][np.isin(vote, considered)] = vote[np.isin(vote, considered)]
        ref.add(preds, vote, considered)
        got.add(preds, vote, considered)
    np.testing.assert_array_equal(np.array(got.kappa), np.array(ref.kappa))
    np.testing.assert_array_equal(got.value(), ref.value())
    assert got.summary() == pytest.approx(ref.summary(), nan_ok=True, rel=0, abs=0)
    if considered in ([1], [3]):
        assert got.value()[0] == 0.0 and got.value()[1] == 1.0


def hd_cases():
    """Random masks, sparse ones in one corner of the volume (the bounding
    box that the port transforms is then small), 2D and 3D, spacings, and
    empty masks."""
    rs = np.random.RandomState(9)
    blobs = [(rs.rand(3, 16, 16) < q) for q in (0.02, 0.1, 0.3)]
    corner = [np.zeros((4, 24, 20), bool) for _ in range(2)]
    corner[0][1:3, 2:9, 11:18] = rs.rand(2, 7, 7) < 0.2
    corner[1][0:2, 4:12, 13:19] = rs.rand(2, 8, 6) < 0.3
    empty = np.zeros((3, 16, 16), bool)
    return [(blobs[0], blobs[1], None), (blobs[1], blobs[2], 1.5625),
            (blobs[2][0], blobs[0][0], 0.7), (corner[0], corner[1], None),
            (corner[0], corner[1], 1.5625), (corner[1][0], corner[0][1], 0.7),
            (empty, empty, None), (empty, blobs[0], None), (blobs[1], empty, 2.0)]


@pytest.mark.parametrize("case", range(len(hd_cases())))
def test_hausdorff_matches_summary_py(case):
    a, b, spacing = hd_cases()[case]
    ref = root_summary.hausdorff_distance(a, b, spacing)
    got = hausdorff_distance(a, b, spacing)
    assert (math.isnan(ref) and math.isnan(got)) or ref == got, (ref, got)


# ------------------------------------------------------------ the CLI

def copy_run(run: str, dest: Path, tree: Path, recentre_on=None) -> Path:
    """The committed run's best checkpoints and config.yml, the config's
    dataset at ``tree`` and 32²; with ``recentre_on`` (images), each
    checkpoint snapped and its last bias recentred on them."""
    dest.mkdir(parents=True)
    for i, p in enumerate(sorted((RESULTS / run).glob("best_*.ckpt"))):
        if recentre_on is None:
            shutil.copy(p, dest / p.name)
            continue
        ckpt = load_checkpoint(p)
        for key in ("net_state_dict", "batch_stats"):
            ckpt["segmentator"][key] = snapped(ckpt["segmentator"][key])
        ckpt["segmentator"]["net_state_dict"]["fullconv"]["bias"] = recentred_bias(
            ckpt["segmentator"], i, recentre_on)
        save_checkpoint(dest / p.name, ckpt)
    config = yaml.safe_load((RESULTS / run / "config.yml").read_text())
    config["Dataset"]["root_dir"] = str(tree)
    config["Dataset"]["transform"] = f"segment_transform(({H},{H}))"
    (dest / "config.yml").write_text(yaml.safe_dump(config))
    return dest


def fast_jax_segmentator(arch_dict, optim_dict, scheduler_dict, key, input_shape=None):
    """dct_tpu's Segmentator as ``summary.py`` builds it, without the eager
    flax init whose weights it replaces with the checkpoint's."""
    return jax_segmentator({}, {}, optim_dict, arch_dict, scheduler_dict,
                           compute_dtype=arch_dict.get("compute_dtype", "float32"))


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


CSVS = ["summary.csv", "bsummary.csv", "div.csv", "summary_std.csv", "bsummary_std.csv"]
LOGS = [f"log_{d}dice_{m}.csv" for d in ("2D", "3D")
        for m in ("ensemble", "model_0", "model_1")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The root summary.py and the port's CLI, soft vote, on copies of one
    run directory (results/ACDC_cotrain_r3 at 32², last biases recentred)
    and one val tree of 3 patients of 3, 5 and 2 slices, with a
    patient_info.csv whose spacing reaches one patient."""
    base = tmp_path_factory.mktemp("summary")
    tree = write_tree(base / "tree", acdc_layout([3, 5, 2]), size=H, n_classes=4, seed=3)
    (tree / "patient_info.csv").write_text("patient002,1.5625\npatient009,0.5\n")
    ckpts = copy_run("ACDC_cotrain_r3", base / "ckpts", tree, recentre_on=rings(10, H, seed=11)[0])
    jax_run, port_run = shutil.copytree(ckpts, base / "jax_run"), shutil.copytree(ckpts, base / "port_run")
    mp = pytest.MonkeyPatch()
    mp.setattr(dct_tpu.models, "Segmentator", fast_jax_segmentator)
    try:
        ref = root_summary.main(["--input_dir", str(jax_run)])
    finally:
        mp.undo()
    got = summary_main(["--device", "cpu", "--input_dir", str(port_run)])
    return {"jax": jax_run, "port": port_run, "ref": ref, "got": got}


@pytest.mark.parametrize("name", CSVS)
def test_cli_tables_match_summary_py(cli_runs, name):
    """Equal headers and row labels; %.4f fields within one unit of the
    last place (1.01e-4) plus rounding; NaN (empty) where dct_tpu's is."""
    ref, got = read_csv(cli_runs["jax"] / name), read_csv(cli_runs["port"] / name)
    assert got[0] == ref[0]
    assert len(got) == len(ref)
    first = 0 if name == "div.csv" else 1          # div.csv has no index
    for r, g in zip(ref[1:], got[1:]):
        assert g[:first] == r[:first]
        for a, b in zip(r[first:], g[first:]):
            if a == "" or b == "":
                assert a == b
            else:
                assert abs(float(a) - float(b)) <= 1.01e-4, (name, r, g)
    if name == "bsummary.csv":
        assert [r[0] for r in got[1:]] == ["patient001_01", "patient002_01",
                                            "patient003_01", "mean"]


@pytest.mark.parametrize("name", LOGS)
def test_cli_logs_match_summary_py(cli_runs, name):
    """The raw dice logs: pandas' layout of float32 values, at 1e-6."""
    ref, got = read_csv(cli_runs["jax"] / name), read_csv(cli_runs["port"] / name)
    assert got[0] == ref[0] == ["", "0", "1", "2", "3"]
    assert [r[0] for r in got] == [r[0] for r in ref]
    np.testing.assert_allclose(np.array(got[1:], float), np.array(ref[1:], float),
                               rtol=0, atol=1e-6)


def test_cli_png_dumps_are_byte_equal(cli_runs):
    def pngs(run):
        return {p.relative_to(run): p.read_bytes() for p in (run / "iter1000").rglob("*.png")}
    ref, got = pngs(cli_runs["jax"]), pngs(cli_runs["port"])
    assert sorted(got) == sorted(ref)
    assert {p.parts[:3] for p in got} == {("iter1000", "val", s) for s in ("0", "1", "voting")}
    assert len(got) == 3 * 10
    for k in ref:
        assert got[k] == ref[k], k


def test_cli_returns_what_it_writes(cli_runs):
    got, ref = cli_runs["got"], cli_runs["ref"]
    assert list(got["bsummary"]) == list(ref["bsummary"].index)
    assert got["div"].keys() == set(ref["div"].columns)
    for col in ref["bsummary"].columns:
        np.testing.assert_allclose([got["bsummary"][r][col] for r in ref["bsummary"].index],
                                   ref["bsummary"][col].to_numpy(float), rtol=0, atol=1e-5)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_headers_match_committed_results(run, tmp_path):
    """The port's CLI on each committed run (K = 2 or 3; 4 classes and
    --axises 1 2 3, or 2 classes and --axises 1) on a 32² tree in its
    dataset's stem format: the headers and the std tables' row labels of
    the committed summary files."""
    dataset, axises = RUNS[run]
    C = 4 if dataset == "acdc" else 2
    layout = {"acdc": acdc_layout([2, 3]),
              "prostate": {"val": prostate_layout([], [2, 16], val_slices=2)["val"]},
              "spleen": {"val": spleen_layout([], [8, 10], val_slices=2)["val"]}}[dataset]
    tree = write_tree(tmp_path / "tree", layout, size=H, n_classes=C, seed=1)
    out = copy_run(run, tmp_path / "run", tree)
    summary_main(["--device", "cpu", "--input_dir", str(out), "--ensemble_method", "hard",
                  "--axises", *map(str, axises)])
    committed = RESULTS / run
    for name in CSVS + [p.name for p in committed.glob("log_*.csv")]:
        ref, got = read_csv(committed / name), read_csv(out / name)
        assert got[0] == ref[0], name
        if name.endswith("std.csv"):
            assert [r[0] for r in got] == [r[0] for r in ref], name
    assert read_csv(out / "bsummary.csv")[-1][0] == "mean"


# ---------------------------------------------------------------- report

@pytest.fixture
def run_folders(tmp_path):
    """Three committed runs' bsummary.csv and div.csv (4 and 2 classes, so
    the tables' rows differ), a fourth without div.csv, two of them under
    one parent name."""
    folder = tmp_path / "runs"
    for src, dest, div in (("ACDC_cotrain_r3", "a/exp", True),
                           ("ACDC_cotrain_k3_r4", "b/exp", True),
                           ("prostate_cotraining", "c/prostate", True),
                           ("ACDC_cotrain_r3", "d/nodiv", False)):
        (folder / dest).mkdir(parents=True)
        shutil.copy(RESULTS / src / "bsummary.csv", folder / dest / "bsummary.csv")
        if div:
            shutil.copy(RESULTS / src / "div.csv", folder / dest / "div.csv")
    return folder


def compare_report(folder, got, ref):
    for key in ("ensemble", "average"):
        r = ref[key]
        assert list(got[key]) == list(r.columns), key          # rank order
        for name in r.columns:
            assert list(got[key][name]) == list(r.index)
            np.testing.assert_allclose([got[key][name][i] for i in r.index],
                                       r[name].to_numpy(float), rtol=0, atol=1e-12)


@pytest.mark.parametrize("unique", [False, True])
def test_report_matches_dct_tpu(run_folders, tmp_path, unique):
    """With a duplicate parent name (runs named by path) and, after the
    duplicate is removed, by parent directory; the written CSVs are equal
    to pandas' files."""
    if unique:
        shutil.rmtree(run_folders / "b")
    ref_folder = tmp_path / "ref"
    shutil.copytree(run_folders, ref_folder)
    ref = jax_aggregate(str(ref_folder))
    got = aggregate_ensemble_results(str(run_folders))
    if unique:
        assert set(got["ensemble"]) == {"exp", "prostate", "nodiv"}
    else:
        assert all(n.endswith("bsummary.csv") for n in got["ensemble"])
    # run names are paths under each folder: compare them relative to it
    for key in got:
        got[key] = {n.replace(str(run_folders), str(ref_folder)): v
                    for n, v in got[key].items()}
    compare_report(run_folders, got, ref)
    for name in ("ensemble_results.csv", "mean_score_results.csv"):
        ref_text = (ref_folder / name).read_text().replace(str(ref_folder), "")
        assert (run_folders / name).read_text().replace(str(run_folders), "") == ref_text
    assert math.isnan(got["ensemble"][[n for n in got["ensemble"] if "nodiv" in n][0]]["kappa"])
