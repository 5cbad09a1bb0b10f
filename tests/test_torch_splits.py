"""The spleen, prostate and GM co-training configs on the port, held against
dct_tpu on the CPU: each config's split builder and its eval buckets (with
the config's ``grp_regex``) equal dct_tpu's on a synthetic tree in the
dataset's stem format, with ``np.random`` seeded alike; and the spleen
config through the co-training CLI and then ``summary --axises 1``.

No JAX code is compiled: the builders and buckets are host code on both
sides.
"""
import csv
from pathlib import Path

import numpy as np
import pytest
import yaml

from dct_tpu.data.pipeline import PatientBuckets as JaxPatientBuckets
from dct_tpu.data.splits import get_dataset_split as jax_get_dataset_split
from dct_tpu_torch.data.pipeline import PatientBuckets
from dct_tpu_torch.data.splits import get_dataset_split
from dct_tpu_torch.summary import main as summary_main
from dct_tpu_torch.train_cotraining import main as cotrain_main
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_trees import gm_layout, prostate_layout, spleen_layout, write_tree

ROOT = Path(__file__).resolve().parents[1]
H = 16
# spleen: patients 1–100 as the split expects, so that Patient_10's pattern
# also matches Patient_100 (a regex search) on both sides; prostate: the
# Case ids present, with gaps; GM: site 1 labeled, sites 3 and 4 val,
# site 2 ignored, an unlabeled folder
LAYOUTS = {
    "spleen": lambda: spleen_layout(range(1, 101), [8, 10, 12], slices=1, val_slices=3),
    "prostate": lambda: prostate_layout([1, 3, 4, 5, 7, 8, 10, 11, 12, 13, 15, 16, 18, 19, 20,
                                         21, 23, 24, 26, 27, 28, 29, 30, 31, 33],
                                        [2, 17, 32], slices=2, val_slices=3),
    "gm": lambda: gm_layout({1: range(1, 11), 2: [1, 2], 3: [1, 2, 4], 4: [3, 5]},
                            {2: [5, 6], 4: [7]}, slices=2),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {name: write_tree(base / name, layout(), size=H, n_classes=2, seed=i)
            for i, (name, layout) in enumerate(LAYOUTS.items())}


def config(name, tree, **partitions):
    cfg = yaml.safe_load((ROOT / "configs" / f"{name}_cotraining.yaml").read_text())
    cfg["Dataset"]["root_dir"] = str(tree)
    cfg["Dataset"]["transform"] = f"segment_transform(({H},{H}))"
    cfg["Lab_Partitions"].update(partitions)
    return cfg


def both_splits(name, tree, **partitions):
    out = []
    for fn in (jax_get_dataset_split, get_dataset_split):
        np.random.seed(1234)
        out.append(fn(config(name, tree, **partitions), name))
    return out


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("partitions", [{}, {"num_models": 3, "partition_overlap": 0.5}],
                         ids=["config", "k3"])
def test_splits_equal_dct_tpu(trees, name, partitions):
    """The config's own partitions, and K = 3 with half the labeled
    patients shared: the same stems and slices in every subset."""
    (ref_lab, ref_unlab, ref_val), (lab, unlab, val) = both_splits(name, trees[name], **partitions)
    assert len(lab) == len(ref_lab) == partitions.get("num_models", 2)
    for ref, got in zip(ref_lab + [ref_unlab, ref_val], lab + [unlab, val]):
        assert got.filenames == ref.filenames
        assert len(got.filenames) > 0
        assert got.data.keys() == ref.data.keys()
        for key in ref.data:
            np.testing.assert_array_equal(got.data[key], ref.data[key])
    if partitions:
        assert lab[0].filenames != lab[1].filenames
    if name == "spleen":
        # the pattern of Patient_10 took Patient_100's slice too, on both sides
        tens = [f for f in lab[0].filenames + unlab.filenames if f.startswith("Patient_10")]
        assert "Patient_100_00_0_0" in tens


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_patient_buckets_equal_dct_tpu(trees, name):
    """The val set's buckets with the config's grp_regex."""
    cfg = config(name, trees[name])
    regex = cfg["Lab_Dataloader"]["batch_sampler"][1]["grp_regex"]
    _, _, val = both_splits(name, trees[name])[1]
    ref, got = JaxPatientBuckets(val, regex), PatientBuckets(val, regex)
    assert got.patients == ref.patients and got.bucket_len == ref.bucket_len
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.mask, ref.mask)
    assert len(got.patients) >= 2


def test_spleen_config_through_the_cli_and_summary(trees, tmp_path):
    """configs/spleen_cotraining.yaml as it ships but for the tree, 16² and
    one epoch of 2 iterations, then the summary with --axises 1: dct_tpu's
    metric columns for one foreground class, and the committed spleen
    run's summary headers."""
    run = tmp_path / "run"
    cotrain_main(["--device", "cpu", "--config", str(ROOT / "configs" / "spleen_cotraining.yaml"),
                  f"Dataset.root_dir={trees['spleen']}",
                  f"Dataset.transform=segment_transform(({H},{H}))",
                  f"Trainer.save_dir={run}", "Trainer.max_epoch=1", "Trainer.iters_per_epoch=2"])
    committed = ROOT / "results" / "spleen512_r3" / "jsd_adv"

    def header(path):
        with open(path, newline="") as f:
            return next(csv.reader(f))
    assert header(run / "metrics.csv") == header(committed / "metrics.csv")
    out = summary_main(["--device", "cpu", "--input_dir", str(run), "--axises", "1"])
    for name in ("summary.csv", "bsummary.csv", "div.csv", "log_3Ddice_model_1.csv"):
        assert header(run / name) == header(committed / name), name
    assert list(out["bsummary"]) == ["Patient_08", "Patient_10", "Patient_12", "mean"]
    assert len(list((run / "iter1000" / "val" / "voting").glob("*.png"))) == 9
