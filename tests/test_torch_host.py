"""The port's host-side helpers against dct_tpu's: weight schedulers,
batchers, the patient sampler, the metrics CSV (byte for byte what pandas
writes), image dumps and the loss guard. No JAX computation runs."""
import math

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from dct_tpu import schedules as jax_schedules
from dct_tpu.data.dataset import ConcatDataset as JaxConcatDataset
from dct_tpu.data.pipeline import EpochBatcher as JaxEpochBatcher
from dct_tpu.data.pipeline import InfiniteBatcher as JaxInfiniteBatcher
from dct_tpu.data.sampler import PatientSampler as JaxPatientSampler
from dct_tpu.utils.general import check_finite_losses as jax_check_finite_losses
from dct_tpu.utils.general import save_images as jax_save_images
from dct_tpu.utils.logging import resume_records as jax_resume_records
from dct_tpu_torch import schedules
from dct_tpu_torch.data.dataset import ConcatDataset, MedicalImageDataset
from dct_tpu_torch.data.pipeline import EpochBatcher, InfiniteBatcher
from dct_tpu_torch.data.sampler import PatientSampler
from dct_tpu_torch.utils.general import check_finite_losses, fold_in, save_images
from dct_tpu_torch.utils.logging import resume_records, write_metrics_csv
from dct_tpu.data.dataset import MedicalImageDataset as JaxMedicalImageDataset
from helpers import make_synthetic_acdc

SCHEDULERS = [
    {"name": "RampScheduler", "begin_epoch": 2, "max_epoch": 9, "max_value": 0.5,
     "ramp_mult": -5},
    {"name": "ConstantScheduler", "begin_epoch": 3, "max_value": 0.7},
    {"name": "ConstantScheduler", "begin_epoch": 0},
    {"name": "RampDownScheduler", "max_epoch": 12, "max_value": 1.0,
     "ramp_mult": -5, "min_val": 0.1, "cutoff": 8},
]


@pytest.mark.parametrize("cfg", SCHEDULERS, ids=lambda c: c["name"])
def test_weight_schedulers_equal_dct_tpu(cfg):
    ref, got = jax_schedules.get_weight_scheduler(cfg), schedules.get_weight_scheduler(cfg)
    for _ in range(14):
        assert got.value == ref.value
        ref.step()
        got.step()
    assert got.state_dict() == ref.state_dict()
    fresh = schedules.get_weight_scheduler(cfg)
    fresh.load_state_dict(got.state_dict())
    assert fresh.value == got.value and fresh.epoch == 14


@pytest.mark.parametrize("n,b", [(10, 3), (9, 3), (12, 4), (7, 7)])
def test_epoch_batcher_equal_dct_tpu(n, b):
    """Shuffled and drop-last, the only setting the trainers use."""
    ref = JaxEpochBatcher(n, b, shuffle=True, drop_last=True).epoch(np.random.RandomState(5))
    got = EpochBatcher(n, b).epoch(np.random.RandomState(5))
    np.testing.assert_array_equal(got, ref)


def test_infinite_batcher_equal_dct_tpu():
    """Spans passes in mid-take, shares its RandomState with other draws."""
    ref_rs, rs = np.random.RandomState(9), np.random.RandomState(9)
    ref, got = JaxInfiniteBatcher(11, 3, ref_rs), InfiniteBatcher(11, 3, rs)
    for k in (2, 5, 1, 7, 3):
        np.testing.assert_array_equal(got.take(k), ref.take(k))
        assert rs.randint(1000) == ref_rs.randint(1000)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = make_synthetic_acdc(tmp_path_factory.mktemp("acdc"), n_train_patients=4,
                               n_val_patients=2, slices_per_patient=3, size=16)
    kw = {"transform": (16, 16), "quite": True}
    return (JaxMedicalImageDataset(root, "train", **kw),
            MedicalImageDataset(root, "train", **kw))


def test_dataset_loader_equals_dct_tpus(datasets):
    ref, got = datasets
    assert got.filenames == ref.filenames
    for key in ref.data:
        np.testing.assert_array_equal(got.data[key], ref.data[key])
    assert got.patient_of(r"(patient\d+_\d+)_\d+") == ref.patient_of(r"(patient\d+_\d+)_\d+")
    sub_ref, sub = ref.filter_by_patterns(["patient002"]), got.filter_by_patterns(["patient002"])
    assert sub.filenames == sub_ref.filenames and len(sub) == 3
    np.testing.assert_array_equal(sub.data["img"], sub_ref.data["img"])


@pytest.mark.parametrize("size", [16, 24, 12])
@pytest.mark.parametrize("equalize", [None, "img", ["img", "gt"]])
def test_dataset_resize_and_equalize_equal_dct_tpus(datasets, size, equalize):
    """The tree is 16²: read as it is, upsized and downsized (bilinear for
    images, nearest for masks), with and without histogram equalisation."""
    root = datasets[1].root_dir
    kw = {"transform": (size, size), "equalize": equalize, "quite": True}
    ref = JaxMedicalImageDataset(root, "val", **kw)
    got = MedicalImageDataset(root, "val", **kw)
    assert got.filenames == ref.filenames
    for key in ref.data:
        assert got.data[key].shape == (len(got), size, size)
        np.testing.assert_array_equal(got.data[key], ref.data[key])


def test_patient_sampler_and_concat_equal_dct_tpu(datasets):
    ref_ds, ds = datasets
    regex = r"(patient\d+_\d+)_\d+"
    ref, got = JaxPatientSampler(ref_ds, regex, quite=True), PatientSampler(ds, regex, quite=True)
    assert got.idx_map == ref.idx_map and list(got) == list(ref) and len(got) == 4
    a, b = [1, 2, 3], "xy"
    assert len(ConcatDataset(a, b)) == len(JaxConcatDataset(a, b)) == 2
    assert ConcatDataset(a, b)[1] == JaxConcatDataset(a, b)[1]


def test_metrics_csv_is_what_pandas_writes(tmp_path):
    """dct_tpu writes ``DataFrame(records).set_index("epoch").to_csv(
    float_format="%.4f")``; the port's csv-module writer gives the same
    bytes, NaN and negative zero included, and both readers give the same
    resumed rows."""
    rs = np.random.RandomState(0)
    cols = ["tra_dice_0_1", "val_dice_0_1", "sup_loss_0", "jsd_loss", "t_train"]
    records = [{"epoch": e, **{c: float(v) for c, v in zip(cols, rs.rand(len(cols)) * 10 ** e)}}
               for e in range(4)]
    records[1]["jsd_loss"] = math.nan
    records[2]["sup_loss_0"] = -1e-7
    ref_path, path = tmp_path / "ref.csv", tmp_path / "port.csv"
    pd.DataFrame(records).set_index("epoch").to_csv(ref_path, float_format="%.4f")
    write_metrics_csv(path, records, cols)
    assert path.read_bytes() == ref_path.read_bytes()
    for start in (0, 2, 9):
        ref, got = jax_resume_records(ref_path, start), resume_records(path, start)
        assert len(got) == len(ref) == (0 if start == 0 else min(start, 4))
        for r, g in zip(ref, got):
            assert g.keys() == r.keys() and g["epoch"] == r["epoch"]
            for k in cols:
                assert (math.isnan(g[k]) and math.isnan(r[k])) or g[k] == r[k], k


def test_save_images_layout_and_pixels_equal_dct_tpu(tmp_path):
    segs = np.random.RandomState(2).randint(0, 4, (2, 8, 12))
    names = ["patient001_01_0_0", "patient001_01_0_1"]
    for seg_num in (None, "1"):
        jax_save_images(segs, names, tmp_path / "ref", "eval", iter=3, seg_num=seg_num)
        save_images(segs, names, tmp_path / "port", "eval", iter=3, seg_num=seg_num)
    ref = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").rglob("*.png"))
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert got == ref and len(got) == 4
    for rel in ref:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / rel)),
                                      np.asarray(Image.open(tmp_path / "ref" / rel)))


@pytest.mark.parametrize("policy", ["warn", "abort", "ignore"])
def test_check_finite_losses_policies_equal_dct_tpu(policy, capsys):
    good = {"sup": np.ones(2), "jsd": 0.5}
    bad = {"sup": np.array([1.0, np.nan]), "adv": np.inf, "jsd": 0.1}
    assert check_finite_losses(good, 0, policy) is jax_check_finite_losses(good, 0, policy) is True
    if policy == "abort":
        for fn in (check_finite_losses, jax_check_finite_losses):
            with pytest.raises(FloatingPointError, match=r"\['adv', 'sup'\]"):
                fn(bad, 3, policy)
        return
    capsys.readouterr()
    assert check_finite_losses(bad, 3, policy) is False
    port_out = capsys.readouterr().out
    assert jax_check_finite_losses(bad, 3, policy) is False
    ref_out = capsys.readouterr().out
    assert bool(port_out) == bool(ref_out) == (policy == "warn")
    if policy == "warn":
        assert "['adv', 'sup']" in port_out and "epoch 3" in port_out


def test_fold_in_gives_distinct_reproducible_seeds():
    seeds = [fold_in(1234, e) for e in range(50)]
    assert len(set(seeds)) == 50 and seeds == [fold_in(1234, e) for e in range(50)]
    assert fold_in(1234, 0) != fold_in(1235, 0)
