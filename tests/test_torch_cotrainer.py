"""The co-training program around the step, held against dct_tpu on the CPU:
splits and eval buckets (equal), the CoTrainer's host draws (equal batch
indices and pairs for K=2 and K=3), the per-patient eval step on the
trained weights of ``results/ACDC_cotrain_r3`` (float64 network arithmetic),
the checkpoint layout (bitwise round trip through the weight bridge, same
payload as dct_tpu's), and the CLI with a resume.

Only the eval comparison compiles JAX code (one ``make_eval_all_models_step``);
dct_tpu's CoTrainer is built eagerly and its epoch is a stub.
"""
import copy
import csv
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from dct_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from dct_tpu.data.pipeline import PatientBuckets as JaxPatientBuckets
from dct_tpu.data.splits import get_dataset_split as jax_get_dataset_split
from dct_tpu.models import Segmentator as JaxSegmentator
from dct_tpu.models.segmentator import stack_states
from dct_tpu.optim import build_optimizer as jax_build_optimizer
from dct_tpu.train import CoTrainer as JaxCoTrainer
from dct_tpu.train.steps import make_eval_all_models_step as jax_eval_all_models
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.data.pipeline import PatientBuckets
from dct_tpu_torch.data.splits import get_dataset_split
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train import CoTrainer
from dct_tpu_torch.train.trainer import DEFAULT_GRP_REGEX
from dct_tpu_torch.train.steps import make_eval_all_models_step
from dct_tpu_torch.train_cotraining import main
from dct_tpu_torch.utils.convert import params_from_jax, params_to_jax
from helpers import make_synthetic_acdc

ROOT = Path(__file__).resolve().parents[1]
TRAINED = ROOT / "results" / "ACDC_cotrain_r3"
H, C = 32, 4
ARCH = {"name": "enet", "num_classes": C}
ADAM = {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
STEP = {"name": "StepLR", "step_size": 90, "gamma": 0.1}
RAMP = {"name": "RampScheduler", "begin_epoch": 0, "max_epoch": 3,
        "max_value": 0.5, "ramp_mult": -5}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """100 train patients × 2 slices at 32² (the ACDC split takes patients
    1–20 as labeled, 21–100 as unlabeled), 3 val patients."""
    return make_synthetic_acdc(tmp_path_factory.mktemp("acdc"), n_train_patients=100,
                               n_val_patients=3, slices_per_patient=2, size=H)


@pytest.fixture(scope="module")
def jax_seg():
    """One dct_tpu Segmentator (its eager flax init is the slow part, ~30 s
    here); the tests use shallow copies of it."""
    return JaxSegmentator(ARCH, ADAM, STEP, jax.random.PRNGKey(0), input_shape=(1, H, H, 1))


def split_config(tree, k, overlap):
    return {"Dataset": {"root_dir": str(tree), "subfolders": ["img", "gt"],
                        "transform": f"segment_transform(({H},{H}))"},
            "Lab_Partitions": {"num_models": k, "partition_sets": 0.2,
                               "partition_overlap": overlap}}


def both_splits(tree, k, overlap):
    out = []
    for fn in (jax_get_dataset_split, get_dataset_split):
        np.random.seed(1234)
        out.append(fn(split_config(tree, k, overlap), "acdc"))
    return out


@pytest.mark.parametrize("k,overlap", [(2, 1), (3, 0.5)])
def test_splits_equal_dct_tpu(tree, k, overlap):
    (ref_lab, ref_unlab, ref_val), (lab, unlab, val) = both_splits(tree, k, overlap)
    assert len(lab) == len(ref_lab) == k
    for ref, got in zip(ref_lab + [ref_unlab, ref_val], lab + [unlab, val]):
        assert got.filenames == ref.filenames
        assert got.data.keys() == ref.data.keys()
        for key in ref.data:
            assert got.data[key].dtype == ref.data[key].dtype == np.uint8
            np.testing.assert_array_equal(got.data[key], ref.data[key])
    if overlap < 1:
        assert lab[0].filenames != lab[1].filenames


def test_patient_buckets_equal_dct_tpu(tree):
    """Unequal slice counts in a shuffled stem order, and the val set."""
    rs = np.random.RandomState(3)
    stems = [f"patient{p:03d}_01_0_{s}" for p in range(1, 8)
             for s in range(rs.randint(1, 12))]
    rs.shuffle(stems)
    _, _, val = both_splits(tree, 2, 1)[1]
    for ds in (SimpleNamespace(filenames=stems), val):
        ref, got = JaxPatientBuckets(ds, DEFAULT_GRP_REGEX), PatientBuckets(ds, DEFAULT_GRP_REGEX)
        assert got.patients == ref.patients and got.bucket_len == ref.bucket_len
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.mask, ref.mask)
    assert PatientBuckets(SimpleNamespace(filenames=stems), DEFAULT_GRP_REGEX).bucket_len == 16


def _record(calls, idx_lab, idx_unlab, pairs, lr, lam_cot, lam_adv):
    calls.append({"idx_lab": np.asarray(idx_lab), "idx_unlab": np.asarray(idx_unlab),
                  "pairs": np.asarray(pairs), "lr": float(lr),
                  "lam_cot": float(lam_cot), "lam_adv": float(lam_adv)})


@pytest.mark.parametrize("k", [2, 3])
def test_host_draws_equal_dct_tpu(tree, tmp_path, jax_seg, k):
    """Both CoTrainers on the same datasets and seed, their epochs stubbed to
    record what the host hands them: two epochs of batch indices, pairs,
    lr and λ, with the schedulers stepped in between. The draws do not
    depend on the weights, so dct_tpu's K models are copies of one."""
    (ref_lab, ref_unlab, ref_val), (lab, unlab, val) = both_splits(tree, k, 0.5)
    T, B, Bu = 5, 2, 3
    kw = dict(max_epoch=2, cot_scheduler_dict=RAMP,
              adv_scheduler_dict={**RAMP, "begin_epoch": 1, "max_value": 0.05},
              batch_size=B, unlab_batch_size=Bu, iters_per_epoch=T, seed=77)
    crit = {"sup": None, "jsd": None, "adv": None}
    ref_tr = JaxCoTrainer(
        [copy.copy(jax_seg) for _ in range(k)], ref_lab, ref_unlab, ref_val, crit,
        save_dir=tmp_path / "jax", **kw)
    tr = CoTrainer([Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(i),
                                device="cpu") for i in range(k)],
                   lab, unlab, val, crit, save_dir=tmp_path / "port", device="cpu", **kw)
    ref_calls, calls = [], []

    def ref_fn(state, img, gt, idx_lab, idx_unlab, pairs, key, lr, lam_cot, lam_adv):
        _record(ref_calls, idx_lab, idx_unlab, pairs, lr, lam_cot, lam_adv)
        return state, {"lab_dice": np.zeros((T, k, B, C), np.float32),
                       "sup_loss": np.zeros((T, k), np.float32),
                       "jsd_loss": np.zeros(T, np.float32),
                       "adv_loss": np.zeros(T, np.float32)}

    def fn(img, gt, idx_lab, idx_unlab, pairs, generator, lr, lam_cot, lam_adv):
        _record(calls, idx_lab, idx_unlab, pairs, lr, lam_cot, lam_adv)
        return {"lab_dice": torch.zeros(T, k, B, C), "sup_loss": torch.zeros(T, k),
                "jsd_loss": torch.zeros(T), "adv_loss": torch.zeros(T)}

    ref_tr._concat_lab_arrays()
    for epoch in range(2):
        ref_tr._train_epoch(epoch, ("vmap", ref_fn), True, True)
        tr._train_epoch(epoch, fn, True, True)
        ref_tr._scheduler_step()
        tr._scheduler_step()
    # the concatenated device arrays hold the same slices at the same offsets
    np.testing.assert_array_equal(tr._img_cat.numpy(), np.asarray(ref_tr._lab_img_cat))
    assert tr._offsets == ref_tr._lab_offsets
    for ref, got in zip(ref_calls, calls):
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert calls[1]["lam_adv"] > 0 == calls[0]["lam_adv"]
    if k == 3:
        assert len({tuple(p) for c in calls for p in c["pairs"]}) > 1


@pytest.fixture(scope="module")
def trained():
    """results/ACDC_cotrain_r3/best_{0,1}.ckpt through both loaders."""
    return {i: (jax_load_checkpoint(TRAINED / f"best_{i}.ckpt"),
                load_checkpoint(TRAINED / f"best_{i}.ckpt")) for i in (0, 1)}


def test_eval_step_on_trained_weights_matches_dct_tpu(tree, trained, jax_seg):
    """make_eval_all_models_step on 3 patients of 2, 1 and 2 slices (bucket
    length 8), both models, float64 network arithmetic on both sides (the
    running statistics in float64 too: with fp32 statistics flax takes
    BatchNorm's rsqrt in fp32). The outputs are fp32 (logits come back as
    fp32, as in dct_tpu): hard dice equal, the loss to fp32 rounding."""
    _, _, val = both_splits(tree, 2, 1)[1]
    lab = both_splits(tree, 2, 1)[1][0][0]
    keep = [0, 1, 2, 4, 5]                      # patient001 ×2, 002 ×1, 003 ×2
    ds = lab.subset(keep)
    buckets = PatientBuckets(ds, DEFAULT_GRP_REGEX)
    assert buckets.mask.sum(1).tolist() == [2, 1, 2] and buckets.bucket_len == 8
    img, gt = ds.data["img"], ds.data["gt"]

    with jax.enable_x64(True):
        seg = copy.copy(jax_seg)
        seg.compute_dtype = jnp.dtype(jnp.float64)
        stacked = stack_states([{"params": trained[i][0]["segmentator"]["net_state_dict"],
                                 "batch_stats": jax.tree_util.tree_map(
                                     lambda a: np.asarray(a, np.float64),
                                     trained[i][0]["segmentator"]["batch_stats"])}
                                for i in (0, 1)])
        ref = jax_eval_all_models(seg, C)(stacked["params"], stacked["batch_stats"],
                                          jnp.asarray(img), jnp.asarray(gt),
                                          jnp.asarray(buckets.indices),
                                          jnp.asarray(buckets.mask))
        ref = {k: np.asarray(v) for k, v in ref.items()}

    segs = [Segmentator.from_state_dict(trained[i][1]["segmentator"], device="cpu")
            for i in (0, 1)]
    for s in segs:
        s.compute_dtype = torch.float64          # the network arithmetic only
    got = make_eval_all_models_step(segs, C)(torch.from_numpy(img), torch.from_numpy(gt),
                                             buckets.indices, buckets.mask)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["dice2d"].shape == ref["dice2d"].shape == (3, 2, 8, C)
    assert got["dice3d"].shape == ref["dice3d"].shape == (3, 2, C)
    assert got["loss"].shape == ref["loss"].shape == (3, 2)
    m = buckets.mask
    np.testing.assert_allclose(got["dice2d"].transpose(0, 2, 1, 3)[m],
                               ref["dice2d"].transpose(0, 2, 1, 3)[m], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["dice3d"], ref["dice3d"], rtol=0, atol=1e-6)
    # model 0: fp32 rounding of a mean over 5,120 pixels summed in another
    # order (measured 1.0e-6 of the loss). Model 1's trained weights hold a dead channel
    # at bottleneck_2_0's input (a constant 7.5e-12, equal to the last
    # float64 digit in both forwards), so its pool mask takes another corner
    # in 36 of 20,480 entries: its logits move by up to 0.1 and its loss by
    # 2e-4 of itself (measured), a near-tie of these weights, not a
    # difference of the two implementations. Its hard dice stay equal.
    np.testing.assert_allclose(got["loss"][:, 0], ref["loss"][:, 0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["loss"][:, 1], ref["loss"][:, 1], rtol=1e-3, atol=0)
    assert 0 < got["dice3d"][:, :, 1:].mean() < 1      # the trained nets segment something


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trip_is_bitwise(trained):
    sd = trained[0][1]["segmentator"]
    params, batch_stats = params_to_jax(params_from_jax(sd["net_state_dict"],
                                                        sd["batch_stats"]))
    for ref, got in ((sd["net_state_dict"], params), (sd["batch_stats"], batch_stats)):
        ref, got = dict(leaves(ref)), dict(leaves(got))
        assert got.keys() == ref.keys()
        for path in ref:
            assert got[path].dtype == ref[path].dtype, path
            np.testing.assert_array_equal(got[path], ref[path], err_msg=str(path))


# ---------------------------------------------------------------- the CLI

def cli_args(tree, run, *extra):
    return ["--device", "cpu", "--config", str(ROOT / "configs" / "acdc_cotraining.yaml"),
            f"Dataset.root_dir={tree}", f"Dataset.transform=segment_transform(({H},{H}))",
            f"Trainer.save_dir={run}", "Trainer.iters_per_epoch=2",
            "Lab_Dataloader.batch_size=2", "Unlab_Dataloader.batch_size=2",
            "StartTraining.train_jsd=True", "StartTraining.train_adv=True", *extra]


@pytest.fixture(scope="module")
def cli_run(tree, tmp_path_factory):
    """2 epochs × 2 iterations with the PNG dumps on, then a resume to
    epoch 3 without them."""
    run = tmp_path_factory.mktemp("cli") / "run"
    first = main(cli_args(tree, run, "Trainer.max_epoch=2", "StartTraining.save_train=True",
                          "StartTraining.save_val=True"))
    after_two = {name: (run / name).read_bytes() for name in ("last_0.ckpt", "metrics.csv")}
    resumed = main(cli_args(tree, run, "Trainer.max_epoch=3", f"Trainer.checkpoint={run}"))
    return {"run": run, "first": first, "resumed": resumed, "after_two": after_two}


def test_cli_writes_dct_tpus_outputs(cli_run):
    run = cli_run["run"]
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    with open(TRAINED / "metrics.csv", newline="") as f:
        ref_header = next(csv.reader(f))
    assert rows[0] == ref_header
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert all(len(r) == len(ref_header) for r in rows)
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    # the first two rows are the first run's, appended to, not rewritten
    assert cli_run["after_two"]["metrics.csv"].decode().splitlines() == \
        (run / "metrics.csv").read_text().splitlines()[:3]
    for name in ("best_0.ckpt", "best_1.ckpt", "last_0.ckpt", "last_1.ckpt",
                 "opt_state.ckpt", "metrics_0.csv", "metrics_1.csv", "val_dice.npy",
                 "val_batch_dice.npy", "scalars.jsonl", "config.yml"):
        assert (run / name).is_file(), name
    with open(run / "metrics_1.csv", newline="") as f:
        header = next(csv.reader(f))
    with open(TRAINED / "metrics_1.csv", newline="") as f:
        assert header == next(csv.reader(f))
    assert np.load(run / "val_batch_dice.npy").shape == (3, 6)
    assert np.load(run / "val_dice.npy").shape == (3, 6)


def test_cli_resume_restores_the_state(cli_run):
    """Schedulers, LR epoch, optimizer step counts and the epoch counter
    carry over: the resumed trainer ends where an unbroken 3-epoch run
    would."""
    first, resumed = cli_run["first"], cli_run["resumed"]
    assert first.cot_scheduler.epoch == 2 and resumed.start_epoch == 2
    assert resumed.cot_scheduler.epoch == resumed.adv_scheduler.epoch == 3
    assert resumed.cot_scheduler.state_dict() == {
        **first.cot_scheduler.state_dict(), "epoch": 3}
    for seg in resumed.segmentators:
        assert seg.epoch == 3
        steps = {float(st["step"]) for st in seg.optimizer.state.values()}
        assert steps == {6.0}                   # 3 epochs × 2 iterations
    payload = load_checkpoint(cli_run["run"] / "last_0.ckpt")
    assert payload["best_epoch"] == 2
    assert payload["segmentator"]["scheduler_state_dict"] == {"epoch": 3}


def test_cli_checkpoint_has_dct_tpus_payload(cli_run, trained):
    """A port-written best_0.ckpt has the keys, leaf paths, shapes and dtypes
    of dct_tpu's, and dct_tpu's loader reads it."""
    ref = trained[0][1]
    got = jax_load_checkpoint(cli_run["run"] / "best_0.ckpt")
    assert got.keys() == ref.keys()
    assert got["segmentator"].keys() == ref["segmentator"].keys()
    for key in ("net_state_dict", "batch_stats"):
        r, g = dict(leaves(ref["segmentator"][key])), dict(leaves(got["segmentator"][key]))
        assert g.keys() == r.keys()
        for path in r:
            assert (g[path].shape, g[path].dtype) == (r[path].shape, r[path].dtype), path
    for key in ("cot_scheduler", "adv_scheduler"):
        assert got[key].keys() == ref[key].keys()
    assert type(got["best_score"]) is float and type(got["best_epoch"]) is int


@pytest.mark.parametrize("bad", ["truncated", "fused"])
def test_dct_tpu_opt_state_reinitialises(cli_run, trained, tmp_path, capsys, bad):
    """An opt_state.ckpt the bridge cannot read restarts Adam with one line,
    as dct_tpu does with an unreadable file, and the weights still load: a
    truncated file, and dct_tpu's ``fused: true`` state (one flat moment
    vector per dtype, no parameter tree). dct_tpu's per-leaf optax state
    loads (tests/test_torch_checkpoint_optax.py)."""
    for name in ("last_0.ckpt", "last_1.ckpt"):
        shutil.copy(cli_run["run"] / name, tmp_path / name)
    if bad == "truncated":
        (tmp_path / "opt_state.ckpt").write_bytes((TRAINED / "opt_state.ckpt").read_bytes()[:4096])
    else:
        params = jax.tree_util.tree_map(lambda a, b: np.stack([a, b]),
                                        trained[0][0]["segmentator"]["net_state_dict"],
                                        trained[1][0]["segmentator"]["net_state_dict"])
        fused = jax_build_optimizer({**ADAM, "fused": True}).init(params)
        jax_save_checkpoint(tmp_path / "opt_state.ckpt", {"opt_state": fused})
    old = cli_run["resumed"]
    segs = [Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(i), device="cpu")
            for i in range(2)]
    datasets = [_Dataset(names) for names in old._stream_names]
    tr = CoTrainer(segs, datasets[:2], datasets[2], _Dataset(old.val_set.filenames),
                   {"sup": None, "jsd": None, "adv": None}, save_dir=tmp_path,
                   checkpoint=str(tmp_path), device="cpu")
    assert "opt_state.ckpt unreadable" in capsys.readouterr().out
    assert all(not s.optimizer.state for s in tr.segmentators)
    assert tr.start_epoch == 3
    ref = old.segmentators[0].net.state_dict()
    for key, v in tr.segmentators[0].net.state_dict().items():
        assert torch.equal(v, ref[key]), key


class _Dataset:
    """Stand-in dataset: stems and zero images."""

    def __init__(self, filenames):
        self.filenames = list(filenames)
        self.data = {"img": np.zeros((len(filenames), H, H), np.uint8),
                     "gt": np.zeros((len(filenames), H, H), np.uint8)}

    def __len__(self):
        return len(self.filenames)


def test_png_dumps_have_dct_tpus_layout(cli_run, tmp_path, jax_seg):
    """``save_train`` and ``save_val`` through the CLI write the
    iter###/mode/seg_num/name.png tree that dct_tpu's CoTrainer writes for
    the same streams (its eval steps stubbed: only the names are compared)."""
    tr = cli_run["first"]
    datasets = [_Dataset(names) for names in tr._stream_names]
    ref_tr = JaxCoTrainer([copy.copy(jax_seg) for _ in range(2)], datasets[:2], datasets[2],
                          _Dataset(tr.val_set.filenames), {"sup": None, "jsd": None, "adv": None},
                          save_dir=tmp_path / "jax")
    P, L = ref_tr.val_buckets.indices.shape
    ref_tr.eval_step = lambda params, bstats, img, gt, idx, mask: {
        "pred": np.zeros((len(idx), H, H), np.int64)}
    ref_tr.eval_all_models = lambda *args: {"dice2d": np.zeros((P, 2, L, C)),
                                            "dice3d": np.zeros((P, 2, C))}
    for epoch in range(2):
        ref_tr._save_train_predictions(epoch, True)
        ref_tr._eval_epoch(epoch, save=True)

    def pngs(root):
        return sorted(p.relative_to(root) for p in root.rglob("*.png"))
    got = pngs(cli_run["run"])
    assert got == pngs(tmp_path / "jax")
    assert {p.parts[:3] for p in got} == {(f"iter00{e}", mode, s) for e in "01"
                                          for mode in ("train", "unlab", "eval") for s in "01"}
    n_train = sum(len(n) for n in tr._stream_names)
    assert len(got) == 2 * (n_train + len(tr._stream_names[2]) + 2 * len(tr.val_set.filenames))


def test_cli_rejects_what_the_port_does_not_run(tree, tmp_path):
    """``Trainer.parallel=auto`` in one process is dct_tpu's
    ``choose_parallel_mesh(K, 1)``: no mesh, the plain path; a model axis
    of 2 does not divide one rank and raises, as in dct_tpu; an
    ``iters_per_dispatch`` that does not divide the epoch raises."""
    tr = main(cli_args(tree, tmp_path, "Trainer.max_epoch=1", "Trainer.parallel=auto"))
    assert tr.mesh is None and (tmp_path / "metrics.csv").exists()
    with pytest.raises(AssertionError, match="not divisible"):
        main(cli_args(tree, tmp_path / "two", "Trainer.max_epoch=1", "Trainer.parallel=2"))
    with pytest.raises(AssertionError):
        main(cli_args(tree, tmp_path, "Trainer.max_epoch=1", "Trainer.iters_per_dispatch=3"))


def test_fuse_forward_runs_the_unfused_step(tree, tmp_path):
    """``Trainer.fuse_forward`` reaches the step (True: the fused two-group
    forward; False: the unfused one, as this test's name says); either runs
    one epoch with ``Trainer.iters_per_dispatch``."""
    for fuse in (True, False):
        run = tmp_path / str(fuse)
        tr = main(cli_args(tree, run, "Trainer.max_epoch=1", "Trainer.iters_per_epoch=1",
                           f"Trainer.fuse_forward={fuse}", "Trainer.iters_per_dispatch=1"))
        with open(run / "metrics.csv", newline="") as f:
            assert [r["epoch"] for r in csv.DictReader(f)] == ["0"]
        assert tr.iters_per_epoch == 1 and tr.fuse_forward is fuse
