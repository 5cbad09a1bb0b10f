"""The Mean-Teacher baseline of dct_tpu_torch against dct_tpu, on the CPU:
two iterations of ``make_mean_teacher_epoch`` (B=Bu=2, 32², λ_con 0.5) from
the trained student and teacher of
``results/ACDC_meanteacher/best_0.7408_85.ckpt``, fed the same indices and
dct_tpu's own thetas, with float64 network arithmetic on both sides
(parameters, Adam state and logits fp32): losses, both dice sets, the
student's update, the teacher's EMA parameters and both sets of running
statistics. Also ``apply_thetas``, the MeanTeacherTrainer's host draws and
the CLI with a resume and the ``best_*`` rotation. One dct_tpu compile
(the epoch).
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.data.augment import apply_thetas as jax_apply_thetas
from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.data.splits import get_dataset_split as jax_get_dataset_split
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train import MeanTeacherTrainer as JaxMeanTeacherTrainer
from dct_tpu.train.mean_teacher import make_mean_teacher_epoch as jax_make_mt_epoch
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.data.augment import apply_thetas
from dct_tpu_torch.data.splits import get_dataset_split
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.train import MeanTeacherTrainer
from dct_tpu_torch.train.mean_teacher import make_mean_teacher_epoch
from dct_tpu_torch.train_mean_teacher import main
from dct_tpu_torch.utils.convert import params_from_jax
from helpers import make_synthetic_acdc
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_jaxref import (ADAM, C, MT_CKPT, ROOT, jax_segmentator, port_segmentator,
                               rings, stats_error, to_numpy, trained, update_agreement)

B, H, T, N = 2, 32, 2, 12
LR = ADAM["lr"]
LAM_CON = 0.5


@pytest.fixture(scope="module")
def runs():
    student, teacher = trained(MT_CKPT, "student"), trained(MT_CKPT, "teacher")
    img, gt = rings(N, H, seed=7)
    rs = np.random.RandomState(8)
    idx_lab = rs.randint(0, N, (T, B)).astype(np.int32)
    idx_unlab = rs.randint(0, N, (T, B)).astype(np.int32)
    key = jax.random.PRNGKey(21)
    with jax.enable_x64(True):
        seg = jax_segmentator(*student)
        state = {"student": dict(seg.state),
                 "teacher": {"params": jax.tree_util.tree_map(jnp.asarray, teacher[0]),
                             "batch_stats": jax.tree_util.tree_map(jnp.asarray, teacher[1])}}
        epoch = jax_make_mt_epoch(seg, jax_get_loss_fn("cross_entropy"), C, 0.99)
        new_state, metrics = epoch(state, jnp.asarray(img), jnp.asarray(gt),
                                   jnp.asarray(idx_lab), jnp.asarray(idx_unlab), key, LR,
                                   LAM_CON)
        # mean_teacher.py's draws: fold_in(k_t, 0) labeled view, 1 unlabeled
        keys = jax.random.split(key, T)
        thetas = {name: np.stack([np.asarray(jax_sample_aug_thetas(
                      jax.random.fold_in(k, i), B, H, H)) for k in keys])
                  for name, i in (("thetas", 0), ("thetas_u", 1))}
        ref = {"metrics": to_numpy(metrics),
               **{who: params_from_jax(to_numpy(new_state[who]["params"]),
                                       to_numpy(new_state[who]["batch_stats"]))
                  for who in ("student", "teacher")}}

    s_port, t_port = port_segmentator(*student), port_segmentator(*teacher)
    initial = {who: {k: v.clone() for k, v in s.net.state_dict().items()}
               for who, s in (("student", s_port), ("teacher", t_port))}
    got = make_mean_teacher_epoch(s_port, t_port, get_loss_fn("cross_entropy"), C, 0.99)(
        torch.from_numpy(img), torch.from_numpy(gt), idx_lab, idx_unlab, None, LR, LAM_CON,
        **{k: torch.from_numpy(v) for k, v in thetas.items()})
    return {"ref": ref, "initial": initial,
            "got": {"metrics": {k: v.numpy() for k, v in got.items()},
                    "student": s_port.net.state_dict(), "teacher": t_port.net.state_dict()},
            "teacher_grads": [p.grad for p in t_port.net.parameters()]}


@pytest.mark.parametrize("name", ["sup_loss", "con_loss", "student_dice", "teacher_dice"])
def test_mean_teacher_metrics_match_dct_tpu(runs, name):
    """fp32 logits and losses on both sides, reduced in another order:
    losses within 1e-5 of themselves (measured 4.9e-7 for the CE, 1.4e-7
    for the consistency); the hard dice rows see no argmax flip (equal)."""
    ref, got = runs["ref"]["metrics"][name], runs["got"]["metrics"][name]
    assert got.shape == ref.shape == ((T,) if "loss" in name else (T, B, C))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("who", ["student", "teacher"])
def test_mean_teacher_update_matches_dct_tpu(runs, who):
    """The student's two Adam steps and the teacher's two EMA steps after
    them (parameters only): measured cosine 1 − 3.2e-13 (student) and 1 −
    4.9e-10 (teacher, whose update of 1 % of the gap to the student is a few
    fp32 ulps of its parameters), 4.5e-8 and 1.2e-7 of the parameters'
    scale (one fp32 ulp)."""
    cos, diff = update_agreement(runs["initial"][who], runs["ref"][who], runs["got"][who])
    assert cos > 1 - 1e-8, cos
    assert diff < 5e-6, diff


@pytest.mark.parametrize("who", ["student", "teacher"])
def test_mean_teacher_batch_stats_match_dct_tpu(runs, who):
    """Each net's running statistics move only through its own two
    train-mode forwards an iteration, the EMA leaves the teacher's alone:
    measured within 1.8e-7 (student) and 2.0e-7 (teacher) of dct_tpu's."""
    assert stats_error(runs["ref"][who], runs["got"][who]) < 1e-6
    assert all(g is None for g in runs["teacher_grads"])


@pytest.mark.parametrize("channels", [None, 1, 4])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_apply_thetas_matches_dct_tpu(method, channels):
    """(B,H,W), (B,H,W,1) and (B,H,W,4) warps by dct_tpu's thetas: the same
    float32 arithmetic in the same order, exact."""
    shape = (3, 24, 16) + (() if channels is None else (channels,))
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    th = np.asarray(jax_sample_aug_thetas(jax.random.PRNGKey(1), 3, 24, 16))
    ref = np.asarray(jax_apply_thetas(jnp.asarray(x), jnp.asarray(th), method))
    got = apply_thetas(torch.from_numpy(x), torch.from_numpy(th), method).numpy()
    assert got.shape == ref.shape == shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """100 train patients × 1 slice (20 labeled: 10 iterations an epoch at
    B=2), 2 val patients × 2 slices."""
    return make_synthetic_acdc(tmp_path_factory.mktemp("acdc"), n_train_patients=100,
                               n_val_patients=2, slices_per_patient=1, size=H)


def cli_args(tree, run, *extra):
    return ["--device", "cpu", "--config", str(ROOT / "configs" / "acdc_meanteacher.yaml"),
            f"Dataset.root_dir={tree}", f"Dataset.transform=segment_transform(({H},{H}))",
            f"Trainer.save_dir={run}", "Lab_Dataloader.batch_size=2", *extra]


@pytest.fixture(scope="module")
def cli_run(tree, tmp_path_factory):
    run = tmp_path_factory.mktemp("cli") / "run"
    first = main(cli_args(tree, run, "Trainer.max_epoch=1"))
    resumed = main(cli_args(tree, run, "Trainer.max_epoch=2",
                            f"Trainer.checkpoint={run / 'last.ckpt'}"))
    return {"run": run, "first": first, "resumed": resumed}


def test_cli_writes_dct_tpus_outputs_and_resumes(cli_run):
    run = cli_run["run"]
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open(ROOT / "results" / "ACDC_meanteacher" / "metrics.csv", newline="") as f:
        assert list(rows[0]) == next(csv.reader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in rows for v in r.values())
    (best,) = run.glob("best_*.ckpt")
    scores = [np.mean([float(r[f"val_teacher_2d_dice_{i}"]) for i in (1, 2, 3)])
              for r in rows]
    epoch = int(np.argmax(scores))
    assert best.name == f"best_{load_checkpoint(best)['metric']:.4f}_{epoch}.ckpt"
    assert {p.name for p in run.iterdir()} == {best.name, "last.ckpt", "metrics.csv",
                                               "mt_config.yml"}
    resumed = cli_run["resumed"]
    assert resumed.start_epoch == 1 and resumed.con_scheduler.epoch == 2
    steps = {float(st["step"]) for st in resumed.student.optimizer.state.values()}
    assert steps == {20.0}                       # 2 epochs × 10 iterations
    last = load_checkpoint(run / "last.ckpt")
    assert last.keys() == {"student", "teacher", "metric", "epoch", "con_scheduler"}
    assert "optim_state_dict" not in last["teacher"]
    assert int(last["student"]["optim_state_dict"]["count"]) == 20
    assert last["student"]["scheduler_state_dict"] == last["teacher"][
        "scheduler_state_dict"] == {"epoch": 2}


def test_best_checkpoint_rotates(cli_run, tmp_path):
    """A better teacher replaces the one ``best_*`` file; a worse one
    leaves it."""
    trainer = cli_run["resumed"]
    trainer.save_dir, trainer.best_score = tmp_path, 0.5
    for metric, epoch in ((0.6, 5), (0.55, 6), (0.7, 7)):
        trainer.save_checkpoint(metric, epoch)
    assert sorted(p.name for p in tmp_path.glob("best_*")) == ["best_0.7000_7.ckpt"]


def test_host_draws_equal_dct_tpus(tree, tmp_path):
    """Both trainers on the same split and seed: the same concatenated
    slices and offset, and the same indices over two epochs."""
    cfg = {"Dataset": {"root_dir": str(tree), "subfolders": ["img", "gt"],
                       "transform": f"segment_transform(({H},{H}))"},
           "Lab_Partitions": {"num_models": 1, "partition_sets": 0.2,
                              "partition_overlap": 1}}
    splits = []
    for fn in (jax_get_dataset_split, get_dataset_split):
        np.random.seed(1234)
        splits.append(fn(cfg, "acdc"))
    student, teacher = trained(MT_CKPT, "student"), trained(MT_CKPT, "teacher")
    (ref_lab,), ref_unlab, ref_val = splits[0]
    (lab,), unlab, val = splits[1]
    ref = JaxMeanTeacherTrainer(
        jax_segmentator(*student, compute_dtype="float32"),
        jax_segmentator(*teacher, compute_dtype="float32"), ref_lab, ref_unlab, ref_val,
        {"sup": None}, save_dir=tmp_path / "jax", batch_size=3, seed=77)
    got = MeanTeacherTrainer(port_segmentator(*student), port_segmentator(*teacher),
                             lab, unlab, val, {"sup": None}, save_dir=tmp_path / "port",
                             batch_size=3, seed=77, device="cpu")
    np.testing.assert_array_equal(got._img_cat.numpy(), np.asarray(ref._img_cat))
    assert got._unlab_offset == ref._unlab_offset == 20
    assert got.iters_per_epoch == ref.iters_per_epoch == 6
    for _ in range(2):
        idx_lab, idx_unlab = got.draw_indices()
        np.testing.assert_array_equal(idx_lab, ref.lab_batcher.take(6))
        np.testing.assert_array_equal(idx_unlab, 20 + ref.unlab_batcher.take(6))
