"""The supervised baseline of dct_tpu_torch against dct_tpu, on the CPU:
two iterations of ``make_supervised_epoch`` (B=2, 32², augmentation on)
held against ``dct_tpu.train.steps.make_supervised_epoch`` from the trained
weights of ``results/ACDC_vat/best.ckpt``, fed the same batch indices and
dct_tpu's own augmentation thetas, with float64 network arithmetic on both
sides (parameters, Adam state and logits fp32, as in test_torch_slice.py);
the Trainer's batch indices against dct_tpu's Trainer; and the CLI with a
resume. One dct_tpu compile (the epoch).
"""
import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.data.dataset import MedicalImageDataset as JaxDataset
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train import Trainer as JaxTrainer
from dct_tpu.train.steps import make_supervised_epoch as jax_make_supervised_epoch
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.data.dataset import MedicalImageDataset
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.train import Trainer
from dct_tpu_torch.train.steps import make_supervised_epoch
from dct_tpu_torch.train_sup import main
from dct_tpu_torch.utils.convert import params_from_jax
from helpers import make_synthetic_acdc
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_jaxref import (ADAM, C, ROOT, jax_segmentator, port_segmentator, rings,
                               stats_error, to_numpy, trained, update_agreement)

B, H, T, N = 2, 32, 2, 12
LR = ADAM["lr"]


@pytest.fixture(scope="module")
def runs():
    params, batch_stats = trained()
    img, gt = rings(N, H, seed=1)
    idx = np.random.RandomState(2).randint(0, N, (T, B)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        seg = jax_segmentator(params, batch_stats)
        epoch = jax_make_supervised_epoch(seg, jax_get_loss_fn("cross_entropy"), C, True)
        new_state, metrics = epoch(seg.state, jnp.asarray(img), jnp.asarray(gt),
                                   jnp.asarray(idx), key, LR)
        # the thetas the epoch drew: gather_augment_u8 with the t-th key
        thetas = np.stack([np.asarray(jax_sample_aug_thetas(k, B, H, H))
                           for k in jax.random.split(key, T)])
        ref = {"metrics": to_numpy(metrics),
               "new": params_from_jax(to_numpy(new_state["params"]),
                                      to_numpy(new_state["batch_stats"]))}

    port = port_segmentator(params, batch_stats)
    initial = {k: v.clone() for k, v in port.net.state_dict().items()}
    got = make_supervised_epoch(port, get_loss_fn("cross_entropy"), C, True)(
        torch.from_numpy(img), torch.from_numpy(gt), idx, None, LR,
        thetas=torch.from_numpy(thetas))
    return {"ref": ref, "initial": initial,
            "got": {"metrics": {k: v.numpy() for k, v in got.items()},
                    "new": port.net.state_dict()}}


def test_supervised_losses_match_dct_tpu(runs):
    """fp32 logits and CE on both sides, reduced in another order: measured
    1.05e-6 of the loss apart."""
    ref, got = runs["ref"]["metrics"]["loss"], runs["got"]["metrics"]["loss"]
    assert got.shape == ref.shape == (T,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_supervised_dice_rows_match_dct_tpu(runs):
    """Hard dice of the same argmax: equal to fp32 rounding (no flip)."""
    ref, got = runs["ref"]["metrics"]["dice"], runs["got"]["metrics"]["dice"]
    assert got.shape == ref.shape == (T, B, C)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_supervised_parameter_update_matches_dct_tpu(runs):
    """The two-step update (new − initial): measured cosine 1 − 1.2e-11 and
    largest element difference 7.4e-7 of the parameter's scale (updates
    are ~2e-3): the CE's fp32 logit gradients round differently by ~1e-6
    of themselves, and Adam passes that on."""
    cos, diff = update_agreement(runs["initial"], runs["ref"]["new"], runs["got"]["new"])
    assert cos > 1 - 1e-9, cos
    assert diff < 5e-6, diff


def test_supervised_batch_stats_match_dct_tpu(runs):
    """Two train-mode forwards: measured 1.2e-7 of each leaf's scale (fp32
    running statistics)."""
    assert stats_error(runs["ref"]["new"], runs["got"]["new"]) < 1e-6


# ---------------------------------------------------------------- the CLI

HEADER = (["epoch"] + [f"{p}_{i}" for p in ("train_dice", "val_dice", "val_batch_dice")
                       for i in (1, 2, 3)]
          + ["train_loss", "val_loss", "images_per_sec", "t_train", "t_eval"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 train patients × 2 slices (8 iterations an epoch at B=2), 3 val."""
    return make_synthetic_acdc(tmp_path_factory.mktemp("acdc"), n_train_patients=8,
                               n_val_patients=3, slices_per_patient=2, size=H)


def cli_args(tree, run, *extra):
    return ["--device", "cpu", "--config", str(ROOT / "configs" / "acdc_supervised.yaml"),
            f"Dataset.root_dir={tree}", f"Dataset.transform=segment_transform(({H},{H}))",
            f"Trainer.save_dir={run}", "Dataloader.batch_size=2", *extra]


@pytest.fixture(scope="module")
def cli_run(tree, tmp_path_factory):
    """2 epochs, then a resume from last.ckpt to epoch 3."""
    run = tmp_path_factory.mktemp("cli") / "run"
    first = main(cli_args(tree, run, "Trainer.max_epoch=2"))
    after_two = (run / "metrics.csv").read_text()
    resumed = main(cli_args(tree, run, "Trainer.max_epoch=3",
                            f"Trainer.checkpoint={run / 'last.ckpt'}"))
    return {"run": run, "first": first, "resumed": resumed, "after_two": after_two}


def test_cli_writes_dct_tpus_outputs(cli_run):
    run = cli_run["run"]
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == HEADER
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    assert all(0 <= float(v) <= 1 for r in rows[1:] for v, c in zip(r, HEADER) if "dice" in c)
    assert cli_run["after_two"].splitlines() == (run / "metrics.csv").read_text().splitlines()[:3]
    assert sorted(p.name for p in run.iterdir()) == [
        "best.ckpt", "config.yml", "last.ckpt", "metrics.csv", "train_dice.npy", "val_dice.npy"]
    assert np.load(run / "val_dice.npy").shape == np.load(run / "train_dice.npy").shape == (3, 3)


def test_cli_resume_continues_adam_and_the_lr_epoch(cli_run):
    """Each epoch is a full pass of the 16 train slices, 8 iterations: the
    resumed run's Adam steps continue from the checkpoint's count."""
    first, resumed = cli_run["first"], cli_run["resumed"]
    assert resumed.start_epoch == 2 and resumed.segmentator.epoch == 3
    steps = {float(st["step"]) for st in first.segmentator.optimizer.state.values()}
    assert steps == {16.0}
    steps = {float(st["step"]) for st in resumed.segmentator.optimizer.state.values()}
    assert steps == {24.0}
    last = load_checkpoint(cli_run["run"] / "last.ckpt")
    assert last.keys() == {"segmentator", "best_score", "best_epoch"}
    assert int(last["segmentator"]["optim_state_dict"]["count"]) == 24
    assert last["segmentator"]["scheduler_state_dict"] == {"epoch": 3}


def test_batch_indices_equal_dct_tpus(tree, tmp_path):
    """The port's Trainer and dct_tpu's on the same train set and seed draw
    the same (T, B) indices, epoch after epoch (one permutation each)."""
    params, batch_stats = trained()
    kw = {"subfolders": ["img", "gt"], "transform": f"segment_transform(({H},{H}))",
          "quite": True}
    ref = JaxTrainer(jax_segmentator(params, batch_stats, compute_dtype="float32"),
                     {m: JaxDataset(tree, m, **kw) for m in ("train", "val")}, None,
                     save_dir=tmp_path / "jax", batch_size=2, seed=77)
    got = Trainer(
        port_segmentator(params, batch_stats),
        {m: MedicalImageDataset(tree, m, **kw) for m in ("train", "val")}, None,
        save_dir=tmp_path / "port", batch_size=2, seed=77, device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(got.draw_indices(), ref.batcher.epoch(ref.rs))
    assert got.axises == ref.axises == [1, 2, 3]


def test_cli_rejects_parallel(tree, tmp_path):
    """``Trainer.parallel`` is dct_tpu's ``data_parallel_mesh(world)``: in
    one process no mesh, and the plain path trains."""
    tr = main(cli_args(tree, tmp_path, "Trainer.max_epoch=1", "Trainer.parallel=auto"))
    assert tr.mesh is None
    assert Path(tmp_path, "metrics.csv").exists()
