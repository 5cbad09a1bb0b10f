"""The VAT baseline of dct_tpu_torch against dct_tpu, on the CPU, from the
trained weights of ``results/ACDC_vat/best.ckpt`` with float64 network
arithmetic on both sides (parameters and Adam state fp32):

* ``vat_perturbation`` on the same starting noise: ``r_adv``, the
  adversarial image and the running statistics, which only the clean
  forward moves; no parameter ``.grad`` is filled. Held with float64
  logits on both sides (``float64_logits`` says why), and as shipped (fp32
  logits) by norm and direction only;
* two iterations of ``make_vat_epoch`` (B=Bu=2, 32², both augmentations
  on) with λ_adv > 0 and with λ_adv = 0, fed the same indices and
  dct_tpu's own thetas and noise, float64 logits;
* the VatTrainer's host draws against dct_tpu's, and the CLI with a resume.

Four dct_tpu compiles: the perturbation twice and the two epoch variants.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.adversarial import VATGenerator as JaxVATGenerator
from dct_tpu.adversarial import vat_perturbation as jax_vat_perturbation
from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.data.splits import get_dataset_split as jax_get_dataset_split
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train import VatTrainer as JaxVatTrainer
from dct_tpu.train.vat import make_vat_epoch as jax_make_vat_epoch
from dct_tpu_torch.adversarial import VATGenerator, vat_perturbation
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.data.splits import get_dataset_split
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.train import VatTrainer
from dct_tpu_torch.train.vat import make_vat_epoch
from dct_tpu_torch.train_vat import main
from dct_tpu_torch.utils.convert import params_from_jax
from helpers import make_synthetic_acdc
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_jaxref import (ADAM, C, ROOT, float64_logits, jax_segmentator,
                               port_segmentator, rings, stats_error, to_numpy, trained,
                               update_agreement)

B, H, T, N = 2, 32, 2, 12
LR = ADAM["lr"]
EPS, XI, IP = 10.0, 1e-6, 1        # configs/acdc_vat.yaml's Adv_Training
LAM_ADV = 0.5


def images(idx):
    img, _ = rings(N, H, seed=3)
    return (img[idx].astype(np.float32) / 255.0)[..., None]


@pytest.fixture(scope="module", params=["float64", "float32"])
def perturbation(request):
    """One ``vat_perturbation`` on each side from the same noise, with the
    logits in float64 or as shipped."""
    params, batch_stats = trained()
    img = images([0, 5])
    key = jax.random.PRNGKey(9)
    port = port_segmentator(params, batch_stats)
    with jax.enable_x64(True):
        seg = jax_segmentator(params, batch_stats)
        if request.param == "float64":
            float64_logits(seg, port)
        d = np.asarray(jax.random.normal(key, img.shape, jnp.float32))
        # dct_tpu's VATGenerator shim in the same compile: XLA shares its
        # work with the direct call
        (adv, r_adv, new_bs), shim = jax.jit(lambda p, bs, x: (
            jax_vat_perturbation(seg.apply_train, p, bs, x, key, xi=XI, epsilon=EPS, ip=IP),
            JaxVATGenerator(seg.apply_train, XI, EPS, IP)(p, bs, x, key)[:2]))(
            seg.state["params"], seg.state["batch_stats"], jnp.asarray(img))
        ref = {"adv": np.asarray(adv), "r_adv": np.asarray(r_adv),
               "stats": params_from_jax({}, to_numpy(new_bs)),
               "shim": [np.asarray(t) for t in shim]}

    got_adv, got_r = vat_perturbation(port, torch.from_numpy(img), XI, EPS, IP,
                                      d=torch.from_numpy(d))
    shim_seg = port_segmentator(params, batch_stats)
    if request.param == "float64":
        float64_logits(jax_segmentator(params, batch_stats), shim_seg)
    shim = VATGenerator(shim_seg, XI, EPS, IP)(torch.from_numpy(img), d=torch.from_numpy(d))
    clean_only = port_segmentator(params, batch_stats)
    with torch.no_grad():
        clean_only.apply_train(torch.from_numpy(img))
    return {"logits": request.param, "ref": ref, "adv": got_adv.numpy(),
            "r_adv": got_r.numpy(), "stats": port.net.state_dict(),
            "shim": [t.numpy() for t in shim], "shim_stats": shim_seg.net.state_dict(),
            "clean_only": clean_only.net.state_dict(),
            "grads": [p.grad for p in port.net.parameters()]}


def test_vat_perturbation_matches_dct_tpu(perturbation):
    """r_adv of norm ε per sample. With float64 logits it equals dct_tpu's
    to the fp32 rounding of r_adv itself (measured 2.4e-8 of ε; the clamped
    adversarial image 7.5e-8). With fp32 logits it carries each framework's
    fp32 rounding of the KL's gradient (measured 1.1e-5 of ε elementwise):
    held by its direction, cosine to dct_tpu's measured 1 − 1.3e-8."""
    ref, got = perturbation["ref"], perturbation["r_adv"]
    norms = np.sqrt((got.astype(np.float64) ** 2).sum(axis=(1, 2, 3)))
    np.testing.assert_allclose(norms, EPS, rtol=1e-5)
    if perturbation["logits"] == "float64":
        np.testing.assert_allclose(got, ref["r_adv"], rtol=0, atol=1e-6 * EPS)
        np.testing.assert_allclose(perturbation["adv"], ref["adv"], rtol=0, atol=1e-6 * EPS)
    else:
        a, b = got.reshape(2, -1).astype(np.float64), ref["r_adv"].reshape(2, -1)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert (cos > 1 - 1e-6).all(), cos


def test_vat_generator_matches_dct_tpu(perturbation):
    """The ``VATGenerator`` shims (ip = 1) on the same noise: the port's
    (adversarial image, r_adv) equal its direct ``vat_perturbation`` to the
    bit and move the running statistics as it does, in place; dct_tpu's
    first two outputs equal its direct call. So the shim is held to dct_tpu
    by ``test_vat_perturbation_matches_dct_tpu``'s bounds, and directly by
    the float64 one (1e-6 of ε)."""
    (adv, r_adv), ref = perturbation["shim"], perturbation["ref"]
    np.testing.assert_array_equal(adv, perturbation["adv"])
    np.testing.assert_array_equal(r_adv, perturbation["r_adv"])
    for k, v in perturbation["stats"].items():
        assert torch.equal(perturbation["shim_stats"][k], v), k
    np.testing.assert_array_equal(ref["shim"][0], ref["adv"])
    np.testing.assert_array_equal(ref["shim"][1], ref["r_adv"])
    if perturbation["logits"] == "float64":
        np.testing.assert_allclose(r_adv, ref["r_adv"], rtol=0, atol=1e-6 * EPS)
        np.testing.assert_allclose(adv, ref["adv"], rtol=0, atol=1e-6 * EPS)
    assert adv.min() >= 0.0 and adv.max() <= 1.0


def test_vat_generator_needs_noise_or_generator():
    with pytest.raises(ValueError, match="generator"):
        VATGenerator(port_segmentator(*trained()))(torch.zeros(1, H, H, 1))


@pytest.fixture(scope="module", params=[True, False], ids=["adv", "no_adv"])
def epoch_runs(request):
    """Two VAT iterations on each side, with the adversarial term
    (λ_adv = 0.5) or the variant without it (λ_adv = 0)."""
    train_adv = request.param
    lam = LAM_ADV if train_adv else 0.0
    params, batch_stats = trained()
    img, gt = rings(N, H, seed=4)
    rs = np.random.RandomState(6)
    idx_lab = rs.randint(0, N, (T, B)).astype(np.int32)
    idx_unlab = rs.randint(0, N, (T, B)).astype(np.int32)
    key = jax.random.PRNGKey(13)
    port = port_segmentator(params, batch_stats)
    with jax.enable_x64(True):
        seg = jax_segmentator(params, batch_stats)
        float64_logits(seg, port)
        epoch = jax_make_vat_epoch(seg, jax_get_loss_fn("cross_entropy"), C, train_adv,
                                   True, True, EPS, XI, IP)
        new_state, metrics = epoch(seg.state, jnp.asarray(img), jnp.asarray(gt),
                                   jnp.asarray(idx_lab), jnp.asarray(idx_unlab), key, LR, lam)
        # vat.py's draws: fold_in(k_t, 0) labeled thetas, 1 unlabeled, 2 noise
        keys = jax.random.split(key, T)
        draws = {name: np.stack([np.asarray(fn(jax.random.fold_in(k, i))) for k in keys])
                 for name, i, fn in (
                     ("thetas_lab", 0, lambda k: jax_sample_aug_thetas(k, B, H, H)),
                     ("thetas_unlab", 1, lambda k: jax_sample_aug_thetas(k, B, H, H)),
                     ("noise", 2, lambda k: jax.random.normal(k, (B, H, H, 1), jnp.float32)))}
        ref = {"metrics": to_numpy(metrics),
               "new": params_from_jax(to_numpy(new_state["params"]),
                                      to_numpy(new_state["batch_stats"]))}

    initial = {k: v.clone() for k, v in port.net.state_dict().items()}
    got = make_vat_epoch(port, get_loss_fn("cross_entropy"), C, train_adv, True, True,
                         EPS, XI, IP)(
        torch.from_numpy(img), torch.from_numpy(gt), idx_lab, idx_unlab, None, LR, lam,
        **{k: torch.from_numpy(v) for k, v in draws.items()})
    return {"train_adv": train_adv, "ref": ref, "initial": initial,
            "got": {"metrics": {k: v.numpy() for k, v in got.items()},
                    "new": port.net.state_dict()}}


def test_vat_epoch_losses_and_dice_match_dct_tpu(epoch_runs):
    """Measured 1.2e-7 of the supervised loss and 3.8e-7 of the adversarial
    KL apart; the hard dice rows see no argmax flip (equal)."""
    ref, got = epoch_runs["ref"]["metrics"], epoch_runs["got"]["metrics"]
    np.testing.assert_allclose(got["sup_loss"], ref["sup_loss"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["adv_loss"], ref["adv_loss"], rtol=1e-5, atol=1e-9)
    assert (got["adv_loss"] > 0).all() == epoch_runs["train_adv"]
    assert got["dice"].shape == ref["dice"].shape == (T, B, C)
    np.testing.assert_allclose(got["dice"], ref["dice"], rtol=0, atol=1e-6)


def test_vat_epoch_update_and_stats_match_dct_tpu(epoch_runs):
    """The two-step update and the running statistics after four train-mode
    forwards an iteration (one without the term), in dct_tpu's order:
    measured cosine 1 − 1.5e-12, 1.5e-7 of the parameters' scale (one fp32
    ulp), statistics within 3e-7 of theirs."""
    cos, diff = update_agreement(epoch_runs["initial"], epoch_runs["ref"]["new"],
                                 epoch_runs["got"]["new"])
    assert cos > 1 - 1e-9, cos
    assert diff < 5e-6, diff
    assert stats_error(epoch_runs["ref"]["new"], epoch_runs["got"]["new"]) < 1e-6


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """100 train patients × 1 slice (20 labeled: 10 iterations an epoch at
    B=2), 2 val patients × 2 slices."""
    return make_synthetic_acdc(tmp_path_factory.mktemp("acdc"), n_train_patients=100,
                               n_val_patients=2, slices_per_patient=1, size=H)


def cli_args(tree, run, *extra):
    return ["--device", "cpu", "--config", str(ROOT / "configs" / "acdc_vat.yaml"),
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
        rows = list(csv.reader(f))
    with open(ROOT / "results" / "ACDC_vat" / "metrics.csv", newline="") as f:
        assert rows[0] == next(csv.reader(f))
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    assert all(float(r[1 + rows[0][1:].index("adv_loss")]) > 0 for r in rows[1:])
    assert sorted(p.name for p in run.iterdir()) == ["best.ckpt", "config.yml",
                                                     "last.ckpt", "metrics.csv"]
    resumed = cli_run["resumed"]
    assert resumed.start_epoch == 1 and resumed.adv_scheduler.epoch == 2
    steps = {float(st["step"]) for st in resumed.segmentator.optimizer.state.values()}
    assert steps == {20.0}                       # 2 epochs × 10 iterations
    last = load_checkpoint(run / "last.ckpt")
    assert last.keys() == {"segmentator", "best_score", "best_epoch", "adv_scheduler"}
    assert int(last["segmentator"]["optim_state_dict"]["count"]) == 20


def test_host_draws_equal_dct_tpus(tree, tmp_path):
    """Both VatTrainers on the same split and seed: the same concatenated
    slices and offset, and the same labeled and unlabeled indices over two
    epochs (labeled stream's take, then the unlabeled one's)."""
    cfg = {"Dataset": {"root_dir": str(tree), "subfolders": ["img", "gt"],
                       "transform": f"segment_transform(({H},{H}))"},
           "Lab_Partitions": {"num_models": 1, "partition_sets": 0.2,
                              "partition_overlap": 1}}
    splits = []
    for fn in (jax_get_dataset_split, get_dataset_split):
        np.random.seed(1234)
        splits.append(fn(cfg, "acdc"))
    params, batch_stats = trained()
    (ref_lab,), ref_unlab, ref_val = splits[0]
    (lab,), unlab, val = splits[1]
    ref = JaxVatTrainer(jax_segmentator(params, batch_stats, compute_dtype="float32"),
                        ref_lab, ref_unlab, ref_val, None, save_dir=tmp_path / "jax",
                        batch_size=3, seed=77)
    got = VatTrainer(port_segmentator(params, batch_stats), lab, unlab, val, None,
                     save_dir=tmp_path / "port", batch_size=3, seed=77, device="cpu")
    np.testing.assert_array_equal(got._img_cat.numpy(), np.asarray(ref._img_cat))
    assert got._unlab_offset == ref._unlab_offset == 20
    assert got.iters_per_epoch == ref.iters_per_epoch == 6
    for _ in range(2):
        idx_lab, idx_unlab = got.draw_indices()
        np.testing.assert_array_equal(idx_lab, ref.lab_batcher.take(6))
        np.testing.assert_array_equal(idx_unlab, 20 + ref.unlab_batcher.take(6))
