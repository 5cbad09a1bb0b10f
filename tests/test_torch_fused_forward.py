"""The fused two-group forward and ``adv_dtype`` of the co-training step,
on the CPU: the port's fused step against its own unfused step, and
against ``dct_tpu.train.steps.make_cotrain_epoch`` (fused, its default),
``adv_dtype`` equal to the compute dtype, and the CLI's two keys
(``adv_dtype=float32`` under a float64 main pass is held against dct_tpu
in ``test_torch_adv_dtype.py``).

One iteration, K=2, B=Bu=2, 32², jsd + FGSM + augmentation, λ_cot 0.5 and
λ_adv 0.05. Both models start from the port's own init (seeds 0 and 1),
carried to dct_tpu by ``utils/convert.py:params_to_jax``; the same batch
indices go to both, and the port gets the thetas dct_tpu's epoch drew.
Parameters, Adam state, images, logits and losses are fp32; the networks
compute in float64 (as in ``test_torch_slice.py``, which says why), except
where the fp32 models test ``adv_dtype``. Adam's eps is 1e-3 for the
reason given there. One dct_tpu epoch is compiled: the fused step.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train.steps import make_cotrain_epoch as jax_make_cotrain_epoch
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train.steps import make_cotrain_epoch
from dct_tpu_torch.train_cotraining import main as cli_main
from dct_tpu_torch.utils.convert import params_from_jax_stacked, params_to_jax
from test_torch_cotrainer import cli_args, tree  # noqa: F401  (fixture)
from test_torch_jaxref import jax_segmentator, one_torch_thread  # noqa: F401

K, B, H, T, N, C = 2, 2, 32, 1, 16, 4
LR, LAM_COT, LAM_ADV = 1e-3, 0.5, 0.05
ARCH = {"name": "enet", "num_classes": C}
ADAM = {"name": "Adam", "lr": LR, "weight_decay": 1e-4, "eps": 1e-3}
STEP = {"name": "StepLR", "step_size": 90, "gamma": 0.1}
QUANTITIES = ["sup_loss", "jsd_loss", "adv_loss", "params_0", "params_1",
              "stats_0", "stats_1"]


def port_models(compute_dtype=torch.float64):
    segs = [Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(i), device="cpu")
            for i in range(K)]
    for s in segs:
        s.compute_dtype = compute_dtype        # the network arithmetic only
    return segs


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    trees = [params_to_jax(s.net.state_dict()) for s in port_models()]
    return {"params": jax.tree_util.tree_map(lambda *a: np.stack(a), *[t[0] for t in trees]),
            "batch_stats": jax.tree_util.tree_map(lambda *a: np.stack(a),
                                                  *[t[1] for t in trees]),
            "img": rs.randint(0, 255, (N, H, H), dtype=np.uint8),
            "gt": rs.randint(0, C, (N, H, H)).astype(np.uint8),
            "idx_lab": rs.randint(0, N, (T, K, B)).astype(np.int32),
            "idx_unlab": rs.randint(0, N, (T, B)).astype(np.int32)}


def jax_epoch(data, adv_dtype=None):
    """dct_tpu's fused epoch (float64 network) from ``data``; returns its
    metrics, new weights as port state_dicts and the thetas it drew."""
    with jax.enable_x64(True):
        seg = jax_segmentator(jax.tree_util.tree_map(lambda a: a[0], data["params"]),
                              jax.tree_util.tree_map(lambda a: a[0], data["batch_stats"]),
                              optim=ADAM, arch=ARCH, sched=STEP)
        params = jax.tree_util.tree_map(jnp.asarray, data["params"])
        state = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, data["batch_stats"]),
                 "opt_state": seg.tx.init(params)}
        key = jax.random.PRNGKey(11)
        epoch = jax_make_cotrain_epoch(seg, K, C, jax_get_loss_fn("cross_entropy"),
                                       True, True, True, True, 0.03, adv_dtype=adv_dtype)
        new, metrics = epoch(state, jnp.asarray(data["img"]), jnp.asarray(data["gt"]),
                             data["idx_lab"], data["idx_unlab"],
                             np.tile(np.array([0, 1], np.int32), (T, 1)), key,
                             LR, LAM_COT, LAM_ADV)
        keys = jax.random.split(key, T)
        thetas = np.stack([np.concatenate(
            [np.asarray(jax_sample_aug_thetas(jax.random.fold_in(keys[t], i), B, H, H))
             for i in range(K)]
            + [np.asarray(jax_sample_aug_thetas(jax.random.fold_in(keys[t], 101), B, H, H))])
            for t in range(T)])
        return {"metrics": jax.tree_util.tree_map(np.asarray, metrics), "thetas": thetas,
                "new": params_from_jax_stacked(
                    jax.tree_util.tree_map(np.asarray, new["params"]),
                    jax.tree_util.tree_map(np.asarray, new["batch_stats"]), K)}


def port_epoch(data, thetas, compute_dtype=torch.float64, **kw):
    """The port's step from ``data``'s weights on the given thetas."""
    segs = port_models(compute_dtype)
    for s, sd in zip(segs, params_from_jax_stacked(data["params"], data["batch_stats"], K)):
        s.net.load_state_dict(sd)
    epoch = make_cotrain_epoch(segs, C, get_loss_fn("cross_entropy"), True, True, True,
                               True, 0.03, **kw)
    metrics = epoch(torch.from_numpy(data["img"]), torch.from_numpy(data["gt"]),
                    data["idx_lab"], data["idx_unlab"], None, None, LR, LAM_COT, LAM_ADV,
                    thetas=torch.from_numpy(thetas))
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "new": [{k: v.clone() for k, v in s.net.state_dict().items()} for s in segs]}


@pytest.fixture(scope="module")
def jax_fused(data):
    return jax_epoch(data)


@pytest.fixture(scope="module")
def runs(data, jax_fused):
    """The port's fused and unfused steps on dct_tpu's thetas."""
    return {fuse: port_epoch(data, jax_fused["thetas"], fuse_forward=fuse)
            for fuse in (True, False)}


def difference(ref, got, quantity):
    """Largest difference of a loss (absolute), of a model's new parameters
    (relative to each parameter's magnitude, at least 1: they are fp32, so
    they agree at best to an ulp of themselves) or of its running
    statistics (relative to each leaf's scale, at least 1)."""
    if quantity.endswith("loss"):
        return float(np.abs(got["metrics"][quantity] - ref["metrics"][quantity]).max())
    kind, model = quantity.split("_")
    r, g = ref["new"][int(model)], got["new"][int(model)]
    if kind == "params":
        return max(float(((g[k].double() - r[k].double()).abs()
                          / r[k].double().abs().clamp_min(1.0)).max())
                   for k in r if "running" not in k)
    return max(float((g[k].double() - r[k].double()).abs().max())
               / max(1.0, float(r[k].double().abs().max())) for k in r if "running" in k)


# fused against unfused in the port: the same arithmetic up to the order of
# the per-half statistics (measured: jsd 3.7e-9, parameters one fp32 ulp)
FUSED_TOL = {"sup_loss": 1e-6, "jsd_loss": 1e-6, "adv_loss": 1e-6, "params_0": 3e-7,
             "params_1": 3e-7, "stats_0": 1e-6, "stats_1": 1e-6}


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_port_fused_equals_unfused(runs, quantity):
    assert difference(runs[False], runs[True], quantity) <= FUSED_TOL[quantity]


# against dct_tpu's fused epoch: fp32 rounding of the losses (the logits
# come back as fp32 on both sides); the running statistics to fp32
# rounding; the fp32 parameters of model 1 (b) to a few ulps after one Adam
# step, model 0's (a) to 3e-6: it takes the adversarial term, whose FGSM
# sign flips at the pixels where the two float64 input gradients round to
# opposite signs (measured 1.15e-6; the adversarial losses agree to 3.9e-7)
JAX_TOL = {"sup_loss": 1e-5, "jsd_loss": 1e-5, "adv_loss": 1e-5, "params_0": 3e-6,
           "params_1": 1e-6, "stats_0": 1e-5, "stats_1": 1e-5}


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_port_fused_matches_dct_tpu(jax_fused, runs, quantity):
    assert difference(jax_fused, runs[True], quantity) <= JAX_TOL[quantity]


@pytest.fixture(scope="module")
def fp32_pair(data, jax_fused):
    """fp32 models: the plain step and the step with ``adv_dtype="float32"``."""
    return [port_epoch(data, jax_fused["thetas"], torch.float32, **kw)
            for kw in ({}, {"adv_dtype": "float32"})]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_adv_dtype_equal_to_compute_dtype_is_the_plain_step(fp32_pair, quantity):
    """``adv_dtype`` equal to the compute dtype runs exactly the plain step."""
    assert difference(*fp32_pair, quantity) == 0.0


@pytest.mark.parametrize("fuse,adv_dtype", [("False", "float32"), ("True", "bfloat16")])
def test_cli_reads_fuse_forward_and_adv_dtype(tree, tmp_path, fuse, adv_dtype):  # noqa: F811
    """``Trainer.fuse_forward`` and ``Trainer.adv_dtype`` reach the step."""
    tr = cli_main(cli_args(tree, tmp_path, "Trainer.max_epoch=1", "Trainer.iters_per_epoch=1",
                           f"Trainer.fuse_forward={fuse}", f"Trainer.adv_dtype={adv_dtype}"))
    assert tr.fuse_forward is (fuse == "True") and tr.adv_dtype == adv_dtype
    with open(tmp_path / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0"] and float(rows[0]["adv_loss"]) > 0
