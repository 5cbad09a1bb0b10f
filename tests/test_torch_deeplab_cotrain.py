"""One fused co-training iteration of two DeepLabV3+ nets against dct_tpu's
compiled ``make_cotrain_epoch``, on the CPU.

Two ``deeplabv3plus`` at ResNet-101's widths, ``n_blocks`` (1, 1, 1, 1)
and multi-grid (1,), from the port's init (seeds 0 and 1) carried to
dct_tpu; 32² one-channel images, B = Bu = 2, JSD and FGSM on, λ_cot 0.5
and λ_adv 0.05, Adam (eps 1e-3, for the reason ``test_torch_jaxref.py``
gives), no augmentation (``test_torch_dropout_paths.py`` says why). The
labeled and unlabeled forwards run fused in both (JSD on, B == Bu, the
arch has a BN momentum): each BatchNorm, the image-pool one over its two
values a channel included, normalises each half alone and folds the
halves into its statistics at momentum 0.001. Networks in float64,
parameters and statistics fp32, logits fp32 on both sides: the losses to
2e-6 of themselves, each model's update to cosine 1 − 1e-9 and 5e-6 of
the parameters' scale, the running statistics to 1e-6 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train.steps import make_cotrain_epoch as jax_cotrain_epoch
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train.steps import make_cotrain_epoch
from dct_tpu_torch.utils.convert import params_from_jax_stacked, params_to_jax
from test_torch_jaxref import (jax_segmentator, one_torch_thread,  # noqa: F401
                               stats_error, update_agreement)

K, B, H, N, C = 2, 2, 32, 8, 4
LR, LAM_COT, LAM_ADV = 1e-3, 0.5, 0.05
ARCH = {"name": "deeplabv3plus", "num_classes": C, "n_blocks": [1, 1, 1, 1], "grids": [1]}
ADAM = {"name": "Adam", "lr": LR, "weight_decay": 1e-4, "eps": 1e-3}
STEP = {"name": "StepLR", "step_size": 90, "gamma": 0.1}


@pytest.fixture(scope="module")
def cotrain():
    segs = [Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(i), device="cpu",
                        in_channels=1) for i in range(K)]
    trees = [params_to_jax(s.net.state_dict()) for s in segs]
    params = jax.tree_util.tree_map(lambda *a: np.stack(a), *[t[0] for t in trees])
    stats = jax.tree_util.tree_map(lambda *a: np.stack(a), *[t[1] for t in trees])
    rs = np.random.RandomState(3)
    img = rs.randint(0, 255, (N, H, H), dtype=np.uint8)
    gt = rs.randint(0, C, (N, H, H)).astype(np.uint8)
    idx_lab = rs.randint(0, N, (1, K, B)).astype(np.int32)
    idx_unlab = rs.randint(0, N, (1, B)).astype(np.int32)
    with jax.enable_x64(True):
        seg = jax_segmentator(jax.tree_util.tree_map(lambda a: a[0], params),
                              jax.tree_util.tree_map(lambda a: a[0], stats),
                              optim=ADAM, arch=ARCH, sched=STEP)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = {"params": p, "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats),
                 "opt_state": seg.tx.init(p)}
        epoch = jax_cotrain_epoch(seg, K, C, jax_get_loss_fn("cross_entropy"),
                                  True, True, False, False, 0.03)
        new, metrics = epoch(state, jnp.asarray(img), jnp.asarray(gt), idx_lab, idx_unlab,
                             np.array([[0, 1]], np.int32), jax.random.PRNGKey(4), LR,
                             LAM_COT, LAM_ADV)
        ref = {"metrics": jax.tree_util.tree_map(np.asarray, metrics),
               "new": params_from_jax_stacked(jax.tree_util.tree_map(np.asarray, new["params"]),
                                              jax.tree_util.tree_map(np.asarray,
                                                                     new["batch_stats"]), K)}
    for s in segs:
        s.compute_dtype = torch.float64
    initial = [{k: v.clone() for k, v in s.net.state_dict().items()} for s in segs]
    got = make_cotrain_epoch(segs, C, get_loss_fn("cross_entropy"), True, True, False,
                             False, 0.03)(torch.from_numpy(img), torch.from_numpy(gt), idx_lab,
                                          idx_unlab, None, None, LR, LAM_COT, LAM_ADV)
    return {"ref": ref, "initial": initial,
            "got": {"metrics": {k: v.numpy() for k, v in got.items()},
                    "new": [s.net.state_dict() for s in segs]}}


@pytest.mark.parametrize("loss", ["sup_loss", "jsd_loss", "adv_loss"])
def test_losses_match_dct_tpu(cotrain, loss):
    assert float(np.min(cotrain["ref"]["metrics"][loss])) > 0
    np.testing.assert_allclose(cotrain["got"]["metrics"][loss],
                               cotrain["ref"]["metrics"][loss], rtol=2e-6, atol=0)


@pytest.mark.parametrize("model", range(K))
def test_update_matches_dct_tpu(cotrain, model):
    """Measured: model 1 (b) to cosine 1 − 5.2e-12 and 1.3e-6 of the
    parameters' scale; model 0 (a), which takes the adversarial term, to
    1 − 1.8e-10 and 2.5e-6: FGSM's sign flips where the two float64 input
    gradients round to opposite signs (as in test_torch_fused_forward.py)."""
    cos, diff = update_agreement(cotrain["initial"][model], cotrain["ref"]["new"][model],
                                 cotrain["got"]["new"][model])
    assert cos > 1 - 1e-9, cos
    assert diff < 5e-6, diff


@pytest.mark.parametrize("model", range(K))
def test_statistics_match_dct_tpu(cotrain, model):
    """Momentum 0.001: the statistics are nearly the second half's batch
    statistics, composed with the first's as dct_tpu composes them."""
    assert stats_error(cotrain["ref"]["new"][model], cotrain["got"]["new"][model]) < 1e-6
    moved = [float((cotrain["got"]["new"][model][k] - cotrain["initial"][model][k]).abs().max())
             for k in cotrain["initial"][model] if "running" in k]
    assert min(moved) > 0
