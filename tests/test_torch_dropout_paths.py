"""Which training steps run an arch with dropout, in the port as in dct_tpu.

dct_tpu passes a dropout RNG only in the supervised step and to the
Mean-Teacher student, so UNet and the FCNs train only through the
supervised step there: the co-training, VAT, Mean-Teacher (its teacher
forwards) and Cityscapes steps raise flax's ``InvalidRngError``. The port
raises at the same steps. SegNet has no dropout and co-trains, through the
fused two-group forward.

* One ``make_supervised_epoch`` step of ``unet_bn`` (176², B = 1, SGD with
  Nesterov momentum) against dct_tpu's, with the same keep masks injected
  into both (``test_torch_archref.py``): float64 networks, fp32 logits and
  loss on both sides, as in ``test_torch_supervised.py``.
* One fused co-training iteration of two SegNets (64², B = Bu = 2, JSD and
  FGSM, λ_cot 0.5 and λ_adv 0.05, AdamW with eps 1e-3 for the reason
  ``test_torch_jaxref.py`` gives) against dct_tpu's compiled step, without
  augmentation: losses to fp32 rounding, updates to cosine 1 − 1e-11
  (measured). With augmentation on dct_tpu's thetas the compiled dct_tpu
  step parts from its own un-jitted run (``jax.disable_jit``): model a's
  adversarial loss by 9.4e-5 of itself, its update to cosine 0.99998,
  where the port matches the un-jitted run to fp32 rounding (measured,
  1 − 6.5e-12): XLA's fused float64 arithmetic flips FGSM signs on the
  warped images. ``test_torch_fused_forward.py`` holds the augmented step
  with ENet.
* The port's supervised step draws its masks from a generator derived from
  the epoch's, so a rerun from the same seed repeats itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import InvalidRngError

from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train.city import make_city_cotrain_epoch as jax_city_epoch
from dct_tpu.train.mean_teacher import make_mean_teacher_epoch as jax_mt_epoch
from dct_tpu.train.steps import make_cotrain_epoch as jax_cotrain_epoch
from dct_tpu.train.steps import make_supervised_epoch as jax_supervised_epoch
from dct_tpu.train.vat import make_vat_epoch as jax_vat_epoch
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train.city import make_city_cotrain_epoch
from dct_tpu_torch.train.mean_teacher import make_mean_teacher_epoch
from dct_tpu_torch.train.steps import make_cotrain_epoch, make_supervised_epoch
from dct_tpu_torch.train.vat import make_vat_epoch
from dct_tpu_torch.utils.convert import params_from_jax, params_from_jax_stacked, params_to_jax
from test_torch_archref import (C, flax_init, flax_masks, float64_unet_resize,  # noqa: F401
                                inject_masks)
from test_torch_jaxref import (jax_segmentator, one_torch_thread,  # noqa: F401
                               stats_error, update_agreement)

H, B, N = 176, 2, 6
SGD = {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}
COSINE = {"name": "CosineAnnealingLR", "T_max": 10}
UNET = {"name": "unet", "num_classes": C}
DROPOUT_ERROR = "Dropout needs a generator"


def images(n, h, channels=None, seed=0):
    rs = np.random.RandomState(seed)
    shape = (n, h, h) if channels is None else (n, h, h, channels)
    return (rs.randint(0, 255, shape, dtype=np.uint8),
            rs.randint(0, C, (n, h, h)).astype(np.uint8))


def port_seg(arch, params, stats, optim=SGD, cin=1, dtype=torch.float64):
    seg = Segmentator(arch, optim, COSINE, torch.Generator().manual_seed(0), device="cpu",
                      in_channels=cin)
    seg.net.load_state_dict(params_from_jax(params, stats))
    seg.compute_dtype = dtype
    return seg


# ---------------------------------------------------------------- supervised

@pytest.fixture(scope="module")
def supervised():
    _, params, stats = flax_init("unet_bn", H)
    img, gt = images(N, H)
    idx = np.array([[4]], np.int32)
    masks = []
    with jax.enable_x64(True):
        seg = jax_segmentator(params, stats, optim=SGD, arch={"name": "unet_bn", "num_classes": C},
                              sched=COSINE)
        epoch = jax_supervised_epoch(seg, jax_get_loss_fn("cross_entropy"), C, False)
        with flax_masks(11, masks):
            new, metrics = epoch(seg.state, jnp.asarray(img), jnp.asarray(gt), jnp.asarray(idx),
                                 jax.random.PRNGKey(0), SGD["lr"])
        ref = {"loss": np.asarray(metrics["loss"]),
               "new": params_from_jax(jax.tree_util.tree_map(np.asarray, new["params"]),
                                      jax.tree_util.tree_map(np.asarray, new["batch_stats"]))}
    port = port_seg({"name": "unet_bn", "num_classes": C}, params, stats)
    initial = {k: v.clone() for k, v in port.net.state_dict().items()}
    inject_masks(port, masks)
    got = make_supervised_epoch(port, get_loss_fn("cross_entropy"), C, False)(
        torch.from_numpy(img), torch.from_numpy(gt), idx, None, SGD["lr"])
    return {"ref": ref, "initial": initial, "masks": masks,
            "got": {"loss": got["loss"].numpy(), "new": port.net.state_dict()}}


def test_supervised_unet_bn_loss_matches_dct_tpu(supervised):
    assert len(supervised["masks"]) == 2
    np.testing.assert_allclose(supervised["got"]["loss"], supervised["ref"]["loss"],
                               rtol=1e-5, atol=0)


def test_supervised_unet_bn_update_matches_dct_tpu(supervised):
    """fp32 logits and CE on both sides round differently (~1e-7 of the
    loss), which the update passes on."""
    cos, diff = update_agreement(supervised["initial"], supervised["ref"]["new"],
                                 supervised["got"]["new"])
    assert cos > 1 - 1e-9, cos
    assert diff < 1e-6, diff


def test_supervised_unet_bn_statistics_match_dct_tpu(supervised):
    assert stats_error(supervised["ref"]["new"], supervised["got"]["new"]) < 1e-6


def test_supervised_step_draws_dropout_from_the_epoch_generator():
    """Without injected masks the step draws them from a generator derived
    from the epoch's seed (dct_tpu's ``fold_in(k, 1)``): the same seed
    repeats the step, another seed gives other masks."""
    _, params, stats = flax_init("unet", H)
    img, gt = images(N, H, seed=1)
    idx = np.array([[0, 3]], np.int32)
    losses = []
    for seed in (5, 5, 6):
        seg = port_seg(UNET, params, stats, dtype=torch.float32)
        out = make_supervised_epoch(seg, get_loss_fn("cross_entropy"), C, True)(
            torch.from_numpy(img), torch.from_numpy(gt), idx,
            torch.Generator().manual_seed(seed), SGD["lr"])
        losses.append(float(out["loss"][0]))
    assert losses[0] == losses[1] != losses[2]


# ------------------------------------------------------ SegNet co-training

K, HS, LR, LAM_COT, LAM_ADV = 2, 64, 1e-3, 0.5, 0.05
ADAMW = {"name": "AdamW", "lr": LR, "weight_decay": 1e-4, "eps": 1e-3}
MULTISTEP = {"name": "MultiStepLR", "milestones": [50, 80]}
SEGNET = {"name": "segnet", "num_classes": C}


@pytest.fixture(scope="module")
def segnet_cotrain():
    segs = [Segmentator(SEGNET, ADAMW, MULTISTEP, torch.Generator().manual_seed(i),
                        device="cpu", in_channels=1) for i in range(K)]
    trees = [params_to_jax(s.net.state_dict()) for s in segs]
    params = jax.tree_util.tree_map(lambda *a: np.stack(a), *[t[0] for t in trees])
    stats = jax.tree_util.tree_map(lambda *a: np.stack(a), *[t[1] for t in trees])
    img, gt = images(8, HS, seed=2)
    rs = np.random.RandomState(3)
    idx_lab = rs.randint(0, 8, (1, K, B)).astype(np.int32)
    idx_unlab = rs.randint(0, 8, (1, B)).astype(np.int32)
    with jax.enable_x64(True):
        seg = jax_segmentator(jax.tree_util.tree_map(lambda a: a[0], params),
                              jax.tree_util.tree_map(lambda a: a[0], stats),
                              optim=ADAMW, arch=SEGNET, sched=MULTISTEP)
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
def test_segnet_cotrain_losses_match_dct_tpu(segnet_cotrain, loss):
    """fp32 logits on both sides: measured within 4e-7 of each loss."""
    np.testing.assert_allclose(segnet_cotrain["got"]["metrics"][loss],
                               segnet_cotrain["ref"]["metrics"][loss], rtol=2e-6, atol=0)


# (1 − cosine, largest difference) a model's update may part from the
# compiled dct_tpu step's. Model 1 on the port's truncated xavier draws:
# the compiled K-vmapped step parts from dct_tpu's own un-jitted run
# (cosine 1 − 7.8e-7, largest difference 3.9e-4, measured), which the port
# matches to 1 − 6.5e-12 for both models (measured with jax.disable_jit,
# ~5 min, so not run here); XLA's compiled float64 arithmetic, not the
# port, sets model 1's gap.
UPDATE_TOL = {0: (1e-10, 2e-6), 1: (2e-6, 1e-3)}


@pytest.mark.parametrize("model", range(K))
def test_segnet_cotrain_update_matches_dct_tpu(segnet_cotrain, model):
    """Measured: model 0 cosine 1 − 6.9e-12, largest difference 1.3e-7 of
    the parameters' scale; statistics within 2.4e-7; model 1 as
    ``UPDATE_TOL`` says."""
    cos, diff = update_agreement(segnet_cotrain["initial"][model],
                                 segnet_cotrain["ref"]["new"][model],
                                 segnet_cotrain["got"]["new"][model])
    assert cos > 1 - UPDATE_TOL[model][0], cos
    assert diff < UPDATE_TOL[model][1], diff
    assert stats_error(segnet_cotrain["ref"]["new"][model],
                       segnet_cotrain["got"]["new"][model]) < 1e-6


# ------------------------------------------- the steps that pass no RNG raise

@pytest.fixture(scope="module")
def unet():
    _, params, stats = flax_init("unet", H)
    return params, stats


def _jax_state(seg, params, stats, k=None):
    stack = (lambda t: t) if k is None else (
        lambda t: jax.tree_util.tree_map(lambda a: jnp.stack([a] * k), t))
    p = stack(jax.tree_util.tree_map(jnp.asarray, params))
    return {"params": p, "batch_stats": stack(jax.tree_util.tree_map(jnp.asarray, stats)),
            "opt_state": seg.tx.init(p)}


def test_cotraining_with_unet_raises_in_both(unet):
    params, stats = unet
    img, gt = images(N, H)
    seg = jax_segmentator(params, stats, optim=SGD, arch=UNET, sched=COSINE,
                          compute_dtype="float32")
    epoch = jax_cotrain_epoch(seg, 2, C, jax_get_loss_fn("cross_entropy"), True, True,
                              False, False, 0.03)
    with pytest.raises(InvalidRngError):
        epoch(_jax_state(seg, params, stats, 2), img, gt, np.zeros((1, 2, 1), np.int32),
              np.zeros((1, 1), np.int32), np.array([[0, 1]], np.int32),
              jax.random.PRNGKey(0), 1e-3, 0.5, 0.05)
    segs = [port_seg(UNET, params, stats, dtype=torch.float32) for _ in range(2)]
    with pytest.raises(RuntimeError, match=DROPOUT_ERROR):
        make_cotrain_epoch(segs, C, get_loss_fn("cross_entropy"), True, True, False, False,
                           0.03)(torch.from_numpy(img), torch.from_numpy(gt),
                                 np.zeros((1, 2, 1)), np.zeros((1, 1)), None,
                                 torch.Generator().manual_seed(0), 1e-3, 0.5, 0.05)


def test_vat_with_unet_raises_in_both(unet):
    params, stats = unet
    img, gt = images(N, H)
    seg = jax_segmentator(params, stats, optim=SGD, arch=UNET, sched=COSINE,
                          compute_dtype="float32")
    epoch = jax_vat_epoch(seg, jax_get_loss_fn("cross_entropy"), C, True, False, False,
                          10.0, 1e-6, 1)
    with pytest.raises(InvalidRngError):
        epoch(_jax_state(seg, params, stats), img, gt, np.zeros((1, 1), np.int32),
              np.zeros((1, 1), np.int32), jax.random.PRNGKey(0), 1e-3, 0.1)
    port = port_seg(UNET, params, stats, dtype=torch.float32)
    with pytest.raises(RuntimeError, match=DROPOUT_ERROR):
        make_vat_epoch(port, get_loss_fn("cross_entropy"), C, True, False, False, 10.0,
                       1e-6, 1)(torch.from_numpy(img), torch.from_numpy(gt), np.zeros((1, 1)),
                                np.zeros((1, 1)), torch.Generator().manual_seed(0), 1e-3, 0.1)


def test_mean_teacher_with_unet_raises_in_both(unet):
    """The student passes its dropout RNGs; the teacher's forwards, which
    run first, pass none."""
    params, stats = unet
    img, gt = images(N, H)
    seg = jax_segmentator(params, stats, optim=SGD, arch=UNET, sched=COSINE,
                          compute_dtype="float32")
    st = _jax_state(seg, params, stats)
    state = {"student": st, "teacher": {k: st[k] for k in ("params", "batch_stats")}}
    with pytest.raises(InvalidRngError):
        jax_mt_epoch(seg, jax_get_loss_fn("cross_entropy"), C)(
            state, img, gt, np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
            jax.random.PRNGKey(0), 1e-3, 0.1)
    student, teacher = (port_seg(UNET, params, stats, dtype=torch.float32) for _ in range(2))
    with pytest.raises(RuntimeError, match=DROPOUT_ERROR):
        make_mean_teacher_epoch(student, teacher, get_loss_fn("cross_entropy"), C)(
            torch.from_numpy(img), torch.from_numpy(gt), np.zeros((1, 1)), np.zeros((1, 1)),
            torch.Generator().manual_seed(0), 1e-3, 0.1)


def test_city_step_with_unet_raises_in_both():
    """``train_sup_city`` runs the city step with one model: it raises too."""
    _, params, stats = flax_init("unet", H, cin=3)
    img, gt = images(N, H, channels=3)
    seg = jax_segmentator(params, stats, optim=SGD, arch=UNET, sched=COSINE,
                          compute_dtype="float32")
    zeros = np.zeros((1, 2, 1), np.int32)
    with pytest.raises(InvalidRngError):
        jax_city_epoch(seg, 1, C, jax_get_loss_fn("cross_entropy"), False, False, 0.03, 0.03)(
            _jax_state(seg, params, stats, 1), img, gt, np.zeros((1, 1, 1), np.int32),
            np.zeros((1, 1), np.int32), zeros, zeros, np.zeros((1, 2), bool),
            jax.random.PRNGKey(0), 1e-3, 1.0, 0.0)
    port = port_seg(UNET, params, stats, cin=3, dtype=torch.float32)
    with pytest.raises(RuntimeError, match=DROPOUT_ERROR):
        make_city_cotrain_epoch([port], C, get_loss_fn("cross_entropy"), False, False, 0.03,
                                0.03)(torch.from_numpy(img), torch.from_numpy(gt),
                                      np.zeros((1, 1, 1)), np.zeros((1, 1)), zeros, zeros,
                                      np.zeros((1, 2), bool), torch.Generator().manual_seed(0),
                                      1e-3, 1.0, 0.0)

