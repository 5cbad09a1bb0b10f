"""dct_tpu_torch's data path, losses, one-hot/dice helpers, Adam and
schedules ≡ dct_tpu's, on the CPU. Inputs are made with numpy from a seed
and handed to both; random draws are compared by distribution only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu import losses as jax_losses
from dct_tpu import schedules as jax_schedules
from dct_tpu.data import augment as jax_augment
from dct_tpu.data import pipeline as jax_pipeline
from dct_tpu.ops.warp import affine_warp as jax_affine_warp
from dct_tpu.optim import apply_direction, build_optimizer as jax_build_optimizer
from dct_tpu.utils import general as jax_general
from dct_tpu_torch import losses, schedules
from dct_tpu_torch.data import augment, pipeline
from dct_tpu_torch.ops.warp import affine_warp
from dct_tpu_torch.optim import build_optimizer, set_lr
from dct_tpu_torch.utils import general

H = W = 24


def jax_thetas(n, seed=0):
    return np.array(jax_augment.sample_aug_thetas(jax.random.PRNGKey(seed), n, H, W))


# ---------------------------------------------------------------------------
# warps: the same thetas → the same pixels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,atol", [("nearest", 0.0), ("bilinear", 0.0)])
def test_affine_warp_matches_dct_tpu(method, atol):
    """Nearest picks the same pixels; bilinear does the same float32
    arithmetic in the same order: both exact."""
    rs = np.random.RandomState(0)
    img = rs.rand(6, H, W, 2).astype(np.float32)
    th = jax_thetas(6)
    ref = jax.vmap(jax_affine_warp, in_axes=(0, 0, None, None))(
        jnp.asarray(img), jnp.asarray(th), method, 0.0)
    got = affine_warp(torch.from_numpy(img), torch.from_numpy(th), method, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)
    one_channel = affine_warp(torch.from_numpy(img[..., 0]), torch.from_numpy(th), method)
    np.testing.assert_allclose(one_channel.numpy(), np.asarray(ref)[..., 0], rtol=0, atol=atol)


def test_warp_gathered_u8_matches_dct_tpu():
    rs = np.random.RandomState(1)
    img = rs.randint(0, 255, (8, H, W), dtype=np.uint8)
    gt = rs.randint(0, 4, (8, H, W)).astype(np.uint8)
    th = jax_thetas(8, seed=3)
    ref_img, ref_gt = jax_augment.warp_gathered_u8(jnp.asarray(img), jnp.asarray(gt),
                                                   jnp.asarray(th))
    got_img, got_gt = augment.warp_gathered_u8(torch.from_numpy(img), torch.from_numpy(gt),
                                               torch.from_numpy(th))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(ref_img))
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(ref_gt))


def test_augment_bilinear_path_matches_dct_tpu():
    rs = np.random.RandomState(2)
    img = rs.rand(4, H, W, 1).astype(np.float32)
    gt = rs.randint(0, 4, (4, H, W)).astype(np.int32)
    th = jax_thetas(4, seed=4)
    ref = jax_augment.augment_batch_with_thetas(jnp.asarray(img), jnp.asarray(gt),
                                                jnp.asarray(th), fast=False)
    got = augment.augment_batch_with_thetas(torch.from_numpy(img), torch.from_numpy(gt),
                                            torch.from_numpy(th), fast=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_normalize_gather_matches_dct_tpu():
    rs = np.random.RandomState(3)
    img = rs.randint(0, 255, (10, H, W), dtype=np.uint8)
    gt = rs.randint(0, 4, (10, H, W)).astype(np.uint8)
    idx = np.array([3, 0, 9, 3])
    ref = jax_pipeline.normalize_gather(jnp.asarray(img), jnp.asarray(gt), jnp.asarray(idx))
    got = pipeline.normalize_gather(torch.from_numpy(img), torch.from_numpy(gt),
                                    torch.from_numpy(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    img_a, gt_a = pipeline.gather_augment_u8(torch.from_numpy(img), torch.from_numpy(gt),
                                             torch.from_numpy(idx),
                                             torch.Generator().manual_seed(0))
    assert img_a.shape == (4, H, W, 1) and gt_a.shape == (4, H, W)
    assert float(img_a.min()) >= 0.0 and float(img_a.max()) <= 1.0


def _theta_stats(th):
    """Distribution summaries of (n,2,3) thetas: the zoom factor (|det|^½),
    the share with exactly one flip (det < 0) and the largest shift."""
    lin = th[:, :, :2]
    det = np.linalg.det(lin)
    zoom = np.sqrt(np.abs(det))
    return {"crop_frac": np.mean(zoom < 0.999),
            "zoom_lo": zoom[zoom < 0.999].min(), "zoom_hi": zoom[zoom < 0.999].max(),
            "one_flip_frac": np.mean(det < 0),
            "max_shift": np.linalg.norm(th[:, :, 2], axis=1).max() / H}


def test_sample_aug_thetas_distribution():
    """Same distribution as dct_tpu's draws (not the same bits): half the
    samples cropped to a zoom in [0.85, 0.95], half the samples with exactly
    one flip, rotations within ±45°, shifts within the crop margin."""
    n = 4000
    got = augment.sample_aug_thetas(torch.Generator().manual_seed(0), n, H, W).numpy()
    ref = jax_thetas(n, seed=5)
    assert got.shape == ref.shape == (n, 2, 3)
    gs, rs_ = _theta_stats(got), _theta_stats(ref)
    for k in ("crop_frac", "one_flip_frac"):
        assert abs(gs[k] - 0.5) < 0.04 and abs(rs_[k] - 0.5) < 0.04, (k, gs[k], rs_[k])
    assert 0.85 - 1e-5 <= gs["zoom_lo"] and gs["zoom_hi"] <= 0.95 + 1e-5
    # each crop offset is at most half the margin, 0.075·H; rotation and
    # flips keep the shift's norm
    assert gs["max_shift"] <= 0.075 * np.sqrt(2) + 1e-5
    assert rs_["max_shift"] <= 0.075 * np.sqrt(2) + 1e-5
    # rotation: angle of the linear part once flips are removed
    ang = np.degrees(np.arctan2(np.abs(got[:, 1, 0]), np.abs(got[:, 0, 0])))
    assert ang.max() <= 45.0 + 1e-3
    assert abs(np.mean(ang == 0) - np.mean(
        np.degrees(np.arctan2(np.abs(ref[:, 1, 0]), np.abs(ref[:, 0, 0]))) == 0)) < 0.04


# ---------------------------------------------------------------------------
# losses: values and gradients (fp32, rtol 1e-5: the same formulas, summed
# in another order)
# ---------------------------------------------------------------------------

def _logits_target(seed, ignore=True):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(2, 8, 8, 4) * 2).astype(np.float32)
    target = rs.randint(0, 4, (2, 8, 8))
    if ignore:
        target[0, :2] = 255
    return logits, target


def _value_and_grad(jax_fn, torch_fn, array):
    ref_v, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(array))
    t = torch.from_numpy(array).requires_grad_(True)
    v = torch_fn(t)
    (g,) = torch.autograd.grad(v, [t])
    np.testing.assert_allclose(v.item(), float(ref_v), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weight", [None, [0.5, 1.0, 2.0, 1.5]])
def test_cross_entropy2d_matches_dct_tpu(weight):
    logits, target = _logits_target(0)
    _value_and_grad(lambda l: jax_losses.cross_entropy2d(l, jnp.asarray(target), weight),
                    lambda l: losses.cross_entropy2d(l, torch.from_numpy(target), weight),
                    logits)


def _probs(seed, shape):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(x), axis=-1))


def test_entropy_kl_jsd_match_dct_tpu():
    p, q = _probs(1, (2, 8, 8, 4)), _probs(2, (2, 8, 8, 4))
    stack = _probs(3, (3, 2, 8, 8, 4))
    _value_and_grad(lambda a: jnp.mean(jax_losses.entropy_2d(a)),
                    lambda a: losses.entropy_2d(a).mean(), p)
    _value_and_grad(lambda a: jax_losses.kl_div_2d(a, jnp.asarray(q), reduce=True),
                    lambda a: losses.kl_div_2d(a, torch.from_numpy(q), reduce=True), p)
    _value_and_grad(lambda a: jnp.mean(jax_losses.jsd_2d(a)),
                    lambda a: losses.jsd_2d(a).mean(), stack)
    as_list = losses.jsd_2d([torch.from_numpy(s) for s in stack])
    np.testing.assert_allclose(as_list.numpy(), np.asarray(jax_losses.jsd_2d(jnp.asarray(stack))),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["kl_div_2d_logits", "mse_probs"])
def test_vat_and_mean_teacher_losses_match_dct_tpu(name):
    """VAT's KL from logits (gradient with respect to the perturbed logits)
    and Mean-Teacher's MSE between probabilities: values and gradients."""
    if name == "kl_div_2d_logits":
        p, y = _logits_target(5, ignore=False)[0], _logits_target(6, ignore=False)[0]
    else:
        p, y = _probs(7, (2, 8, 8, 4)), _probs(8, (2, 8, 8, 4))
    ref_fn, fn = getattr(jax_losses, name), getattr(losses, name)
    _value_and_grad(lambda a: jnp.mean(ref_fn(a, jnp.asarray(y))),
                    lambda a: torch.mean(fn(a, torch.from_numpy(y))), p)


def test_get_loss_fn():
    logits, target = _logits_target(4, ignore=False)
    fn = losses.get_loss_fn("cross_entropy", weight=[1, 1, 1, 1])
    ref = jax_losses.get_loss_fn("cross_entropy", weight=[1, 1, 1, 1])
    np.testing.assert_allclose(fn(torch.from_numpy(logits), torch.from_numpy(target)).item(),
                               float(ref(jnp.asarray(logits), jnp.asarray(target))), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss_fn("focal")


# ---------------------------------------------------------------------------
# one-hot and dice: exact
# ---------------------------------------------------------------------------

def test_one_hot_and_dice_match_dct_tpu():
    rs = np.random.RandomState(5)
    seg = rs.randint(0, 4, (3, 8, 8))
    probs = _probs(6, (3, 8, 8, 4))
    np.testing.assert_array_equal(general.class2one_hot(torch.from_numpy(seg), 4).numpy(),
                                  np.asarray(jax_general.class2one_hot(jnp.asarray(seg), 4)))
    got_oh = general.probs2one_hot(torch.from_numpy(probs))
    ref_oh = jax_general.probs2one_hot(jnp.asarray(probs))
    np.testing.assert_array_equal(got_oh.numpy(), np.asarray(ref_oh))
    label = general.class2one_hot(torch.from_numpy(seg), 4)
    np.testing.assert_allclose(
        general.dice_coef(label, got_oh).numpy(),
        np.asarray(jax_general.dice_coef(jnp.asarray(label.numpy()), ref_oh)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Adam (L2 folded into the gradient) and schedules
# ---------------------------------------------------------------------------

def test_adam_with_l2_matches_dct_tpu():
    """Three steps of torch.optim.Adam(weight_decay) against dct_tpu's
    add_decayed_weights + scale_by_adam, at a changing lr: fp32, rtol 1e-5."""
    cfg = {"name": "Adam", "lr": 1e-2, "weight_decay": 1e-2, "betas": (0.9, 0.99)}
    rs = np.random.RandomState(7)
    p0 = rs.randn(50).astype(np.float32)
    grads = [rs.randn(50).astype(np.float32) for _ in range(3)]
    tx = jax_build_optimizer(cfg)
    p_ref, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer(cfg, [param])
    for i, g in enumerate(grads):
        lr = 1e-2 * 0.5 ** i
        d, st = tx.update(jnp.asarray(g), st, p_ref)
        p_ref = apply_direction(p_ref, d, lr)
        set_lr(opt, lr)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p_ref), rtol=1e-5, atol=1e-7)
    with pytest.raises(KeyError, match="unknown optimizer"):
        build_optimizer({"name": "LBFGS", "lr": 0.1}, [param])


def test_schedules_match_dct_tpu():
    sched = {"name": "StepLR", "step_size": 3, "gamma": 0.5}
    got, ref = schedules.get_lr_schedule(sched, 0.1), jax_schedules.get_lr_schedule(sched, 0.1)
    assert [got(e) for e in range(10)] == [ref(e) for e in range(10)]
    ramp = schedules.RampScheduler(2, 12, 0.5, -5)
    ref_ramp = jax_schedules.RampScheduler(2, 12, 0.5, -5)
    for _ in range(15):
        assert ramp.value == ref_ramp.value
        ramp.step()
        ref_ramp.step()
    restored = schedules.RampScheduler(0, 1, 0.0, 0.0)
    restored.load_state_dict(ramp.state_dict())
    assert restored.value == ramp.value
    with pytest.raises(KeyError, match="unknown LR scheduler"):
        schedules.get_lr_schedule({"name": "OneCycleLR"}, 0.1)
