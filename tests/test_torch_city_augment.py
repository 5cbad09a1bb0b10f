"""The Cityscapes augmentations (``data/city_augment.py``) and the shear
warp (``ops/warp.py:affine_warp_shear``) against dct_tpu's, on the CPU.

The shear warp rounds each of its three stages to the nearest pixel, so it
must equal dct_tpu's exactly on thetas inside its domain (|m01/m00| ≤ 1,
|m10/m00| ≤ 1, |translation| ≤ H/2), non-square images and several
channels included. The composed augmenter is held against dct_tpu's on
dct_tpu's own thetas (the two packages draw different random streams);
the samplers' deterministic parts and ranges are held to dct_tpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.data import city_augment as ref
from dct_tpu.ops.warp import affine_warp_shear as jax_warp_one
from dct_tpu.ops.warp import affine_warp_shear_batch as jax_warp
from dct_tpu_torch.data import city_augment as port
from dct_tpu_torch.ops.warp import affine_warp, affine_warp_shear, affine_warp_shear_batch

NUM_CLASSES = 19


def in_domain_thetas(rs, n, h, w):
    """Rotations within ±44°, zooms 0.5–1.2, flips and shifts within H/4."""
    ang = np.deg2rad(rs.uniform(-44, 44, n))
    zy, zx = rs.uniform(0.5, 1.2, n), rs.uniform(0.5, 1.2, n)
    fy, fx = rs.choice([-1, 1], n), rs.choice([-1, 1], n)
    th = np.zeros((n, 2, 3), np.float32)
    th[:, 0, 0], th[:, 0, 1] = np.cos(ang) * zy * fy, -np.sin(ang) * zx
    th[:, 1, 0], th[:, 1, 1] = np.sin(ang) * zy, np.cos(ang) * zx * fx
    th[:, 0, 2], th[:, 1, 2] = rs.uniform(-h / 4, h / 4, n), rs.uniform(-w / 4, w / 4, n)
    return th


@pytest.mark.parametrize("h,w,c", [(16, 32, 3), (24, 16, 5), (32, 64, 1), (40, 40, 2)])
def test_shear_warp_equals_dct_tpu(h, w, c):
    rs = np.random.RandomState(h * w + c)
    img = rs.rand(8, h, w, c).astype(np.float32)
    th = in_domain_thetas(rs, 8, h, w)
    want = np.asarray(jax.jit(jax_warp)(jnp.asarray(img), jnp.asarray(th)))
    got = affine_warp_shear_batch(torch.from_numpy(img), torch.from_numpy(th)).numpy()
    np.testing.assert_array_equal(got, want)
    one = np.asarray(jax_warp_one(jnp.asarray(img[0]), jnp.asarray(th[0])))
    np.testing.assert_array_equal(affine_warp_shear(torch.from_numpy(img[0]),
                                                    torch.from_numpy(th[0])).numpy(), one)


def test_shear_warp_is_near_the_exact_warp():
    """By design within ~1.5 px of the exact nearest warp: on a smooth
    ramp image most pixels agree and none is far off."""
    rs = np.random.RandomState(3)
    h, w = 32, 48
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = torch.from_numpy(np.stack([yy, xx], -1)[None].repeat(6, 0))
    th = torch.from_numpy(in_domain_thetas(rs, 6, h, w))
    shear = affine_warp_shear_batch(img, th)
    exact = affine_warp(img, th, "nearest")
    both = (shear.abs().sum(-1) > 0) & (exact.abs().sum(-1) > 0)
    err = (shear - exact).abs().amax(-1)[both]
    assert float((err == 0).double().mean()) > 0.5 and float(err.max()) <= 3.0


def test_identity_theta_is_the_identity():
    img = torch.rand(2, 12, 20, 3)
    th = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]]).repeat(2, 1, 1)
    assert torch.equal(affine_warp_shear_batch(img, th), img)


def test_registry_keys_equal_dct_tpu():
    assert set(port.key2aug) == set(ref.key2aug) == {
        "rcrop", "scale", "rsize", "rsizecrop", "rotate", "ccrop", "sale"}


def test_compose_thetas_equals_dct_tpu():
    rs = np.random.RandomState(0)
    a, b = (rs.randn(5, 2, 3).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        port.compose_thetas(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref.compose_thetas(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key,param", [("ccrop", [12, 20]), ("scale", 64), ("sale", 64),
                                       ("ccrop", 48)])
def test_deterministic_samplers_equal_dct_tpu(key, param):
    got = port.key2aug[key](param)(torch.Generator().manual_seed(0), 3, 24, 40)
    want = ref.key2aug[key](param)(jax.random.PRNGKey(0), 3, 24, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("key,param", [("rcrop", [12, 20]), ("rotate", 10), ("rsize", None),
                                       ("rsizecrop", None)])
def test_random_samplers_stay_in_dct_tpu_ranges(key, param):
    """Thetas of the same distribution as dct_tpu's, entry by entry: the
    1st, 50th and 99th percentiles over 4000 draws within 4 % of the
    entry's range, and the standard deviation within 10 %."""
    n, h, w = 4000, 24, 40
    got = port.key2aug[key](param)(torch.Generator().manual_seed(1), n, h, w).double()
    want = torch.from_numpy(np.asarray(ref.key2aug[key](param)(jax.random.PRNGKey(1), n, h, w),
                                       np.float64))
    q = torch.tensor([0.01, 0.5, 0.99], dtype=torch.float64)
    span = (want.amax(0) - want.amin(0)).clamp_min(1e-6)
    diff = (torch.quantile(got, q, dim=0) - torch.quantile(want, q, dim=0)).abs() / span
    assert float(diff.max()) < 0.04, diff
    np.testing.assert_allclose(got.std(0).numpy(), want.std(0).numpy(), rtol=0.1, atol=1e-6)


@pytest.mark.parametrize("aug", [{"rotate": 10, "rcrop": [12, 24]}, {"rsizecrop": None},
                                 {"ccrop": [16, 30], "rotate": 30}])
def test_composed_augmenter_equals_dct_tpu(aug):
    """Image, labels and the ignore fill of dct_tpu's augmenter on its own
    draws, exactly."""
    rs = np.random.RandomState(5)
    b, h, w = 4, 24, 40
    img = rs.rand(b, h, w, 3).astype(np.float32)
    gt = rs.randint(0, NUM_CLASSES, (b, h, w)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want_img, want_gt = ref.get_composed_augmentations(aug)(jnp.asarray(img), jnp.asarray(gt), key)
    # dct_tpu's draws: one key per sampler, composed in config order
    samplers = [ref.key2aug[k](v) for k, v in aug.items()]
    keys = jax.random.split(key, len(samplers))
    th = samplers[0](keys[0], b, h, w)
    for smp, k in zip(samplers[1:], keys[1:]):
        th = ref.compose_thetas(th, smp(k, b, h, w))
    augment = port.get_composed_augmentations(aug)
    got_img, got_gt = augment(torch.from_numpy(img), torch.from_numpy(gt), None,
                              thetas=torch.from_numpy(np.array(th)))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    assert got_gt.dtype == torch.int32


def test_composed_augmenter_draws_from_its_generator():
    """The port's own draws: reproducible from the generator's seed, labels
    in the 19 classes or 250, and no augmenter for an empty config."""
    augment = port.get_composed_augmentations({"rotate": 10, "rcrop": [16, 30]})
    img, gt = torch.rand(3, 24, 40, 3), torch.randint(0, NUM_CLASSES, (3, 24, 40))
    a = augment(img, gt, torch.Generator().manual_seed(2))
    b = augment(img, gt, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert set(a[1].unique().tolist()) <= set(range(NUM_CLASSES)) | {250}
    assert port.get_composed_augmentations(None) is None
    assert port.get_composed_augmentations({}) is None
