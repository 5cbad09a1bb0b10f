"""dct_tpu_torch pooling ops ≡ dct_tpu's, on the CPU.

The plain PyTorch pool-with-mask and unpool (the CPU path of the CUDA
kernels' wrappers, and the oracle ``chip_smoke.py`` holds the kernels
against) are compared with ``dct_tpu.ops.pooling`` and with the Pallas
kernels of ``dct_tpu.ops.pallas_pool`` (interpret mode off the TPU). Inputs
are integer-valued floats, dense in ties, so every value, mask and gradient
must be equal: exact comparisons throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.ops import pooling as jax_pooling
from dct_tpu.ops.pallas_pool import (mask_unpool_2x2_pallas,
                                     max_pool_2x2_with_mask_pallas)
from dct_tpu_torch.ops import pool_kernels, pooling

SHAPES = [(2, 8, 8, 3), (1, 12, 12, 14), (2, 4, 6, 64)]


def tie_dense(shape, seed, nan=False):
    x = np.random.RandomState(seed).randint(0, 3, shape).astype(np.float32)
    if nan:
        x[0, 0, 1, 0] = np.nan            # window (0, 0), corner (0, 1)
    return x


def assert_exact(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))   # NaN == NaN


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nan", [False, True])
def test_pool_mask_matches_dct_tpu(shape, nan):
    x = tie_dense(shape, 0, nan)
    pooled, mask = pooling.max_pool_2x2_with_mask(torch.from_numpy(x))
    for ref in (jax_pooling.max_pool_2x2_with_mask(jnp.asarray(x)),
                max_pool_2x2_with_mask_pallas(jnp.asarray(x))):
        assert_exact(pooled, ref[0])
        assert_exact(mask, ref[1])
    assert_exact(pooling.max_pool_2x2(torch.from_numpy(x)),
                 jax_pooling.max_pool_2x2(jnp.asarray(x)))
    if nan:                               # NaN pools to NaN, mask at (1, 1)
        assert np.isnan(pooled[0, 0, 0, 0].item())
        assert mask[0, :2, :2, 0].tolist() == [[0.0, 0.0], [0.0, 1.0]]


@pytest.mark.parametrize("shape", SHAPES)
def test_unpool_matches_dct_tpu(shape):
    x = tie_dense(shape, 1)
    _, mask = jax_pooling.max_pool_2x2_with_mask(jnp.asarray(x))
    b, h, w, c = shape
    y = np.random.RandomState(2).randint(-3, 4, (b, h // 2, w // 2, c)).astype(np.float32)
    y[0, 0, 0, 0] = np.nan                # NaN · 0 stays NaN
    out = pooling.mask_unpool_2x2(torch.from_numpy(y), torch.from_numpy(np.array(mask)))
    assert_exact(out, jax_pooling.mask_unpool_2x2(jnp.asarray(y), mask))
    assert_exact(out, mask_unpool_2x2_pallas(jnp.asarray(y), mask))


@pytest.mark.parametrize("shape", SHAPES)
def test_pool_gradient_matches_jax(shape):
    """Tie gradients follow JAX's derivative of the maximum tree, exactly."""
    x = tie_dense(shape, 3)
    b, h, w, c = shape
    g = np.random.RandomState(4).randint(-3, 4, (b, h // 2, w // 2, c)).astype(np.float32)
    ref = jax.grad(lambda t: jnp.sum(
        jax_pooling.max_pool_2x2_with_mask(t)[0] * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(pooling.max_pool_2x2_with_mask(xt)[0], xt,
                                 torch.from_numpy(g))
    assert_exact(got, ref)


@pytest.mark.parametrize("window,expected", [
    ([1.0, 1.0, 1.0, 0.0], [0.25, 0.25, 0.5, 0.0]),
    ([1.0, 1.0, 1.0, 1.0], [0.25, 0.25, 0.25, 0.25]),
    ([0.0, 2.0, 2.0, 1.0], [0.0, 0.5, 0.5, 0.0]),
])
def test_pool_tie_split(window, expected):
    x = torch.tensor(window).reshape(1, 2, 2, 1).requires_grad_(True)
    pooling.max_pool_2x2_with_mask(x)[0].sum().backward()
    assert x.grad.flatten().tolist() == expected
    ref = jax.grad(lambda t: jax_pooling.max_pool_2x2_with_mask(t)[0].sum())(
        jnp.asarray(window).reshape(1, 2, 2, 1))
    assert np.asarray(ref).flatten().tolist() == expected


@pytest.mark.parametrize("shape", SHAPES)
def test_unpool_gradient_matches_jax(shape):
    x = tie_dense(shape, 5)
    _, mask = jax_pooling.max_pool_2x2_with_mask(jnp.asarray(x))
    b, h, w, c = shape
    y = np.random.RandomState(6).randint(-3, 4, (b, h // 2, w // 2, c)).astype(np.float32)
    g = np.random.RandomState(7).randint(-3, 4, shape).astype(np.float32)
    ref = jax.grad(lambda t: jnp.sum(jax_pooling.mask_unpool_2x2(t, mask) * g))(
        jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_(True)
    (got,) = torch.autograd.grad(
        pooling.mask_unpool_2x2(yt, torch.from_numpy(np.array(mask))), yt,
        torch.from_numpy(g))
    assert_exact(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpool_gradient_nan_inf_at_masked_out_corners(dtype):
    """The unpool's backward multiplies every corner by its mask, the
    masked-out ones too: a NaN or an inf in g where the mask is 0 makes that
    window's gy NaN, in dct_tpu and in the plain version (and the CPU path of
    the kernel's wrapper) that the CUDA kernel is held to."""
    shape = (2, 4, 6, 14)
    x = tie_dense(shape, 9)
    mask = np.array(jax_pooling.max_pool_2x2_with_mask(jnp.asarray(x))[1])
    b, h, w, c = shape
    y = np.random.RandomState(10).randint(-3, 4, (b, h // 2, w // 2, c)).astype(np.float32)
    g = np.random.RandomState(11).randint(-3, 4, shape).astype(np.float32)
    hidden = np.flatnonzero(mask == 0)[[0, -1]]          # two masked-out corners
    g.flat[hidden[0]], g.flat[hidden[1]] = np.nan, np.inf
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.grad(lambda t: jnp.sum(
        jax_pooling.mask_unpool_2x2(t, jnp.asarray(mask, jdt)) * jnp.asarray(g, jdt)))(
        jnp.asarray(y, jdt))
    ref = np.asarray(ref, np.float32)
    for fn in (pooling.mask_unpool_2x2, pool_kernels.mask_unpool_2x2_kernel):
        yt = torch.from_numpy(y).to(tdt).requires_grad_(True)
        (got,) = torch.autograd.grad(fn(yt, torch.from_numpy(mask).to(tdt)), yt,
                                     torch.from_numpy(g).to(tdt))
        assert got.dtype == tdt
        assert_exact(got.float(), ref)
    for f in hidden:
        i, r, col, ch = np.unravel_index(f, shape)
        assert np.isnan(ref[i, r // 2, col // 2, ch])
    assert np.isfinite(ref).sum() == ref.size - 2


def test_kernel_wrappers_take_plain_path_on_cpu():
    x = torch.from_numpy(tie_dense((2, 8, 8, 14), 8)).requires_grad_(True)
    before = dict(pool_kernels.LAUNCHES)
    pooled, mask = pool_kernels.max_pool_2x2_with_mask_kernel(x)
    ref_pooled, ref_mask = pooling.max_pool_2x2_with_mask(x)
    assert torch.equal(pooled, ref_pooled) and torch.equal(mask, ref_mask)
    y = torch.randn(2, 4, 4, 14, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pool_kernels.mask_unpool_2x2_kernel(y, mask),
                       pooling.mask_unpool_2x2(y, mask))
    pooled.sum().backward()
    assert x.grad is not None
    assert pool_kernels.LAUNCHES == before       # no kernel ran


@pytest.mark.parametrize("bad,error", [
    (torch.zeros(1, 5, 4, 3), ValueError),                     # odd H
    (torch.zeros(1, 4, 7, 3), ValueError),                     # odd W
    (torch.zeros(4, 4, 3), ValueError),                        # not 4-D
    (torch.zeros(1, 4, 4, 3, dtype=torch.float16), TypeError),
    (torch.zeros(1, 4, 4, 3, dtype=torch.int32), TypeError),
    (torch.zeros(1, 3, 4, 4).permute(0, 2, 3, 1), ValueError),  # not contiguous NHWC
])
def test_pool_wrapper_rejects(bad, error):
    with pytest.raises(error):
        pool_kernels.max_pool_2x2_with_mask_kernel(bad)


@pytest.mark.parametrize("y,mask,error", [
    (torch.zeros(1, 2, 2, 3), torch.zeros(1, 4, 4, 4), ValueError),  # shapes
    (torch.zeros(1, 2, 2, 3), torch.zeros(1, 4, 4, 3, dtype=torch.bfloat16), TypeError),
    (torch.zeros(1, 2, 2, 3, dtype=torch.float16),
     torch.zeros(1, 4, 4, 3, dtype=torch.float16), TypeError),
])
def test_unpool_wrapper_rejects(y, mask, error):
    with pytest.raises(error):
        pool_kernels.mask_unpool_2x2_kernel(y, mask)
