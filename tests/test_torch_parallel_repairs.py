"""The two repairs made before the parallel slice: the port's conv and
transposed-conv kernels are drawn as flax's truncated ``xavier_normal``
(``models/layers.py:init_weights_``), and ``gather_augment_u8`` augments
multi-channel data as dct_tpu does (``normalize_gather`` then
``augment_batch``, which warps the first channel only and returns it
alone)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.data.pipeline import gather_augment_u8 as jax_gather_augment_u8
from dct_tpu_torch.data.pipeline import gather_augment_u8
from dct_tpu_torch.models.layers import Conv2d, ConvTranspose2d, init_weights_

TRUNCATED_STD = 0.87962566103423978


@pytest.mark.parametrize("kind", ["conv", "transposed"])
def test_xavier_kernels_are_flaxs_truncated_normal(kind):
    """A 3×3 kernel of 256 → 128 channels (295k draws): every draw within
    ±2σ of the untruncated normal, and the draws' standard deviation
    within 1 % of flax's ``xavier_normal`` on the same kernel shape, whose
    fans (and so σ) are the same in flax's (kh, kw, in, out) layout as in
    torch's (out, in, kh, kw) and (in, out, kh, kw) ones."""
    cin, cout = 256, 128
    layer = (Conv2d(cin, cout, 3) if kind == "conv" else ConvTranspose2d(cin, cout, 3))
    init_weights_(nn.Sequential(layer), torch.Generator().manual_seed(0))
    w = layer.weight.detach().double().numpy()
    sigma = math.sqrt(2.0 / (9 * (cin + cout))) / TRUNCATED_STD
    assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6)
    assert np.abs(w).max() > 1.9 * sigma                   # the tails reach the cut
    ref = np.asarray(jax.nn.initializers.xavier_normal()(jax.random.PRNGKey(0),
                                                         (3, 3, cin, cout)))
    assert np.abs(ref).max() <= 2 * sigma * (1 + 1e-6)
    assert abs(w.std() / ref.std() - 1) < 0.01
    assert abs(w.mean()) < 5 * w.std() / math.sqrt(w.size)


@pytest.fixture(scope="module")
def rgb():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 255, (6, 16, 24, 3), dtype=np.uint8),
            rs.randint(0, 19, (6, 16, 24)).astype(np.uint8), np.array([4, 1, 1, 5]))


def test_rgb_gather_augment_equals_dct_tpus(rgb):
    """On dct_tpu's thetas (``augment_batch`` draws them from the key for
    the batch's (H, W)), the port returns dct_tpu's (B,H,W,1) warp of the
    first channel and its labels, to fp32 rounding of the /255."""
    img, gt, idx = rgb
    key = jax.random.PRNGKey(3)
    ref_img, ref_gt = jax_gather_augment_u8(jnp.asarray(img), jnp.asarray(gt),
                                            jnp.asarray(idx), key)
    thetas = torch.from_numpy(np.array(jax_sample_aug_thetas(key, 4, 16, 24)))
    got_img, got_gt = gather_augment_u8(torch.from_numpy(img), torch.from_numpy(gt),
                                        torch.from_numpy(idx), None, thetas=thetas)
    assert tuple(got_img.shape) == tuple(ref_img.shape) == (4, 16, 24, 1)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(ref_gt))


def test_rgb_gather_augment_draws_from_the_generator(rgb):
    img, gt, idx = rgb
    outs = [gather_augment_u8(torch.from_numpy(img), torch.from_numpy(gt),
                              torch.from_numpy(idx), torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert outs[0][0].shape == (4, 16, 24, 1)
    assert torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[0][0], outs[2][0])
