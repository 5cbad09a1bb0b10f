"""The port's UNet, UNet_bn and SegNet against dct_tpu's flax modules on
the same weights, in float64 (``test_torch_archref.py`` says how the resize
and the dropout masks are made equal; ``test_torch_archs_fcn.py`` holds the
FCNs the same way).

For each arch, at its smallest input (UNet 176², SegNet 64²; the widths
are dct_tpu's own, fixed), one numpy-seeded batch: the parameter count,
the eval logits, the train logits with the same dropout keep masks in
both, the gradient of a random linear functional of those logits with
respect to every parameter, and the running statistics after the train
forward, each within 1e-9 of its scale. Every max-pool in these nets
follows a ReLU, so a tied window is a window of zeros whose gradient the
ReLU kills in both frameworks; no tie elsewhere shows at these inputs
(the gradients agree to float64 rounding). ``remat`` gives the plain
form's logits, gradients and statistics. The resizes are held against
dct_tpu's: align corners against ``ops/resize.py`` in float32 to two
float32 ulps of scale, single points included, and the half-pixel resize
against ``jax.image.resize`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.ops.resize import resize_bilinear_align_corners as jax_resize_ac
from dct_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_align_corners
from test_torch_archref import (C, TOL, _leaves, flax_init, float64_unet_resize,  # noqa: F401
                                jax_side, port_side, port_train, rel_err, tree_error)
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)

# (arch, input side, input channels, batch)
ARCHS = [("unet", 176, 1, 1), ("unet_bn", 176, 1, 2), ("segnet", 64, 1, 2)]


@pytest.fixture(scope="module", params=ARCHS, ids=[a[0] for a in ARCHS])
def arch(request):
    return jax_side(*request.param)


@pytest.fixture(scope="module")
def port(arch):
    return port_side(arch)


def test_parameter_count(arch, port):
    assert port["count"] == sum(v.size for _, v in _leaves(arch["params"]))


def test_eval_logits(arch, port):
    assert port["eval"].shape == arch["eval"].shape
    assert rel_err(port["eval"], arch["eval"]) < TOL


def test_train_logits_with_masks(arch, port):
    assert len(arch["masks"]) == (0 if arch["name"] == "segnet" else 2)
    assert rel_err(port["train"][0], arch["train"]) < TOL


def test_gradients(arch, port):
    assert tree_error(port["train"][1], arch["grads"]) < TOL


def test_running_statistics(arch, port):
    if not arch["new_stats"]:
        assert not port["train"][2]
        return
    assert tree_error(port["train"][2], arch["new_stats"]) < TOL


@pytest.mark.parametrize("name", ["unet", "unet_bn"])
def test_remat_equals_plain(name):
    """``Arch.remat`` recomputes each stage in the backward pass: the same
    logits, gradients and running statistics as the plain form (checked at
    the smallest input, in float64, with fixed masks)."""
    model, params, stats = flax_init(name, 176, seed=1)
    rs = np.random.RandomState(3)
    arch = {"name": name, "cin": 1, "params": params, "stats": stats,
            "x": rs.rand(1, 176, 176, 1), "w": rs.randn(1, 176, 176, C),
            "masks": [rs.rand(1, 15, 15, 512) < 0.5, rs.rand(1, 4, 4, 1024) < 0.5]}
    plain = port_train(arch)
    remat = port_train(arch, remat=True)
    np.testing.assert_array_equal(remat[0], plain[0])
    assert tree_error(remat[1], plain[1]) < 1e-12
    if name == "unet_bn":
        assert tree_error(remat[2], plain[2]) == 0.0


@pytest.mark.parametrize("shape,hw", [((2, 19, 19, 5), (8, 8)), ((1, 86, 86, 3), (8, 8)),
                                      ((2, 4, 4, 3), (176, 176)), ((1, 8, 8, 2), (8, 8)),
                                      ((1, 1, 5, 2), (7, 3)), ((1, 6, 4, 2), (1, 9)),
                                      ((1, 11, 13, 4), (5, 17))])
def test_align_corners_resize_matches_dct_tpu(shape, hw):
    """fp32 in, fp32 out: dct_tpu's two float32 matmuls and the port's
    ``F.interpolate`` round differently, by at most two ulps of scale; a
    side of one point reads point 0 in both. bf16 is resized in fp32."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    ref = np.asarray(jax_resize_ac(jnp.asarray(x), hw))
    got = resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), hw)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2 * np.finfo(np.float32).eps * np.abs(ref).max()
    bf = resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(), hw)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  resize_bilinear_align_corners(
                                      torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
                                      .float(), hw).bfloat16().float().numpy())


@pytest.mark.parametrize("shape,hw", [((1, 1, 1, 3), (14, 14)), ((1, 14, 14, 3), (28, 28)),
                                      ((2, 28, 28, 4), (224, 224)), ((1, 2, 2, 5), (4, 4)),
                                      ((1, 7, 7, 2), (14, 14)), ((1, 3, 5, 2), (9, 10))])
def test_half_pixel_resize_matches_jax_image_resize(shape, hw):
    """SegNet's 2× upsampling and FCN's score resizes, edges included, in
    float64: ``F.interpolate(align_corners=False)`` is
    ``jax.image.resize(..., "bilinear")`` at every upsampling."""
    x = np.random.RandomState(len(shape) + hw[0]).randn(*shape)
    with jax.enable_x64(True):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *hw, shape[3]), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
    assert rel_err(got.numpy(), ref) < 1e-13

