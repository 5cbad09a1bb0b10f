"""The port's DeepLab V2 / V3 / V3+ against dct_tpu's flax modules on the
same weights, in float64 (how the weights are carried and the outputs
compared: ``test_torch_zooref.py``; PSPNet and MSC:
``test_torch_pspnet_msc.py``).

The trunk keeps ResNet-101's widths (64 … 2048 channels) and is cut in
depth: ``n_blocks`` (1, 1, 1, 1), and (1, 1, 1, 3) with multi-grid
(1, 2, 4); inputs of 64² (a 9×9 map at output stride 8) and 64×96;
output strides 8 and 16; batches of 2, and of 1, where ASPP-v3's
image-pool BatchNorm sees one value a channel. For each: eval logits,
train logits, the gradients of a random linear functional of them with
respect to every parameter and to the input, and the running statistics
after the train forward, within 1e-9 of their scale (measured ~1e-15).
The antialiased bilinear shrink of ``ops/resize.py`` is held against
``jax.image.resize`` on its own, and DeepLabV2's 1/8 logits make the
losses raise in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.losses import cross_entropy2d as jax_cross_entropy2d
from dct_tpu_torch.losses import cross_entropy2d
from dct_tpu_torch.ops.resize import resize_bilinear
from test_torch_archref import rel_err, tree_error
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_zooref import C, jax_run, perturb_stats, port_run, port_seg, trees

TOL = 1e-9
# (id, arch name, kwargs, input (H, W), channels, batch)
CASES = [
    ("v2", "deeplabv2", {"n_blocks": [1, 1, 1, 1]}, (64, 64), 3, 2),
    ("v3_os8_grids", "deeplabv3", {"n_blocks": [1, 1, 1, 3], "grids": [1, 2, 4]},
     (64, 96), 3, 1),
    ("v3plus_os16", "deeplabv3plus", {"n_blocks": [1, 1, 1, 1], "grids": [2],
                                      "output_stride": 16}, (64, 64), 3, 2),
]


def weights(out, rs):
    return [rs.randn(*o.shape) for o in out] if isinstance(out, list) else rs.randn(*out.shape)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    _, name, arch, hw, cin, b = request.param
    seg = port_seg(name, cin, seed=1, **arch)
    perturb_stats(seg.net, 2)
    rs = np.random.RandomState(hw[1] + cin)
    x = rs.rand(b, *hw, cin)
    seg.net.eval()
    with torch.no_grad():
        ws = weights(seg.net(torch.from_numpy(x)).numpy(), rs)
    params, stats = trees(seg.net)
    ref = jax_run((name, arch), params, stats, x, ws)
    return ref, port_run(seg.net, x, ws, ref["masks"])


QUANTITIES = ["eval", "train", "grads", "input_grad", "new_stats"]


def check(ref, got, quantity):
    if quantity in ("grads", "new_stats"):
        assert got[quantity] and tree_error(got[quantity], ref[quantity]) < TOL
    elif isinstance(ref[quantity], list):
        assert len(got[quantity]) == len(ref[quantity])
        for g, r in zip(got[quantity], ref[quantity]):
            assert g.shape == r.shape and rel_err(g, r) < TOL
    else:
        assert got[quantity].shape == ref[quantity].shape
        assert rel_err(got[quantity], ref[quantity]) < TOL


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_matches_dct_tpu(case, quantity):
    ref, got = case
    check(ref, got, quantity)


def test_output_shapes():
    """DeepLabV2 stops at 1/8 (a 64² input gives 9×9, 64×96 gives 9×13);
    V3+ returns the input's size."""
    x = torch.rand(1, 64, 96, 3, dtype=torch.float64)
    for name, arch, want in (("deeplabv2", {"n_blocks": [1, 1, 1, 1]}, (9, 13)),
                             ("deeplabv3plus", {"n_blocks": [1, 1, 1, 1], "grids": [1]},
                              (64, 96))):
        seg = port_seg(name, 3, **arch)
        seg.net.eval()
        with torch.no_grad():
            assert tuple(seg.net(x).shape) == (1, *want, C)


def test_deeplabv2_logits_make_the_loss_raise_in_both():
    """dct_tpu's cross-entropy raises on V2's 1/8 logits (the shapes do not
    broadcast); the port raises too and resizes nothing."""
    logits = np.zeros((2, 9, 9, C), np.float32)
    target = np.zeros((2, 64, 64), np.int32)
    with pytest.raises(Exception):
        jax_cross_entropy2d(jnp.asarray(logits), jnp.asarray(target))
    with pytest.raises((RuntimeError, ValueError, IndexError)):
        cross_entropy2d(torch.from_numpy(logits), torch.from_numpy(target).long())


@pytest.mark.parametrize("shape,hw", [((2, 64, 64, 3), (32, 32)), ((2, 64, 64, 3), (48, 48)),
                                      ((1, 64, 64, 2), (7, 9)), ((1, 9, 13, 4), (6, 6)),
                                      ((1, 4, 9, 2), (6, 6)), ((1, 17, 17, 3), (13, 20))])
def test_bilinear_shrink_matches_jax_image_resize(shape, hw):
    """``jax.image.resize(..., "bilinear")`` antialiases a shrinking side;
    ``resize_bilinear`` does too (without it: off by 0.6–2.4 at these
    shapes), also where one side shrinks and the other grows."""
    x = np.random.RandomState(sum(hw)).randn(*shape)
    with jax.enable_x64(True):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *hw, shape[3]),
                                          "bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
    assert rel_err(got.numpy(), ref) < 1e-13
