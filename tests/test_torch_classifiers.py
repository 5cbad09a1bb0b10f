"""The port's VGG11 and ResNet18 against dct_tpu's on the same weights, in
float64; the registry against dct_tpu's; and each new net's init, leaf by
leaf, against dct_tpu's flax init.

* VGG11 and ResNet18 at 64², batch 2: eval and train logits (VGG11's two
  dropouts with the same keep masks in both), parameter and input
  gradients of a random linear functional of the logits, ResNet18's
  running statistics, within 1e-9 of their scale.
* ``ARCH_CALLABLES`` has dct_tpu's keys, ``BN_MOMENTUM`` equals dct_tpu's
  (``pspnet``'s inert 0.9 included), and every entry builds.
* Init: the same tree (names and shapes) as dct_tpu's flax init, and per
  leaf the same family: BatchNorm scales exactly 1 in DeepLab, PSPNet and
  ResNet18; ASPP-v2's kernels N(0, 0.01) with zero biases; Dense kernels
  and PSPNet's ``final`` lecun-normal (flax's normal cut at ±2σ, σ the
  untruncated one, 1/0.8796 of the draws' standard deviation), on both
  sides inside the cut; xavier-normal elsewhere, of the same standard
  deviation (truncated at ±2σ on both sides); each kernel's
  standard deviation within 5/√n + 2 % of
  dct_tpu's (n its elements) and of its family's, and each constant leaf
  the same constant.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_tpu.models as jax_models
import dct_tpu_torch.models as port_models
from test_torch_archref import _leaves
from test_torch_deeplab import QUANTITIES, check
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_zooref import C, jax_run, perturb_stats, port_run, port_seg, trees


@pytest.fixture(scope="module", params=["vgg11", "resnet18"])
def classifier(request):
    seg = port_seg(request.param, 1, seed=12)
    perturb_stats(seg.net, 13)
    rs = np.random.RandomState(14)
    x = rs.rand(2, 64, 64, 1)
    ws = rs.randn(2, C)
    ref = jax_run((request.param, {}), *trees(seg.net), x, ws)
    return request.param, ref, port_run(seg.net, x, ws, ref["masks"])


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_matches_dct_tpu(classifier, quantity):
    name, ref, got = classifier
    assert got["eval"].shape == (2, C)
    assert len(ref["masks"]) == (2 if name == "vgg11" else 0)
    if quantity == "new_stats" and name == "vgg11":
        assert ref["new_stats"] == got["new_stats"] == {}
        return
    check(ref, got, quantity)


def test_registry_matches_dct_tpu():
    assert sorted(port_models.ARCH_CALLABLES) == sorted(jax_models.ARCH_CALLABLES)
    assert port_models.BN_MOMENTUM == jax_models.BN_MOMENTUM


@pytest.mark.parametrize("name", sorted(jax_models.ARCH_CALLABLES))
def test_every_entry_builds(name):
    net = port_models.get_arch(name, {"arch": name, "num_classes": 19})
    assert sum(p.numel() for p in net.parameters()) > 0


# (arch, kwargs, input side, channels): the nets whose init differs from
# dct_tpu's layers.py defaults
INITS = [("deeplabv2", {"n_blocks": [1, 1, 1, 1]}, 32, 3),
         ("pspnet", {"n_blocks": [1, 1, 1, 1]}, 32, 1),
         ("vgg11", {}, 32, 1), ("resnet18", {}, 32, 1)]


def _family(name, path, shape):
    """The init family dct_tpu's modules declare for one parameter leaf."""
    leaf = path[-1]
    if leaf == "bias":
        return "zeros"
    if leaf == "scale":
        return "ones"
    if path[0] == "aspp" and name == "deeplabv2":
        return "normal", 0.01
    if len(shape) == 2 or path[0] == "final":
        fan_in = math.prod(shape[:-1])
        return "lecun", math.sqrt(1.0 / fan_in)
    fan_in, fan_out = math.prod(shape[:-1]), math.prod(shape[:-2]) * shape[-1]
    return "xavier", math.sqrt(2.0 / (fan_in + fan_out))


def _std_close(a, std):
    return abs(float(np.std(a)) / std - 1) < 5 / math.sqrt(a.size) + 0.02


@pytest.fixture(scope="module", params=INITS, ids=[i[0] for i in INITS])
def inits(request):
    name, arch, hw, cin = request.param
    model = jax_models.get_arch(name, {"num_classes": C, **arch})
    rng = jax.random.PRNGKey(0)
    v = jax.jit(lambda r, x: model.init({"params": r, "dropout": r}, x, train=False))(
        rng, jnp.zeros((1, hw, hw, cin)))
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, v["params"])))
    seg = port_seg(name, cin, seed=15, **arch)
    got = dict(_leaves(trees(seg.net)[0]))
    return name, ref, got


def test_init_tree_equals_dct_tpus(inits):
    _, ref, got = inits
    assert {p: v.shape for p, v in got.items()} == {p: v.shape for p, v in ref.items()}


def test_init_families_match_dct_tpus(inits):
    name, ref, got = inits
    for path, r in ref.items():
        family = _family(name, path, r.shape)
        g = got[path]
        if family == "zeros":
            assert not r.any() and not g.any(), path
        elif family == "ones":
            assert (r == 1).all() and (g == 1).all(), path
        else:
            kind, std = family
            for a in (r, g):
                assert _std_close(a, std), (path, float(np.std(a)), std)
                if kind == "lecun":     # cut at 2σ of the untruncated normal
                    assert np.abs(a).max() / std <= 2 / 0.8796 + 1e-6, path
            assert _std_close(g, float(np.std(r))), path
