"""The port's FCN8, FCN16 and FCN32 against dct_tpu's flax modules on the
same weights, in float64, as ``test_torch_archs.py`` holds UNet and
SegNet: at 224² (the valid 7×7 conv on the 1/32 map needs it; the widths
are dct_tpu's own, 134 M parameters), one image, the parameter count, the
eval logits, the train logits with both of ``fconn``'s dropout masks
injected, and every parameter's gradient within 1e-9 of its scale. FCN32
takes a 3-channel input: the first conv's width is the data's, whatever
``Arch.in_channels`` declares. FCNs have no BatchNorm, so no statistics.
"""
import pytest

from test_torch_archref import (TOL, _leaves, float64_unet_resize,  # noqa: F401
                                jax_side, port_side, rel_err, tree_error)
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)

# (arch, input side, input channels, batch)
ARCHS = [("fcn8", 224, 1, 1), ("fcn16", 224, 1, 1), ("fcn32", 224, 3, 1)]


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
