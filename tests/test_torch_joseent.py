"""The port's JEnet (``jenet``) and CorstemNet (``cnet``) against dct_tpu's
flax modules on the same weights, in float64 (``test_torch_zooref.py``).

At 32² (JEnet's three pools and CorstemNet's four need sides divisible by
8 and 16), batch 2, one input channel, the nets' full widths: eval logits,
train logits with the same dropout keep masks in both (JEnet applies 27
dropouts in forward, CorstemNet none), the gradients of a random linear
functional of them with respect to every parameter and to the input, and
the running statistics, within 1e-9 of their scale (measured ~1e-15).
JEnet's pools and unpools go through ``ops/pool_kernels.py``'s wrappers,
whose CPU path is the plain version with JAX's tie-split gradient.
CorstemNet's transposed convs are flax's ``padding="SAME"``, which the
port writes as an unpadded ``ConvTranspose2d`` that loses its last row and
column: held alone at odd and even sizes against ``nn.ConvTranspose``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dct_tpu_torch.models.joseent import DeconvSame
from dct_tpu_torch.ops import pool_kernels
from dct_tpu_torch.utils.convert import params_from_jax
from test_torch_archref import rel_err
from test_torch_deeplab import QUANTITIES, check
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_zooref import C, jax_run, perturb_stats, port_run, port_seg, trees

H = 32


@pytest.fixture(scope="module", params=["jenet", "cnet"])
def arch(request):
    seg = port_seg(request.param, 1, seed=9)
    perturb_stats(seg.net, 10)
    rs = np.random.RandomState(11)
    x = rs.rand(2, H, H, 1)
    ws = rs.randn(2, H, H, C)
    ref = jax_run((request.param, {}), *trees(seg.net), x, ws)
    return request.param, ref, port_run(seg.net, x, ws, ref["masks"])


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_matches_dct_tpu(arch, quantity):
    name, ref, got = arch
    assert len(ref["masks"]) == (27 if name == "jenet" else 0)
    check(ref, got, quantity)


def test_jenet_runs_the_pool_wrappers(monkeypatch):
    """A JEnet forward pools 3 times (the raw input's C = 1 included) and
    unpools twice, through ``ops/pool_kernels.py``."""
    calls = []
    for name in ("max_pool_2x2_with_mask_kernel", "mask_unpool_2x2_kernel"):
        wrapped = getattr(pool_kernels, name)
        monkeypatch.setattr("dct_tpu_torch.models.joseent." + name,
                            lambda *a, _w=wrapped, _n=name: calls.append(
                                (_n, tuple(a[0].shape))) or _w(*a))
    seg = port_seg("jenet", 1)
    seg.net.eval()
    with torch.no_grad():
        seg.net(torch.rand(2, 64, 64, 1, dtype=torch.float64))
    assert calls == [("max_pool_2x2_with_mask_kernel", (2, 64, 64, 1)),
                     ("max_pool_2x2_with_mask_kernel", (2, 32, 32, 16)),
                     ("max_pool_2x2_with_mask_kernel", (2, 16, 16, 64)),
                     ("mask_unpool_2x2_kernel", (2, 8, 8, 64)),
                     ("mask_unpool_2x2_kernel", (2, 16, 16, 16))]


@pytest.mark.parametrize("hw", [(5, 7), (4, 4), (1, 3)])
def test_deconv_same_matches_flax(hw):
    """flax's ``ConvTranspose(3, strides=2, padding="SAME")`` pads the
    dilated input (2, 1): the port's crop of an unpadded transposed conv
    is exact, at odd sizes too (``padding=1, output_padding=1`` would pad
    (1, 2), another function)."""
    rs = np.random.RandomState(hw[0])
    x = rs.randn(2, *hw, 3)
    flax_conv = nn.ConvTranspose(5, (3, 3), strides=(2, 2), padding="SAME")
    params = {"kernel": rs.randn(3, 3, 3, 5), "bias": rs.randn(5)}
    with jax.enable_x64(True):
        ref = np.asarray(flax_conv.apply({"params": params}, jnp.asarray(x)))
    conv = DeconvSame(3, 5).double()
    conv.load_state_dict({k.split(".", 1)[1]: v for k, v in params_from_jax(
        {"deconv_1": params}, {}).items()})
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], 5)
    assert rel_err(got.detach().numpy(), ref) < 1e-13
