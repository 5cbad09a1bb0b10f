"""The port's PSPNet and the MSC multi-scale wrapper against dct_tpu's flax
modules on the same weights, in float64 (``test_torch_zooref.py``; the
DeepLab nets alone: ``test_torch_deeplab.py``).

PSPNet on the ResNet trunk at ``n_blocks`` (1, 1, 1, 1) with ResNet-101's
widths, at 48×64 (a 7×9 map, at least PSPNet's largest bin of 6), the same
dropout keep mask handed to both; and at 40×40, where the trunk's 5×5 map
is smaller than the 6-bin, whose resize back is then an antialiased
shrink. MSC around DeepLabV3+ (``n_blocks`` (1, 1, 1, 1), output stride
8) at scales 0.5 and 0.75 of a 48² input: its train list [48², 24², 36²,
max] and its eval max. For each: eval and train outputs, parameter and
input gradients of a random linear functional of them, and the running
statistics, within 1e-9 of their scale (measured ~1e-15).
"""
import numpy as np
import pytest
import torch

from dct_tpu.models.deeplab import DeepLabV3Plus_ResNet101_MSC as JaxMSC
from dct_tpu_torch.models.deeplab import DeepLabV3Plus_ResNet101_MSC
from dct_tpu_torch.models.layers import init_weights_
from test_torch_deeplab import QUANTITIES, check, weights
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_zooref import C, jax_run, perturb_stats, port_run, port_seg, trees

PSP = {"n_blocks": [1, 1, 1, 1]}
MSC_ARCH = {"n_blocks": [1, 1, 1, 1], "grids": [1], "output_stride": 8}


@pytest.fixture(scope="module", params=[(48, 64), (40, 40)], ids=["48x64", "40x40"])
def psp(request):
    seg = port_seg("pspnet", 1, seed=6, **PSP)
    perturb_stats(seg.net, 7)
    rs = np.random.RandomState(8)
    x = rs.rand(1, *request.param, 1)
    ws = rs.randn(1, *request.param, C)
    ref = jax_run(("pspnet", PSP), *trees(seg.net), x, ws)
    return ref, port_run(seg.net, x, ws, ref["masks"])


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_pspnet_matches_dct_tpu(psp, quantity):
    ref, got = psp
    assert len(ref["masks"]) == 1 and ref["masks"][0].shape[1:] == (
        got["eval"].shape[1] // 8 + 1, got["eval"].shape[2] // 8 + 1, 512)
    check(ref, got, quantity)


@pytest.fixture(scope="module")
def msc():
    net = DeepLabV3Plus_ResNet101_MSC(C, in_channels=3, **MSC_ARCH)
    init_weights_(net, torch.Generator().manual_seed(3))
    net.double()
    perturb_stats(net, 4)
    rs = np.random.RandomState(5)
    x = rs.rand(1, 48, 48, 3)
    net.train()
    with torch.no_grad():
        ws = weights(net(torch.from_numpy(x)), rs)
    ref = jax_run(JaxMSC(C, **MSC_ARCH), *trees(net), x, ws)
    return ref, port_run(net, x, ws)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_msc_matches_dct_tpu(msc, quantity):
    ref, got = msc
    if quantity == "train":
        assert [t.shape[1:3] for t in got["train"]] == [(48, 48), (24, 24), (36, 36), (48, 48)]
    check(ref, got, quantity)
