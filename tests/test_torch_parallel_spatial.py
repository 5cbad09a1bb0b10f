"""Overlap-tile eval (``dct_tpu_torch/parallel/spatial.py``) on 2 gloo
ranks against dct_tpu's ``make_spatial_eval`` on 2 virtual CPU devices,
on the same ENet weights (the port's init, carried over by
``params_to_jax``) in fp32, and the two-conv net's tiles against its full
image."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.models import get_arch
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.parallel.spatial import make_spatial_eval as jax_spatial_eval
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.parallel.dryrun import CASE, spatial_case, spawn
from dct_tpu_torch.parallel.mesh import make_mesh
from dct_tpu_torch.parallel.spatial import make_spatial_eval
from dct_tpu_torch.utils.convert import params_to_jax
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)

ENET = {"net": "enet", "B": 2, "H": 32, "W": 256, "halo": 32, "seed": 5}


@pytest.fixture(scope="module")
def enet_tiles():
    sd = Segmentator({"name": "enet", "num_classes": 4}, CASE["optim"], CASE["sched"],
                     torch.Generator().manual_seed(ENET["seed"]), device="cpu").net.state_dict()
    ranks = spawn(spatial_case, 2, ({**ENET, "weights": sd},), timeout=120)
    img = torch.rand((ENET["B"], ENET["H"], ENET["W"], 1),
                     generator=torch.Generator().manual_seed(ENET["seed"]))
    params, stats = params_to_jax(sd)
    model = get_arch("enet", {"num_classes": 4})
    def apply(p, s, x):
        return model.apply({"params": p, "batch_stats": s}, x, train=False)
    # fp32 on both sides: dct_tpu's window offsets mix int32 and int64
    # under jax_enable_x64, which its dynamic_slice refuses
    step = jax_spatial_eval(apply, jax_make_mesh(2, n_model=1), ENET["halo"])
    ref = np.asarray(step(params, stats, jnp.asarray(img.numpy())))
    return ranks, ref


def test_tiles_equal_dct_tpus(enet_tiles):
    """Every rank gets the whole output, equal to dct_tpu's tiled one to
    fp32 rounding (measured 9.8e-7 of the logits' scale)."""
    ranks, ref = enet_tiles
    for r in ranks:
        got = r["tiled"].numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_two_conv_tiles_equal_the_full_image():
    ranks = spawn(spatial_case, 2, ({"net": "twoconv", "H": 16, "W": 64, "halo": 8},),
                  timeout=120)
    for r in ranks:
        assert torch.equal(r["tiled"], ranks[0]["full"])


@pytest.mark.parametrize("w,match", [(33, "not divisible"), (16, "too small")])
def test_spatial_eval_keeps_dct_tpus_asserts(w, match):
    step = make_spatial_eval(lambda x: x, make_mesh(2, 1, rank=0), halo=8)
    with pytest.raises(AssertionError, match=match):
        step(torch.zeros((1, 8, w, 1)))
