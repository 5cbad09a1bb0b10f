"""One supervised iteration of ``jenet`` against dct_tpu's compiled
``make_supervised_epoch``, with the same 27 dropout keep masks injected
into both (``test_torch_archref.py``), on the CPU.

JEnet from the port's init, carried to dct_tpu; 32² one-channel images,
B = 2, SGD with Nesterov momentum; networks in float64, parameters fp32,
logits and loss fp32 on both sides (as in ``test_torch_dropout_paths.py``).
The pools and unpools run the plain versions of ``ops/pool_kernels.py``
here, with JAX's tie-split gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train.steps import make_supervised_epoch as jax_supervised_epoch
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train.steps import make_supervised_epoch
from dct_tpu_torch.utils.convert import params_from_jax, params_to_jax
from test_torch_archref import flax_masks, inject_masks
from test_torch_jaxref import (jax_segmentator, one_torch_thread,  # noqa: F401
                               stats_error, update_agreement)

H, N, C = 32, 6, 4
SGD = {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}
COSINE = {"name": "CosineAnnealingLR", "T_max": 10}
ARCH = {"name": "jenet", "num_classes": C}


@pytest.fixture(scope="module")
def supervised():
    port = Segmentator(ARCH, SGD, COSINE, torch.Generator().manual_seed(0), device="cpu",
                       in_channels=1)
    params, stats = params_to_jax(port.net.state_dict())
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (N, H, H), dtype=np.uint8)
    gt = rs.randint(0, C, (N, H, H)).astype(np.uint8)
    idx = np.array([[4, 1]], np.int32)
    masks = []
    with jax.enable_x64(True):
        seg = jax_segmentator(params, stats, optim=SGD, arch=ARCH, sched=COSINE)
        epoch = jax_supervised_epoch(seg, jax_get_loss_fn("cross_entropy"), C, False)
        with flax_masks(11, masks):
            new, metrics = epoch(seg.state, jnp.asarray(img), jnp.asarray(gt), jnp.asarray(idx),
                                 jax.random.PRNGKey(0), SGD["lr"])
        ref = {"loss": np.asarray(metrics["loss"]),
               "new": params_from_jax(jax.tree_util.tree_map(np.asarray, new["params"]),
                                      jax.tree_util.tree_map(np.asarray, new["batch_stats"]))}
    port.net.load_state_dict(params_from_jax(params, stats))   # the fp32 weights
    port.compute_dtype = torch.float64
    initial = {k: v.clone() for k, v in port.net.state_dict().items()}
    inject_masks(port, masks)
    got = make_supervised_epoch(port, get_loss_fn("cross_entropy"), C, False)(
        torch.from_numpy(img), torch.from_numpy(gt), idx, None, SGD["lr"])
    return {"ref": ref, "initial": initial, "masks": masks,
            "got": {"loss": got["loss"].numpy(), "new": port.net.state_dict()}}


def test_loss_matches_dct_tpu(supervised):
    assert len(supervised["masks"]) == 27
    np.testing.assert_allclose(supervised["got"]["loss"], supervised["ref"]["loss"],
                               rtol=1e-5, atol=0)


def test_update_matches_dct_tpu(supervised):
    """fp32 logits and CE on both sides round differently (~1e-7 of the
    loss), which the update passes on."""
    cos, diff = update_agreement(supervised["initial"], supervised["ref"]["new"],
                                 supervised["got"]["new"])
    assert cos > 1 - 1e-9, cos
    assert diff < 1e-6, diff


def test_statistics_match_dct_tpu(supervised):
    assert stats_error(supervised["ref"]["new"], supervised["got"]["new"]) < 1e-6
