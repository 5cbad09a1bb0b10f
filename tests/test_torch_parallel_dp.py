"""The port's data-parallel co-training step (``train/steps.py:
make_cotrain_epoch(mesh=)``, a data-only mesh) on 2 and 4 gloo ranks,
against dct_tpu's data-parallel epoch (the vmapped step under
``make_mesh(4, n_model=1)``, its batch indices sharded over ``data``, which
GSPMD partitions into the single-device step) and against the port's own
single process.

Case: K = 2, B = Bu = 4 (2 and 1 images a rank), 32², 2 iterations of
SGD (lr 1e-2), JSD and FGSM (λ_cot 0.5, λ_adv 0.05), the network in
float64 (parameters, SGD state and logits fp32), and a cross-entropy with
unequal class weights: a rank's loss is its numerator over the weight
summed over every rank, since a mean of per-rank weighted means is not the
global weighted mean (``test_weighted_mean_of_rank_means_is_not_the_global_mean``).
Against the single process with augmentation (the global batch's thetas,
each rank its rows); against dct_tpu without it: on warped images
dct_tpu's compiled step parts from its own un-jitted run, XLA's fused
float64 arithmetic flipping FGSM signs (``test_torch_dropout_paths.py``),
which here moved the adversarial loss by 3.4e-4 and the statistics by
7.5e-3 at every world, the single process included (measured). The ranks
spawn from ``dct_tpu_torch.parallel.dryrun`` (one torch thread each, a
FileStore rendezvous, a 180 s deadline).
"""
import pytest
import torch

from dct_tpu_torch.losses import cross_entropy2d
from dct_tpu_torch.parallel.dryrun import (case_inputs, cotrain_case, max_rel_diff,
                                           merge_models, spawn)
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parallel_ref import SGD, jax_cotrain, loss_gaps

WEIGHTS = [0.5, 2.0, 1.0, 4.0]
CASE = {"K": 2, "B": 4, "Bu": 4, "H": 32, "T": 2, "optim": SGD, "lr": 1e-2,
        "compute": "float64", "loss": {"name": "cross_entropy", "weight": WEIGHTS}}
QUANTITIES = ["sup_loss", "jsd_loss", "adv_loss", "params", "stats"]


@pytest.fixture(scope="module")
def jax_dp():
    return jax_cotrain({**CASE, "augment": False}, mesh_shape=(1, 4))


@pytest.fixture(scope="module")
def port():
    """The port's epoch with and without augmentation: one process, 2 and
    4 ranks."""
    out = {}
    for augment in (True, False):
        case = {**CASE, "augment": augment}
        out[augment, 1] = cotrain_case(0, 1, case)
        for world in (2, 4):
            ranks = spawn(cotrain_case, world, ({**case, "n_model": 1},), timeout=180)
            out[augment, world] = {"metrics": ranks[0]["metrics"],
                                   "models": merge_models(ranks)}
    return out


def difference(ref, got, quantity):
    if quantity in ("params", "stats"):
        return max_rel_diff(got["models"], ref["models"], stats=quantity == "stats")
    return loss_gaps(ref, got)[quantity]


# against the single process: the same arithmetic but the order of the
# reductions (BatchNorm's statistics, the losses' sums, the gradient sum);
# measured at most 1.2e-7 on the losses, 3.0e-8 (params) and 9.6e-8
# (statistics) of scale
SINGLE_TOL = {"sup_loss": 1e-6, "jsd_loss": 1e-6, "adv_loss": 1e-6, "params": 1e-6,
              "stats": 1e-6}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("quantity", QUANTITIES)
def test_data_parallel_equals_one_process(port, world, quantity):
    assert difference(port[True, 1], port[True, world], quantity) <= SINGLE_TOL[quantity]


# against dct_tpu's data-parallel epoch: fp32 rounding of the logits and
# the fp32 parameters; measured at most 8.3e-7 on the losses, 1.2e-7
# (params) and 3.6e-7 (statistics) of scale, the same at every world
JAX_TOL = {"sup_loss": 1e-5, "jsd_loss": 1e-5, "adv_loss": 1e-5, "params": 1e-5,
           "stats": 1e-5}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("quantity", QUANTITIES)
def test_data_parallel_matches_dct_tpu(jax_dp, port, world, quantity):
    assert difference(jax_dp, port[False, world], quantity) <= JAX_TOL[quantity]


def test_weighted_mean_of_rank_means_is_not_the_global_mean():
    """On the case's first labeled batch and random logits, the mean of two
    ranks' weighted means is off the global weighted mean by 9.1e-5
    (measured), 90 times ``SINGLE_TOL``'s loss bound: a step that averaged
    per-rank means would fail the tests above. The shares over the summed
    weight add up to the global mean."""
    inp = case_inputs(CASE)
    gt = torch.from_numpy(inp["gt"][inp["idx_lab"][0, 0]]).long()
    logits = torch.randn(gt.shape + (4,), generator=torch.Generator().manual_seed(0),
                         dtype=torch.float64)
    whole = cross_entropy2d(logits, gt, WEIGHTS)
    halves = [cross_entropy2d(logits[i:i + 2], gt[i:i + 2], WEIGHTS) for i in (0, 2)]
    assert abs(float(sum(halves) / 2 - whole)) > 50 * SINGLE_TOL["sup_loss"]
    total_weight = torch.tensor(WEIGHTS, dtype=torch.float64)[gt].sum()
    shares = [cross_entropy2d(logits[i:i + 2], gt[i:i + 2], WEIGHTS,
                              den_reduce=lambda d: total_weight) for i in (0, 2)]
    assert abs(float(sum(shares) - whole)) < 1e-12
