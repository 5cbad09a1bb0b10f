"""The port's model-parallel co-training step
(``parallel/shard_cotrain.py``) on gloo ranks against dct_tpu's
``make_shard_cotrain_epoch`` over the same (model, data) mesh of the
conftest's virtual CPU devices, and against the port's single process.

* K = 2 on a 2 × 1 mesh (one model a rank), B = Bu = 2, 2 iterations: at
  data 1 the shard step is the joint step, so it also equals the port's
  single process.
* K = 4 on a 2 × 2 mesh (two models a row, a data chunk of 2 images a
  rank), B = Bu = 4, 1 iteration, the pair from the host: the
  data > 1 case of ``tests/test_shard_parity_f64.py:489``. Each rank's
  BatchNorm normalises over its own chunk, so the step is dct_tpu's shard
  step and not the single process's, whose statistics take the global
  batch: the running statistics part from the single process's by far
  more than from dct_tpu's (``test_data_sharded_batchnorm_is_per_shard``).

32², JSD and FGSM (λ_cot 0.5, λ_adv 0.05), SGD at lr 1e-2, no
augmentation (dct_tpu's shard step draws its thetas per model, which the
port draws for the global batch), the network in float64 (parameters, SGD
state and logits fp32). Tolerances are set from the measurements in the
comments; the losses' and updates' gaps are fp32 rounding of the logits,
which FGSM's sign carries into the second iteration.
"""
import pytest

from dct_tpu_torch.parallel.dryrun import cotrain_case, max_rel_diff, merge_models, spawn
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parallel_ref import SGD, jax_cotrain, loss_gaps

COMMON = {"H": 32, "optim": SGD, "lr": 1e-2, "compute": "float64", "augment": False,
          "n_model": 2}
CASES = {"2x1": ({**COMMON, "K": 2, "B": 2, "Bu": 2, "T": 2}, (2, 1)),
         "2x2": ({**COMMON, "K": 4, "B": 4, "Bu": 4, "T": 1}, (2, 2))}
QUANTITIES = ["sup_loss", "jsd_loss", "adv_loss", "params", "stats"]


@pytest.fixture(scope="module")
def runs():
    """Each case's three runs, made when a test first asks for them."""
    cache = {}

    def get(name):
        if name not in cache:
            case, shape = CASES[name]
            ranks = spawn(cotrain_case, shape[0] * shape[1], (case,), timeout=180)
            cache[name] = {"jax": jax_cotrain(case, mesh_shape=shape),
                           "port": {"metrics": ranks[0]["metrics"],
                                    "models": merge_models(ranks)},
                           "single": cotrain_case(0, 1, {**case, "n_model": None})}
        return cache[name]
    return get


def difference(ref, got, quantity):
    if quantity in ("params", "stats"):
        return max_rel_diff(got["models"], ref["models"], stats=quantity == "stats")
    return loss_gaps(ref, got)[quantity]


# measured: 2x1 losses 1.1e-6, params 3.1e-6, statistics 4.2e-7 of scale;
# 2x2 (one iteration) losses 1.5e-6, params 1.2e-7, statistics 2.6e-7
JAX_TOL = {"sup_loss": 1e-5, "jsd_loss": 1e-5, "adv_loss": 1e-5, "params": 2e-5,
           "stats": 1e-5}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("quantity", QUANTITIES)
def test_model_parallel_matches_dct_tpus_shard_step(runs, name, quantity):
    run = runs(name)
    assert difference(run["jax"], run["port"], quantity) <= JAX_TOL[quantity]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_model_parallel_at_data_one_is_the_joint_step(runs, quantity):
    """At data 1 the port's shard step and its single process run the same
    arithmetic (measured equal to the last bit)."""
    run = runs("2x1")
    assert difference(run["single"], run["port"], quantity) <= 1e-12


def test_data_sharded_batchnorm_is_per_shard(runs):
    """At data 2 the running statistics follow dct_tpu's per-shard
    BatchNorm: the single process (global batch) parts from dct_tpu by far
    more than the port does (measured 0.19 against 2.6e-7 of scale)."""
    run = runs("2x2")
    port_vs_jax = difference(run["jax"], run["port"], "stats")
    single_vs_jax = difference(run["jax"], run["single"], "stats")
    assert single_vs_jax > 100 * max(port_vs_jax, 1e-7)
