"""dct_tpu's checkpoints with optax Adam state, read by dct_tpu_torch.

* In a process where importing ``jax``, ``flax``, ``optax`` or ``dct_tpu``
  raises, the port loads every committed checkpoint that holds optax state
  (``results/ACDC_vat/best.ckpt`` and the Mean-Teacher student through
  ``Segmentator.from_state_dict``; the co-training runs
  ``results/ACDC_cotrain_r3`` and ``ACDC_cotrain_k3_r4`` through a
  resumed ``CoTrainer``); its torch Adam state must equal the optax arrays
  exactly.
* One Adam step from that state equals one optax step of dct_tpu on the
  same float64 gradients, in float64.
* The eval-mode dice of the trained VAT weights and MT teacher equal
  dct_tpu's ``make_eval_all_step`` on one synthetic bucket, in float64.

Two dct_tpu compiles (the eval step, once per checkpoint).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from dct_tpu.optim import apply_direction, build_optimizer as jax_build_optimizer
from dct_tpu.train.steps import make_eval_all_step as jax_make_eval_all_step
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.optim import set_lr
from dct_tpu_torch.train.steps import make_eval_all_step
from dct_tpu_torch.utils.convert import load_optim_state, params_from_jax
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_jaxref import C, ROOT, jax_segmentator, rings, to_numpy

RESULTS = ROOT / "results"
# (file under results/, payload entry holding the Adam state or None for a
# co-training opt_state.ckpt, number of models)
FILES = [("ACDC_vat/best.ckpt", "segmentator", 1),
         ("ACDC_meanteacher/best_0.7408_85.ckpt", "student", 1),
         ("ACDC_cotrain_r3/opt_state.ckpt", None, 2),
         ("ACDC_cotrain_k3_r4/opt_state.ckpt", None, 3)]

LOADER = r"""
import shutil, sys
for name in ("jax", "flax", "optax", "dct_tpu"):
    sys.modules[name] = None
from pathlib import Path
import numpy as np
import torch
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train import CoTrainer

results, out, tmp = (Path(a) for a in sys.argv[1:4])


def adam(seg):
    return {name: dict(seg.optimizer.state[p]) for name, p in seg.net.named_parameters()}


class Stream:
    filenames = [f"patient{p:03d}_01_0_0" for p in (1, 2)]
    data = {"img": np.zeros((2, 8, 8), np.uint8), "gt": np.zeros((2, 8, 8), np.uint8)}

    def __len__(self):
        return 2


found = {}
for rel, entry in (("ACDC_vat/best.ckpt", "segmentator"),
                   ("ACDC_meanteacher/best_0.7408_85.ckpt", "student")):
    seg = Segmentator.from_state_dict(load_checkpoint(results / rel)[entry], device="cpu")
    found[rel] = [adam(seg)]
for run, k in (("ACDC_cotrain_r3", 2), ("ACDC_cotrain_k3_r4", 3)):
    d = tmp / run
    d.mkdir()
    for i in range(k):             # dct_tpu's last_i.ckpt has best_i.ckpt's payload
        shutil.copy(results / run / f"best_{i}.ckpt", d / f"last_{i}.ckpt")
    shutil.copy(results / run / "opt_state.ckpt", d / "opt_state.ckpt")
    sds = [load_checkpoint(d / f"last_{i}.ckpt")["segmentator"] for i in range(k)]
    segs = [Segmentator(sd["arch_dict"], sd["optim_dict"], sd["scheduler_dict"],
                        torch.Generator().manual_seed(i), device="cpu")
            for i, sd in enumerate(sds)]
    trainer = CoTrainer(segs, [Stream()] * k, Stream(), Stream(),
                        {"sup": None, "jsd": None, "adv": None}, save_dir=d,
                        checkpoint=str(d), batch_size=2, device="cpu")
    found[f"{run}/opt_state.ckpt"] = [adam(s) for s in trainer.segmentators]
torch.save(found, out)
assert not any(k.split(".")[0] in ("jax", "flax", "optax", "dct_tpu")
               for k in sys.modules if sys.modules[k] is not None)
"""


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The port's Adam states of every file, loaded with JAX, optax and
    dct_tpu blocked: {file: [per model: {parameter: torch Adam state}]}."""
    tmp = tmp_path_factory.mktemp("optax")
    proc = subprocess.run([sys.executable, "-c", LOADER, str(RESULTS), str(tmp / "adam.pt"),
                           str(tmp)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "unreadable" not in proc.stdout, proc.stdout
    return torch.load(tmp / "adam.pt")


@pytest.mark.parametrize("rel,entry,k", FILES)
def test_adam_state_equals_the_optax_arrays(loaded, rel, entry, k):
    """Each model's exp_avg, exp_avg_sq and step equal optax's mu, nu and
    count through the weight bridge's leaf mapping, bit for bit."""
    raw = jax_load_checkpoint(RESULTS / rel)
    _, adam = raw["opt_state"] if entry is None else raw[entry]["optim_state_dict"]
    assert len(loaded[rel]) == k
    for i, got in enumerate(loaded[rel]):
        pick = (lambda a: np.asarray(a)) if entry else (lambda a: np.asarray(a)[i])
        moments = [params_from_jax(jax.tree_util.tree_map(pick, m), {})
                   for m in (adam.mu, adam.nu)]
        assert got.keys() == moments[0].keys()
        for name, st in got.items():
            assert float(st["step"]) == int(adam.count) > 0
            assert torch.equal(st["exp_avg"], moments[0][name]), name
            assert torch.equal(st["exp_avg_sq"], moments[1][name]), name
            assert st["exp_avg"].dtype == torch.float32


def float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.asarray(a).dtype,
                                                                jnp.floating)
        else jnp.asarray(a), tree)


@pytest.mark.parametrize("rel,entry", [("ACDC_vat/best.ckpt", "segmentator"),
                                       ("ACDC_meanteacher/best_0.7408_85.ckpt", "student")])
def test_one_adam_step_after_loading_matches_optax(rel, entry):
    """From the file's weights and Adam state, in float64 on both sides:
    dct_tpu's L2 + optax Adam step and torch's Adam step on the same
    gradients give the same parameters and moments: measured 5.5e-16 and
    2.4e-16 of each leaf's largest value apart, float64 rounding (torch
    lerps the first moment and orders Adam's divisions differently)."""
    raw = jax_load_checkpoint(RESULTS / rel)[entry]
    rs = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(lambda a: rs.randn(*np.shape(a)) * 1e-3,
                                   raw["net_state_dict"])
    lr = float(raw["optim_dict"]["lr"])
    with jax.enable_x64(True):
        params = float64(raw["net_state_dict"])
        direction, (_, adam) = jax_build_optimizer(raw["optim_dict"]).update(
            float64(grads), float64(raw["optim_state_dict"]), params)
        ref = params_from_jax(to_numpy(apply_direction(params, direction, lr)), {})
        ref_mu, ref_nu = (params_from_jax(to_numpy(m), {}) for m in (adam.mu, adam.nu))

    port_sd = load_checkpoint(RESULTS / rel)[entry]
    seg = Segmentator(port_sd["arch_dict"], port_sd["optim_dict"], port_sd["scheduler_dict"],
                      torch.Generator().manual_seed(0), device="cpu")
    seg.net.double()
    seg.net.load_state_dict(params_from_jax(port_sd["net_state_dict"], port_sd["batch_stats"]))
    load_optim_state(seg.optimizer, seg.net, port_sd["optim_state_dict"], seg.optim_dict)
    g = params_from_jax(grads, {})
    for name, p in seg.net.named_parameters():
        p.grad = g[name]
    set_lr(seg.optimizer, lr)
    seg.optimizer.step()
    worst = dict.fromkeys(("param", "exp_avg", "exp_avg_sq"), 0.0)
    for name, p in seg.net.named_parameters():
        st = seg.optimizer.state[p]
        assert float(st["step"]) == int(adam.count)
        for key, got, want in (("param", p.detach(), ref[name]),
                               ("exp_avg", st["exp_avg"], ref_mu[name]),
                               ("exp_avg_sq", st["exp_avg_sq"], ref_nu[name])):
            err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))
            worst[key] = max(worst[key], err)
    assert all(err < 1e-14 for err in worst.values()), worst


@pytest.mark.parametrize("rel,entry", [("ACDC_vat/best.ckpt", "segmentator"),
                                       ("ACDC_meanteacher/best_0.7408_85.ckpt", "teacher")])
def test_eval_dice_of_trained_weights_matches_dct_tpu(rel, entry):
    """The trained VAT net and MT teacher through each package's loader and
    eval step, one patient bucket of 5 slices padded to 8, float64 network
    arithmetic and running statistics on both sides: hard dice equal
    (measured), the masked CE from fp32 logits to fp32 rounding (measured
    2.3e-6 (VAT) and 8.3e-7 (MT teacher) of it)."""
    img, gt = rings(5, 32, seed=11)
    indices = np.array([[0, 1, 2, 3, 4, 0, 0, 0]], np.int32)
    masks = indices * 0 + (np.arange(8) < 5)
    raw = jax_load_checkpoint(RESULTS / rel)[entry]
    with jax.enable_x64(True):
        stats = float64(raw["batch_stats"])
        seg = jax_segmentator(raw["net_state_dict"], stats)
        ref = to_numpy(jax_make_eval_all_step(seg, C)(
            seg.state["params"], stats, jnp.asarray(img), jnp.asarray(gt),
            jnp.asarray(indices), jnp.asarray(masks.astype(bool))))

    port = Segmentator.from_state_dict(load_checkpoint(RESULTS / rel)[entry], device="cpu")
    port.net.double()
    port.compute_dtype = torch.float64
    got = {k: v.numpy() for k, v in make_eval_all_step(port, C)(
        torch.from_numpy(img), torch.from_numpy(gt), indices, masks.astype(bool)).items()}
    assert got["dice2d"].shape == ref["dice2d"].shape == (1, 8, C)
    m = masks.astype(bool)
    np.testing.assert_allclose(got["dice2d"][m], ref["dice2d"][m], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["dice3d"], ref["dice3d"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5, atol=0)
    assert 0 < got["dice3d"][:, 1:].mean() < 1
