"""dct_tpu's side of the baseline trainers' parity tests, shared by
``test_torch_supervised.py``, ``test_torch_vat.py``,
``test_torch_mean_teacher.py`` and ``test_torch_checkpoint_optax.py``.
It holds no test of its own.

The weights come from dct_tpu's committed checkpoints (``results/``), so
no flax init runs: dct_tpu's Segmentator is built around them by
:func:`jax_segmentator`, which sets the attributes its ``__init__`` sets
and skips the eager init (~30 s of CPU time each). Inputs are ACDC-style rings
made with numpy from a seed.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from dct_tpu.models import BN_MOMENTUM, get_arch
from dct_tpu.models import Segmentator as JaxSegmentator
from dct_tpu.optim import build_optimizer as jax_build_optimizer
from dct_tpu.schedules import get_lr_schedule
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
VAT_CKPT = ROOT / "results" / "ACDC_vat" / "best.ckpt"
MT_CKPT = ROOT / "results" / "ACDC_meanteacher" / "best_0.7408_85.ckpt"
C = 4
ARCH = {"name": "enet", "num_classes": C}
# eps 1e-3 instead of Adam's 1e-8, as in test_torch_slice.py: conv biases
# ahead of a train-mode BatchNorm have an exactly-zero gradient, which each
# framework computes as rounding noise; with eps 1e-8 Adam would turn that
# noise into ±lr steps
ADAM = {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-4, "eps": 1e-3}
STEP = {"name": "StepLR", "step_size": 90, "gamma": 0.1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for a module's tests: at 32² torch gains nothing
    from more, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def trained(path=VAT_CKPT, entry="segmentator"):
    """(params, batch_stats) numpy trees of one model of a dct_tpu checkpoint."""
    sd = jax_load_checkpoint(path)[entry]
    return sd["net_state_dict"], sd["batch_stats"]


def jax_segmentator(params, batch_stats, optim=ADAM, arch=ARCH, sched=STEP,
                    compute_dtype="float64"):
    """dct_tpu's Segmentator around the given weights, with a fresh optax
    state: what its ``__init__`` sets, without the eager flax init."""
    seg = JaxSegmentator.__new__(JaxSegmentator)
    seg.arch_dict, seg.optim_dict, seg.scheduler_dict = dict(arch), dict(optim), dict(sched)
    seg.arch_name = arch["name"]
    seg.arch_params = {k: v for k, v in arch.items() if k != "name"}
    seg.compute_dtype = jnp.dtype(compute_dtype)
    seg.model = get_arch(seg.arch_name, seg.arch_params)
    seg.dtype = jnp.float32
    seg.bn_momentum = BN_MOMENTUM.get(seg.arch_name)
    seg.tx = jax_build_optimizer(optim)
    seg.lr_fn = get_lr_schedule(sched, float(optim["lr"]))
    seg.epoch = 0
    params = jax.tree_util.tree_map(jnp.asarray, params)
    seg.state = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, batch_stats),
                 "opt_state": seg.tx.init(params)}
    return seg


def port_segmentator(params, batch_stats, optim=ADAM):
    """The port's Segmentator on the CPU with the given weights, its network
    arithmetic in float64 (parameters, Adam state and logits stay fp32)."""
    seg = Segmentator(ARCH, optim, STEP, torch.Generator().manual_seed(0), device="cpu")
    seg.net.load_state_dict(params_from_jax(params, batch_stats))
    seg.compute_dtype = torch.float64
    return seg


def rings(n, size, seed):
    """``n`` uint8 (img, gt) slices: concentric rings of 4 classes at a
    random centre and a noisy rendering of them."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.zeros((n, size, size), np.uint8)
    gt = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        r = np.hypot(yy - size / 2 - rs.randint(-3, 4), xx - size / 2 - rs.randint(-3, 4))
        for c in range(1, C):
            gt[i][r < size * (0.4 - 0.1 * (c - 1))] = c
        img[i] = (gt[i] / (C - 1) * 180 + rs.randn(size, size) * 12 + 40).clip(0, 255)
    return img, gt


def update_agreement(initial, ref_new, got_new):
    """(cosine, largest element difference) between two parameter updates
    (new − initial, flattened over every non-statistics leaf). The
    difference is relative to each parameter's magnitude (at least 1): the
    parameters are fp32, so an update agrees at best to one ulp of them."""
    keys = [k for k in ref_new if "running" not in k]

    def flat(f):
        return torch.cat([f(k).flatten() for k in keys])
    ref = flat(lambda k: ref_new[k].double() - initial[k].double())
    got = flat(lambda k: got_new[k].double() - initial[k].double())
    scale = flat(lambda k: initial[k].double().abs().clamp_min(1.0))
    cos = float(torch.nn.functional.cosine_similarity(ref, got, dim=0))
    return cos, float(((ref - got).abs() / scale).max())


def stats_error(ref, got):
    """Largest running-statistics difference, relative to each leaf's scale
    (at least 1)."""
    return max(float((got[k].double() - ref[k].double()).abs().max())
               / max(1.0, float(ref[k].abs().max()))
               for k in ref if "running" in k)


def float64_logits(jax_seg, *port_segs):
    """Leave the Segmentators' train-mode logits in float64 (each casts
    them to fp32, as shipped). VAT needs it to be compared closely: its
    power iteration moves the logits by ~1e-8 of themselves, below fp32's
    resolution, so with fp32 logits its gradient carries each framework's
    fp32 rounding of the KL (r_adv 1e-5 of ε apart after one power
    iteration), which training amplifies: with fp32 logits the second VAT
    iteration's adversarial loss parted by 2.5 % and the update's cosine
    fell to 0.9998 (measured)."""
    def jax_apply_train(params, batch_stats, x, dropout_rng=None):
        cparams, cx = jax_seg._cast_in(params, x)
        out, mut = jax_seg.model.apply({"params": cparams, "batch_stats": batch_stats},
                                       cx, train=True, mutable=["batch_stats"])
        return out, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                           mut["batch_stats"])

    def port_apply_train(port_seg):
        def apply_train(x, update_stats=True, groups=1, dtype=None, dropout_generator=None):
            port_seg.net.train()
            for m in port_seg._batch_norms:
                m.update_stats, m.groups = update_stats, groups
            try:
                return port_seg.net(x.to(dtype or torch.float64))
            finally:
                for m in port_seg._batch_norms:
                    m.update_stats, m.groups = True, 1
        return apply_train

    jax_seg.apply_train = jax_apply_train
    for port_seg in port_segs:
        port_seg.apply_train = port_apply_train(port_seg)
