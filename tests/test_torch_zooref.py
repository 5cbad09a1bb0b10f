"""What the model-zoo parity tests share (no tests of its own): one net of
the port, initialised by the port, its weights carried to dct_tpu's flax
module by ``utils/convert.py:params_to_jax`` (no flax init runs: an eager
or compiled flax init of these nets takes 2–30 s on the CPU), and both
sides run in float64 on the same numpy inputs.

``jax_run`` compiles one call that returns dct_tpu's eval output, train
output (numpy-seeded dropout masks, ``test_torch_archref.flax_masks``),
the gradients of ``Σ out·w`` with respect to the parameters and the input,
and the new running statistics; ``port_run`` returns the same from the
port with the same masks injected. A train output that is a list (MSC)
takes one weight array per entry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dct_tpu.models import get_arch as jax_get_arch
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.utils.convert import params_to_jax
from test_torch_archref import flax_masks, inject_masks

C = 4
SGD = {"name": "SGD", "lr": 1e-2, "momentum": 0.9}
COSINE = {"name": "CosineAnnealingLR", "T_max": 10}


def port_seg(name, cin, seed=0, optim=SGD, **arch):
    """The port's Segmentator of ``name`` on the CPU, its weights, statistics
    and arithmetic in float64."""
    seg = Segmentator({"name": name, "num_classes": C, **arch}, optim, COSINE,
                      torch.Generator().manual_seed(seed), device="cpu", in_channels=cin)
    seg.net.double()
    seg.compute_dtype = torch.float64
    return seg


def trees(net):
    """(params, batch_stats) numpy trees of a port net, float64."""
    params, stats = params_to_jax(net.state_dict())
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    return f64(params), f64(stats)


def perturb_stats(net, seed):
    """Running statistics away from their init (mean ~N(0, 0.1), var in
    [0.5, 1.5]), so that eval mode reads something other than 0 and 1."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for key, t in net.state_dict().items():
            if key.endswith("running_mean"):
                t.copy_(torch.from_numpy(rs.normal(0, 0.1, t.shape)))
            elif key.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape)))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def jax_run(model, params, stats, x, ws, mask_seed=7):
    """dct_tpu's eval output, train output, parameter and input gradients of
    Σ out·w and new running statistics, in float64, from one compiled call.
    ``model`` is a flax module (or a registry name with its kwargs in a
    tuple); ``ws`` one weight array, or a list for a list output."""
    if isinstance(model, tuple):
        name, arch = model
        model = jax_get_arch(name, {"num_classes": C, **arch})
    masks = []
    with jax.enable_x64(True):
        def run(p, s, a, ws):
            def loss(p, a):
                out, mut = model.apply({"params": p, "batch_stats": s}, a, train=True,
                                       mutable=["batch_stats"])
                outs = out if isinstance(out, list) else [out]
                wl = ws if isinstance(ws, list) else [ws]
                return sum(jnp.sum(o * w) for o, w in zip(outs, wl)), (out, mut)
            (_, (out, mut)), (g_p, g_x) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(p, a)
            ev = model.apply({"params": p, "batch_stats": s}, a, train=False)
            return ev, out, mut, g_p, g_x

        with flax_masks(mask_seed, masks):
            ev, out, mut, g_p, g_x = jax.jit(run)(_f64(params), _f64(stats), x, ws)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return {"eval": to_np(ev), "train": to_np(out), "grads": to_np(g_p),
            "input_grad": np.asarray(g_x), "new_stats": to_np(mut.get("batch_stats", {})),
            "masks": masks}


def port_run(net, x, ws, masks=()):
    """The port's side of ``jax_run`` on the same net state (the running
    statistics are restored after the train forward)."""
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    layers = [m for m in net.modules() if type(m).__name__ == "Dropout"]
    if masks:
        holder = type("S", (), {"net": net})
        inject_masks(holder, list(masks))
    net.eval()
    with torch.no_grad():
        ev = net(torch.from_numpy(x))
    net.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = net(xt)
    outs = out if isinstance(out, list) else [out]
    wl = ws if isinstance(ws, list) else [ws]
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, wl)).backward()
    grads = params_to_jax({n: p.grad for n, p in net.named_parameters()})[0]
    stats = params_to_jax({k: v.clone() for k, v in net.state_dict().items()
                           if "running" in k})[1]
    for layer in layers:
        layer.keep_mask = None
    net.load_state_dict(saved)
    for p in net.parameters():
        p.grad = None
    detach = (lambda o: [t.detach().numpy() for t in o]) if isinstance(out, list) \
        else (lambda o: o.detach().numpy())
    return {"eval": detach(ev) if isinstance(ev, list) else ev.numpy(),
            "train": detach(out), "grads": grads, "input_grad": xt.grad.numpy(),
            "new_stats": stats}
