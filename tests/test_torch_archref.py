"""What the architecture parity tests share (no tests of its own): dct_tpu's
flax modules and the port's on the same weights, in float64, with the same
dropout keep masks in both.

* dct_tpu's ``ops/resize.py`` casts to float32 (its matrices are float32
  too), which would put float32 rounding into a float64 comparison of the
  UNet; ``float64_align_corners`` is the same align-corners resize in
  float64, which ``dct_tpu.models.unet`` takes in these tests. The resize
  itself is held against dct_tpu's in float32 (``test_torch_archs.py``).
* The two frameworks draw different dropout streams: ``flax_masks`` makes
  flax's ``nn.Dropout`` take numpy-seeded keep masks in call order and
  records them, and ``inject_masks`` hands the same masks to the port's
  ``layers.Dropout`` layers, which run in the same order.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import dct_tpu.models.unet as jax_unet
from dct_tpu.models import get_arch
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.models.layers import Dropout
from dct_tpu_torch.utils.convert import params_from_jax, params_to_jax

C = 4
TOL = 1e-9
SGD = {"name": "SGD", "lr": 1e-2, "momentum": 0.9}
COSINE = {"name": "CosineAnnealingLR", "T_max": 10}


def float64_align_corners(x, hw):
    """dct_tpu's ``resize_bilinear_align_corners`` in float64: source
    coordinate o·(in − 1)/(out − 1), one point read whole."""
    def matrix(n_out, n_in):
        m = np.zeros((n_out, n_in))
        if n_in == 1 or n_out == 1:
            m[:, 0] = 1.0
            return m
        src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
        frac = src - lo
        m[np.arange(n_out), lo] = 1.0 - frac
        m[np.arange(n_out), lo + 1] += frac
        return m
    if tuple(hw) == tuple(x.shape[1:3]):
        return x
    y = jnp.einsum("oh,bhwc->bowc", matrix(hw[0], x.shape[1]), x)
    return jnp.einsum("pw,bowc->bopc", matrix(hw[1], x.shape[2]), y)


@pytest.fixture(scope="module", autouse=True)
def float64_unet_resize():
    saved = jax_unet._resize_bilinear
    jax_unet._resize_bilinear = float64_align_corners
    yield
    jax_unet._resize_bilinear = saved


def flax_init(name, hw, cin=1, seed=0, **arch):
    """(flax module, params, batch_stats) of dct_tpu's ``name`` initialised
    as its Segmentator does, on a (1, hw, hw, cin) input; numpy float32."""
    model = get_arch(name, {"num_classes": C, **arch})
    rng = jax.random.PRNGKey(seed)
    v = model.init({"params": rng, "dropout": jax.random.fold_in(rng, 1)},
                   jnp.zeros((1, hw, hw, cin), jnp.float32), train=False)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return model, to_np(v["params"]), to_np(v.get("batch_stats", {}))


def port_segmentator(name, params, batch_stats, cin=1, optim=SGD, **arch):
    """The port's Segmentator on the CPU with dct_tpu's weights, its
    parameters, statistics and arithmetic in float64."""
    seg = Segmentator({"name": name, "num_classes": C, **arch}, optim, COSINE,
                      torch.Generator().manual_seed(0), device="cpu", in_channels=cin)
    seg.net.load_state_dict(params_from_jax(params, batch_stats))
    seg.net.double()
    seg.compute_dtype = torch.float64
    return seg


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@contextlib.contextmanager
def flax_masks(seed, record):
    """flax's ``nn.Dropout`` in train mode takes numpy-seeded keep masks (one
    RandomState per call, seeded ``seed`` + call index) and appends each to
    ``record`` (NHWC bool arrays, in call order)."""
    original = nn.Dropout.__call__

    def call(self, inputs, deterministic=None, rng=None):
        deterministic = nn.merge_param("deterministic", self.deterministic, deterministic)
        if deterministic or self.rate == 0:
            return inputs
        keep_prob = 1.0 - self.rate
        keep = np.random.RandomState(seed + len(record)).rand(*inputs.shape) < keep_prob
        record.append(keep)
        return jnp.where(keep, inputs / keep_prob, jnp.zeros_like(inputs))

    nn.Dropout.__call__ = call
    try:
        yield record
    finally:
        nn.Dropout.__call__ = original


def inject_masks(seg, masks):
    """The port's Dropout layers take ``masks`` in forward order (None
    clears them)."""
    layers = [m for m in seg.net.modules() if isinstance(m, Dropout)]
    if masks is None:
        masks = [None] * len(layers)
    assert len(masks) == len(layers)
    for layer, mask in zip(layers, masks):
        layer.keep_mask = None if mask is None else torch.from_numpy(mask)


def rel_err(got, ref):
    """Largest difference relative to the reference's largest magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def tree_error(got, ref):
    """Largest leaf difference relative to that leaf's scale, the scale at
    least 1e-3 of the whole tree's: a conv bias ahead of a train-mode
    BatchNorm has an exactly-zero gradient, which each framework computes
    as rounding noise (1e-14 of the tree's scale in UNet_bn)."""
    top = max(np.abs(v).max() for _, v in _leaves(ref))
    return max(float(np.abs(_get(got, p) - v).max() / max(np.abs(v).max(), 1e-3 * top))
               for p, v in _leaves(ref))


def jax_side(name, hw, cin, b):
    """dct_tpu's eval logits, train logits (numpy-seeded masks), gradients
    of ``sum(logits · w)`` and running statistics, in float64, from one
    compiled call."""
    model, params, stats = flax_init(name, hw, cin)
    rs = np.random.RandomState(hw + cin)
    x = rs.rand(b, hw, hw, cin)
    w = rs.randn(b, hw, hw, C)
    masks = []
    with jax.enable_x64(True):
        def run(p, s, a, w):
            def loss(p):
                out, mut = model.apply({"params": p, "batch_stats": s}, a, train=True,
                                       mutable=["batch_stats"])
                return jnp.sum(out * w), (out, mut)
            (_, (out, mut)), grads = jax.value_and_grad(loss, has_aux=True)(p)
            return model.apply({"params": p, "batch_stats": s}, a, train=False), out, mut, grads

        with flax_masks(7, masks):     # one compile: eval, train and gradient
            eval_logits, train_logits, mut, grads = jax.jit(run)(f64(params), f64(stats), x, w)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return {"name": name, "cin": cin, "params": params, "stats": stats, "x": x, "w": w,
            "masks": masks, "eval": np.asarray(eval_logits), "train": np.asarray(train_logits),
            "grads": to_np(grads), "new_stats": to_np(mut.get("batch_stats", {}))}


def port_train(arch, seg=None, **kw):
    """The port's train forward with dct_tpu's masks: (logits, flax-layout
    gradients, flax-layout running statistics)."""
    if seg is None:
        seg = port_segmentator(arch["name"], arch["params"], arch["stats"], arch["cin"], **kw)
    inject_masks(seg, arch["masks"])
    seg.net.train()
    out = seg.net(torch.from_numpy(arch["x"]))
    torch.sum(out * torch.from_numpy(arch["w"])).backward()
    grads = params_to_jax({n: p.grad for n, p in seg.net.named_parameters()})[0]
    stats = params_to_jax({k: v for k, v in seg.net.state_dict().items() if "running" in k})[1]
    return out.detach().numpy(), grads, stats


def port_side(arch):
    """The port on dct_tpu's weights: its parameter count, eval logits, and
    ``port_train``'s results."""
    seg = port_segmentator(arch["name"], arch["params"], arch["stats"], arch["cin"])
    count = sum(p.numel() for p in seg.net.parameters())
    seg.net.eval()
    with torch.no_grad():
        eval_logits = seg.net(torch.from_numpy(arch["x"])).numpy()
    return {"count": count, "eval": eval_logits, "train": port_train(arch, seg)}
