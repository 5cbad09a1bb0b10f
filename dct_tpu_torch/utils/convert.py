"""The weight bridge: flax ENet parameter trees ↔ this port's state_dict,
and dct_tpu's optax Adam state ↔ torch's Adam state.

The port names every module as dct_tpu names it, so a flax path maps to a
state_dict key by joining it with dots and renaming the leaf:

* ``kernel`` → ``weight``. A conv kernel goes from HWIO to OIHW. A
  ConvTranspose kernel (``mid_deconv``, ``fullconv``) is flipped spatially
  and transposed to torch's (I,O,kh,kw): flax applies it unflipped, torch's
  ConvTranspose2d flipped (the inverse of ``_deconv_k`` in
  ``dct_tpu/utils/torch_convert.py``).
* BatchNorm ``scale`` → ``weight``; ``batch_stats`` ``mean``/``var`` →
  ``running_mean``/``running_var``.
* ``bias`` and PReLU ``alpha`` keep their names.

The trees are nested dicts of numpy arrays; this module never imports JAX.
``params_to_jax`` is the exact inverse of ``params_from_jax``: the port
writes its checkpoints in dct_tpu's flax layout.

Adam's moments are trees of the parameters' shapes, so they take the same
leaf mapping: optax's ``mu`` is torch's ``exp_avg``, ``nu`` is
``exp_avg_sq``, and the one ``count`` is every parameter's ``step``. Both
optax and torch fold L2 into the gradient ahead of the moments, so the
state carries over unchanged. The port writes the state as dct_tpu's tree
layout in plain dicts, ``{"count", "mu", "nu"}``, and reads that or optax's
``(EmptyState(), ScaleByAdamState(count, mu, nu))``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

_DECONV = {"mid_deconv", "fullconv"}
_LEAF = {"scale": "weight", "kernel": "weight", "bias": "bias",
         "alpha": "alpha", "mean": "running_mean", "var": "running_var"}
_STATS = {"running_mean": "mean", "running_var": "var"}


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch(path: Tuple[str, ...], arr) -> Tuple[str, torch.Tensor]:
    leaf = path[-1]
    if leaf not in _LEAF:
        raise KeyError(f"unmapped flax leaf {'/'.join(map(str, path))}")
    a = np.array(arr)
    if leaf == "kernel":
        if path[-2] in _DECONV:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)    # (kh,kw,I,O) → (I,O,kh,kw)
        else:
            a = a.transpose(3, 2, 0, 1)                # (kh,kw,I,O) → (O,I,kh,kw)
    key = ".".join(path[:-1] + (_LEAF[leaf],))
    return key, torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` nested dicts (numpy leaves) of one
    ENet → this port's ENet state_dict (CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, arr in _walk(tree):
            key, t = _to_torch(path, arr)
            out[key] = t
    return out


def _take(tree: Mapping, i: int) -> Dict[str, Any]:
    """Entry ``i`` of every leaf's leading axis."""
    return {key: _take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for key, v in tree.items()}


def _stack(trees: List[Mapping]) -> Dict[str, Any]:
    """Trees of one structure → one tree with a leading axis on every leaf."""
    return {key: _stack([t[key] for t in trees]) if isinstance(v, Mapping)
            else np.stack([np.asarray(t[key]) for t in trees])
            for key, v in trees[0].items()}


def params_from_jax_stacked(params: Dict[str, Any], batch_stats: Dict[str, Any],
                            k: int) -> List[Dict[str, torch.Tensor]]:
    """Stacked K-model trees (a leading K axis on every leaf, as dct_tpu's
    ``stack_states`` builds them) → K state_dicts."""
    return [params_from_jax(_take(params, i), _take(batch_stats, i))
            for i in range(k)]


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """This port's ENet state_dict → flax (``params``, ``batch_stats``)
    nested dicts of numpy arrays: the inverse of ``params_from_jax``."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        path = key.split(".")
        leaf = path[-1]
        a = t.detach().cpu().numpy()
        if leaf in _STATS:
            tree, name = batch_stats, _STATS[leaf]
        else:
            tree = params
            if leaf == "weight" and a.ndim == 4:
                name = "kernel"
                if path[-2] in _DECONV:      # (I,O,kh,kw) → (kh,kw,I,O), unflipped
                    a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
                else:                        # (O,I,kh,kw) → (kh,kw,I,O)
                    a = a.transpose(2, 3, 1, 0)
            elif leaf == "weight":
                name = "scale"
            elif leaf in ("bias", "alpha"):
                name = leaf
            else:
                raise KeyError(f"unmapped state_dict entry {key}")
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[name] = np.ascontiguousarray(a)
    return params, batch_stats


def adam_state_to_jax(optimizer: torch.optim.Optimizer,
                      net: torch.nn.Module) -> Dict[str, Any]:
    """``optimizer``'s Adam state for ``net``'s parameters in dct_tpu's tree
    layout: ``{"count": int32 0-d array, "mu": exp_avg tree, "nu":
    exp_avg_sq tree}``, zero moments before the first step."""
    exp_avg, exp_avg_sq, count = {}, {}, 0
    for name, p in net.named_parameters():
        st = optimizer.state.get(p, {})
        exp_avg[name] = st.get("exp_avg", torch.zeros_like(p))
        exp_avg_sq[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = max(count, int(st.get("step", 0)))
    return {"count": np.asarray(count, np.int32),
            "mu": params_to_jax(exp_avg)[0], "nu": params_to_jax(exp_avg_sq)[0]}


def _adam_fields(state) -> Tuple[Any, Mapping, Mapping]:
    """(count, mu, nu) of the port's ``{"count", "mu", "nu"}`` or of optax's
    ``(EmptyState(), ScaleByAdamState(count, mu, nu))`` (dct_tpu's L2 +
    Adam chain, as ``checkpoint.load_checkpoint`` reads it)."""
    if isinstance(state, Mapping):
        return state["count"], state["mu"], state["nu"]
    if (isinstance(state, tuple) and len(state) == 2 and state[0] == ()
            and getattr(state[1], "_fields", None) == ("count", "mu", "nu")):
        return tuple(state[1])
    raise TypeError(f"not an Adam state of dct_tpu's layout: {type(state).__name__}")


def load_adam_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                    state) -> None:
    """Set ``optimizer``'s Adam state for ``net``'s parameters from one
    model's state in dct_tpu's layout (either form of ``_adam_fields``).
    The moments take each parameter's device, dtype and memory format; the
    step count stays on the CPU, as torch's Adam keeps it. Raises KeyError
    or ValueError when the trees do not match the parameters (another
    architecture, a stacked state, or dct_tpu's ``fused`` flat state)."""
    count, mu, nu = _adam_fields(state)
    moments = params_from_jax(mu, {}), params_from_jax(nu, {})
    params = dict(net.named_parameters())
    for m in moments:
        if m.keys() != params.keys():
            raise KeyError("the Adam state's tree is not the net's parameters")
        for name, p in params.items():
            if m[name].shape != p.shape:
                raise ValueError(f"Adam moment {name} has shape "
                                 f"{tuple(m[name].shape)}, the parameter {tuple(p.shape)}")
    step = float(np.asarray(count))
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.empty_like(p).copy_(moments[0][name]),
            "exp_avg_sq": torch.empty_like(p).copy_(moments[1][name])}


def unstack_adam_state(state, k: int) -> List[Dict[str, Any]]:
    """A K-model Adam state (a leading K axis on every moment and one count,
    as dct_tpu's co-training keeps it) → K per-model states."""
    count, mu, nu = _adam_fields(state)
    for tree in (mu, nu):
        for path, v in _walk(tree):
            if np.shape(v)[:1] != (k,):
                raise ValueError(f"Adam moment {'/'.join(map(str, path))} has "
                                 f"shape {np.shape(v)}, not K={k} stacked models")
    return [{"count": count, "mu": _take(mu, i), "nu": _take(nu, i)} for i in range(k)]


def stack_adam_states(states: List[Mapping]) -> Dict[str, Any]:
    """The inverse of ``unstack_adam_state`` for the port's states, which
    step together and so share one count."""
    return {"count": states[0]["count"], "mu": _stack([s["mu"] for s in states]),
            "nu": _stack([s["nu"] for s in states])}
