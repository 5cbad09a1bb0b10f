"""The weight bridge: flax ENet parameter trees ↔ this port's state_dict,
and the port's Adam state ↔ numpy.

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
        raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
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


def params_from_jax_stacked(params: Dict[str, Any], batch_stats: Dict[str, Any],
                            k: int) -> List[Dict[str, torch.Tensor]]:
    """Stacked K-model trees (a leading K axis on every leaf, as dct_tpu's
    ``stack_states`` builds them) → K state_dicts."""
    def take(tree, i):
        return {key: take(v, i) if isinstance(v, Mapping)
                else np.asarray(v)[i] for key, v in tree.items()}
    return [params_from_jax(take(params, i), take(batch_stats, i))
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


def adam_state_to_numpy(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with every tensor as a numpy array (step
    counts and both moments), for ``opt_state.ckpt``."""
    sd = optimizer.state_dict()
    return {"state": {i: {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else v for k, v in st.items()}
                      for i, st in sd["state"].items()},
            "param_groups": [dict(g) for g in sd["param_groups"]]}


def adam_state_from_numpy(optimizer: torch.optim.Optimizer,
                          state: Mapping[str, Any]) -> None:
    """Load what ``adam_state_to_numpy`` wrote into ``optimizer``: the
    moments go to each parameter's device, the step counts stay on the CPU
    as torch's Adam keeps them."""
    optimizer.load_state_dict({
        "state": {int(i): {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                           else v for k, v in st.items()}
                  for i, st in state["state"].items()},
        "param_groups": [dict(g) for g in state["param_groups"]]})
