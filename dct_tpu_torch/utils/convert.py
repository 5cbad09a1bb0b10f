"""The weight bridge: flax ENet parameter trees → this port's state_dict.

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

The trees come in as nested dicts of numpy arrays; this module never
imports JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

_DECONV = {"mid_deconv", "fullconv"}
_LEAF = {"scale": "weight", "kernel": "weight", "bias": "bias",
         "alpha": "alpha", "mean": "running_mean", "var": "running_var"}


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
