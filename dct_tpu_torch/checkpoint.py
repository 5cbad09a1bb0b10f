"""Self-describing checkpoints (``dct_tpu/checkpoint.py``): a pickle of a
tree of dicts, lists, Python scalars and numpy arrays.

A checkpoint embeds the arch/optim/scheduler config dicts and all state in
dct_tpu's layout (flax parameter trees, see ``utils/convert.py``), so either
package can rebuild a model from the file alone. Torch tensors are written
as numpy arrays.

:func:`load_checkpoint` unpickles numpy arrays and builtin containers, and
reads the classes of dct_tpu's optimizer states, optax's ``EmptyState``,
``ScaleByAdamState``, ``TraceState`` and ``ScaleByRmsState`` and
dct_tpu's ``AdaBoundState``, as stand-ins of this module's own without
importing optax or dct_tpu (``utils/convert.py:load_optim_state`` maps them
onto the port's optimizers). A pickle that names any other class raises
``pickle.UnpicklingError`` instead of importing that class's package.
"""
from __future__ import annotations

import importlib
import pickle
from pathlib import Path
from typing import Any, Dict, NamedTuple, Union

import torch

# (module, name) a checkpoint may name; numpy 2 writes numpy._core where
# numpy 1 has numpy.core, so each is looked up under both
_ALLOWED = {("numpy", "dtype"), ("numpy", "ndarray"),
            ("numpy.core.numeric", "_frombuffer"),
            ("numpy.core.multiarray", "_reconstruct"),
            ("numpy.core.multiarray", "scalar")}


class EmptyState(NamedTuple):
    """Stands in for ``optax.EmptyState``: the state of the L2 link ahead
    of Adam in dct_tpu's optimizer chain."""


class ScaleByAdamState(NamedTuple):
    """Stands in for ``optax.ScaleByAdamState``: the step count and both
    moments as flax parameter trees (Adam, AdamW)."""

    count: Any
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    """Stands in for ``optax.TraceState``: SGD's momentum trace."""

    trace: Any


class ScaleByRmsState(NamedTuple):
    """Stands in for ``optax.ScaleByRmsState``: RMSprop's ν."""

    nu: Any


class AdaBoundState(NamedTuple):
    """Stands in for ``dct_tpu.optim.AdaBoundState`` (AdaBound, AdaBoundW);
    ``max_nu`` is None without ``amsbound``."""

    count: Any
    mu: Any
    nu: Any
    max_nu: Any


# optax 0.2.6 pickles TraceState from optax.transforms._accumulation, older
# optax from optax._src.transform
_OPTAX = {("optax._src.base", "EmptyState"): EmptyState,
          ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
          ("optax.transforms._accumulation", "TraceState"): TraceState,
          ("optax._src.transform", "TraceState"): TraceState,
          ("optax._src.transform", "ScaleByRmsState"): ScaleByRmsState,
          ("dct_tpu.optim", "AdaBoundState"): AdaBoundState}


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(path: Union[str, Path], payload: Dict[str, Any]) -> None:
    """Atomic write (tmp file + rename): a kill mid-write never leaves a
    truncated checkpoint behind."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _OPTAX:
            return _OPTAX[module, name]
        canonical = module.replace("numpy._core", "numpy.core", 1)
        if (canonical, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}; only numpy arrays, "
                "builtin containers and dct_tpu's optimizer states are read")
        for mod in dict.fromkeys((module, canonical,
                                  canonical.replace("numpy.core", "numpy._core", 1))):
            try:
                return getattr(importlib.import_module(mod), name)
            except (ImportError, AttributeError):
                continue
        raise pickle.UnpicklingError(f"numpy has no {module}.{name}")


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()

