"""The weight bridge: flax parameter trees ↔ this port's state_dict, and
dct_tpu's optax optimizer states ↔ the port's optimizer states.

The port names every module as dct_tpu names it (flax's auto-names
included: ``dec1/Conv_0``, ``enc4/_DoubleConv_0/BatchNorm_0``,
``vgg/stage1/conv0``, ``fconn/Conv_1``), so a flax path maps to a
state_dict key by joining it with dots and renaming the leaf:

* ``kernel`` → ``weight``. A conv kernel goes from HWIO to OIHW. A
  ConvTranspose kernel (ENet's ``mid_deconv`` and ``fullconv``, UNet's
  ``center_up`` and ``ConvTranspose_0``, CorstemNet's ``deconv_1`` …
  ``deconv_4``) is flipped spatially and transposed to torch's
  (I,O,kh,kw): flax applies it unflipped, torch's ConvTranspose2d flipped
  (the inverse of ``_deconv_k`` in ``utils/torch_convert.py``). A Dense
  kernel (in, out) becomes ``nn.Linear``'s (out, in).
* BatchNorm ``scale`` → ``weight``; ``batch_stats`` ``mean``/``var`` →
  ``running_mean``/``running_var``.
* ``bias`` and PReLU ``alpha`` keep their names.

The trees are nested dicts of numpy arrays; this module never imports JAX.
``params_to_jax`` is the exact inverse of ``params_from_jax``: the port
writes its checkpoints in dct_tpu's flax layout.

An optimizer's moments are trees of the parameters' shapes, so they take
the same leaf mapping (``_TREES``: optax's ``mu`` is torch's ``exp_avg``,
``nu`` its ``exp_avg_sq``, …), and the one ``count`` is every parameter's
``step``. The port writes a state as a plain dict of optax's fields
(``{"count", "mu", "nu"}`` for Adam, ``{"trace"}`` for SGD, …) and reads
that or optax's chain tuple, e.g. ``(EmptyState(), ScaleByAdamState(count,
mu, nu))``. With ``Optim.fused`` each tree is dct_tpu's ``flatten_tx``
layout instead, one vector per dtype in ``tree_flatten`` order.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# the ConvTranspose modules: ENet's, UNet's ``center_up`` and its decoder
# stages' ``ConvTranspose_0``, and CorstemNet's four
_DECONV = {"mid_deconv", "fullconv", "center_up", "ConvTranspose_0",
           "deconv_1", "deconv_2", "deconv_3", "deconv_4"}
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
        if a.ndim == 2:
            a = a.T                                    # (in,out) → (out,in)
        elif path[-2] in _DECONV:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)    # (kh,kw,I,O) → (I,O,kh,kw)
        else:
            a = a.transpose(3, 2, 0, 1)                # (kh,kw,I,O) → (O,I,kh,kw)
    key = ".".join(path[:-1] + (_LEAF[leaf],))
    return key, torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` nested dicts (numpy leaves) of one
    net → this port's state_dict of that net (CPU tensors)."""
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
    """This port's state_dict of a net → flax (``params``, ``batch_stats``)
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
            if leaf == "weight" and a.ndim == 2:
                name, a = "kernel", a.T      # (out,in) → (in,out)
            elif leaf == "weight" and a.ndim == 4:
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


# the trees of each optimizer's state, in dct_tpu's names, and where the
# port keeps each one in ``optimizer.state[p]``; ``count`` is optax's step
# count, torch's ``step``
_TREES = {"Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "AdamW": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "SGD": {"trace": "trace"},
          "RMSprop": {"nu": "square_avg"},
          "AdaBound": {"mu": "exp_avg", "nu": "exp_avg_sq", "max_nu": "max_exp_avg_sq"},
          "AdaBoundW": {"mu": "exp_avg", "nu": "exp_avg_sq", "max_nu": "max_exp_avg_sq"}}
_COUNTED = {"Adam", "AdamW", "AdaBound", "AdaBoundW"}


def _layout(optim_dict: Mapping) -> Tuple[Dict[str, Any], bool, bool]:
    """(tree name → torch state key or None, has a count, fused) of the
    state of ``optim_dict``'s optimizer: SGD without momentum keeps no
    tree, AdaBound's ``max_nu`` is None without ``amsbound``."""
    name = optim_dict["name"]
    trees = dict(_TREES[name])
    if name == "SGD" and not float(optim_dict.get("momentum", 0.0)):
        trees = {}
    if name.startswith("AdaBound") and not optim_dict.get("amsbound", False):
        trees["max_nu"] = None
    return trees, name in _COUNTED, bool(optim_dict.get("fused", False))


def _sorted_leaves(tree: Mapping) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in ``jax.tree_util.tree_flatten`` order (sorted keys)."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            out.extend(((k,) + p, leaf) for p, leaf in _sorted_leaves(tree[k]))
        else:
            out.append(((k,), tree[k]))
    return out


def _flatten_tree(tree: Mapping) -> Dict[Any, np.ndarray]:
    """A parameter-shaped tree → dct_tpu's ``fused`` layout (``optim.py:
    flatten_tx``): one vector per dtype, the raveled leaves in
    ``tree_flatten`` order."""
    flat: Dict[Any, list] = {}
    for _, leaf in _sorted_leaves(tree):
        a = np.asarray(leaf)
        flat.setdefault(a.dtype, []).append(a.ravel())
    return {dt: np.concatenate(parts) for dt, parts in flat.items()}


def _unflatten_tree(flat, template: Mapping) -> Dict[str, Any]:
    """The inverse of ``_flatten_tree`` against ``template``, a tree of the
    leaves' shapes and dtypes (numpy arrays). Raises ValueError when ``flat``
    is not that layout."""
    if not isinstance(flat, Mapping) or any(isinstance(k, str) for k in flat):
        raise ValueError("not dct_tpu's fused layout (one vector per dtype)")
    offsets = {dt: 0 for dt in flat}
    out: Dict[str, Any] = {}
    for path, t in _sorted_leaves(template):
        vec = np.asarray(flat.get(t.dtype, np.empty(0, t.dtype)))
        off = offsets.get(t.dtype, 0)
        if off + t.size > vec.size:
            raise ValueError("the fused state is shorter than the parameters")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = vec[off:off + t.size].reshape(t.shape)
        offsets[t.dtype] = off + t.size
    if any(offsets[dt] != np.asarray(v).size for dt, v in flat.items()):
        raise ValueError("the fused state is longer than the parameters")
    return out


def _fields(state) -> Dict[str, Any]:
    """The fields of one optimizer state: the port's plain dict, or optax's
    chain tuple of states (``checkpoint.load_checkpoint``'s stand-ins), of
    which at most one is not empty."""
    if isinstance(state, Mapping):
        return dict(state)
    if isinstance(state, tuple) and all(hasattr(s, "_fields") for s in state):
        full = [s for s in state if len(s)]
        if len(full) <= 1:
            return full[0]._asdict() if full else {}
    raise TypeError(f"not an optimizer state of dct_tpu's layout: {type(state).__name__}")


def _check_fields(fields: Mapping, optim_dict: Mapping) -> None:
    trees, counted, _ = _layout(optim_dict)
    want = set(trees) | ({"count"} if counted else set())
    if set(fields) != want:
        raise KeyError(f"the state has {sorted(fields)}, {optim_dict['name']} keeps "
                       f"{sorted(want)}")


def optim_state_to_jax(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                       optim_dict: Mapping) -> Dict[str, Any]:
    """``optimizer``'s state for ``net``'s parameters in dct_tpu's layout,
    as a plain dict of optax's fields: ``count`` (an int32 0-d array) where
    the optimizer counts, and each tree of ``_TREES`` as a flax parameter
    tree, zeros before the first step (None for AdaBound's ``max_nu``
    without ``amsbound``). With ``fused`` in ``optim_dict`` each tree is
    dct_tpu's flat per-dtype vector."""
    trees, counted, fused = _layout(optim_dict)
    out: Dict[str, Any] = {}
    if counted:
        steps = [int(optimizer.state.get(p, {}).get("step", 0)) for p in net.parameters()]
        out["count"] = np.asarray(max(steps, default=0), np.int32)
    for field, key in trees.items():
        if key is None:
            out[field] = None
            continue
        tree = params_to_jax({name: optimizer.state.get(p, {}).get(key, torch.zeros_like(p))
                              for name, p in net.named_parameters()})[0]
        out[field] = _flatten_tree(tree) if fused else tree
    return out


def _template(net: torch.nn.Module, k: Optional[int] = None) -> Dict[str, Any]:
    """A flax-layout tree of ``net``'s parameters' shapes and dtypes (with
    a leading K axis when ``k`` is given), as zero-strided numpy views."""
    tree: Dict[str, Any] = {}
    for key, p in net.named_parameters():
        path = key.split(".")
        shape, name = tuple(p.shape), path[-1]
        if name == "weight" and p.ndim == 2:
            name, shape = "kernel", shape[::-1]
        elif name == "weight" and p.ndim == 4:
            name = "kernel"
            io = shape[:2] if path[-2] in _DECONV else shape[1::-1]
            shape = shape[2:] + io
        elif name == "weight":
            name = "scale"
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        zero = torch.zeros((), dtype=p.dtype).numpy()
        node[name] = np.broadcast_to(zero, ((k,) if k else ()) + shape)
    return tree


def load_optim_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                     state, optim_dict: Mapping) -> None:
    """Set ``optimizer``'s state for ``net``'s parameters from one model's
    state in dct_tpu's layout (the port's dict or optax's chain tuple,
    per-leaf or, with ``fused``, flat). The trees take each parameter's
    device, dtype and memory format; torch's Adam keeps its step count as a
    CPU tensor, the port's optimizers as an int. Raises KeyError, TypeError
    or ValueError when the state does not match the optimizer or the
    parameters (another optimizer or architecture, a stacked state, the
    other of the per-leaf and fused layouts)."""
    fields = _fields(state)
    _check_fields(fields, optim_dict)
    trees, counted, fused = _layout(optim_dict)
    params = dict(net.named_parameters())
    moments = {}
    for field, key in trees.items():
        if key is None:
            continue
        tree = fields[field]
        if fused:
            tree = _unflatten_tree(tree, _template(net))
        m = params_from_jax(tree, {})
        if m.keys() != params.keys():
            raise KeyError(f"the state's {field} tree is not the net's parameters")
        for name, p in params.items():
            if m[name].shape != p.shape:
                raise ValueError(f"{field} of {name} has shape {tuple(m[name].shape)}, "
                                 f"the parameter {tuple(p.shape)}")
        moments[key] = m
    count = int(np.asarray(fields["count"])) if counted else None
    for name, p in params.items():
        st = {key: torch.empty_like(p).copy_(m[name]) for key, m in moments.items()}
        if counted:
            st["step"] = (torch.tensor(float(count), dtype=torch.float32)
                          if isinstance(optimizer, torch.optim.Adam) else count)
        optimizer.state[p] = st


def unstack_optim_state(state, k: int, net: torch.nn.Module,
                        optim_dict: Mapping) -> List[Dict[str, Any]]:
    """A K-model state (a leading K axis on every tree leaf and one count,
    as dct_tpu's co-training keeps it; with ``fused``, the flat vectors of
    the stacked trees) → K per-model per-leaf states."""
    fields = _fields(state)
    _check_fields(fields, optim_dict)
    trees, _, fused = _layout(optim_dict)
    out = [{f: v for f, v in fields.items() if f not in trees} for _ in range(k)]
    for field, key in trees.items():
        tree = fields[field]
        if key is not None:
            if fused:
                tree = _unflatten_tree(tree, _template(net, k))
            for path, v in _walk(tree):
                if np.shape(v)[:1] != (k,):
                    raise ValueError(f"{field} {'/'.join(map(str, path))} has shape "
                                     f"{np.shape(v)}, not K={k} stacked models")
        for i in range(k):
            out[i][field] = None if key is None else _take(tree, i)
    return out


def stack_optim_states(states: List[Mapping], net: torch.nn.Module,
                       optim_dict: Mapping) -> Dict[str, Any]:
    """The inverse of ``unstack_optim_state`` for the port's states (of
    ``optim_state_to_jax``, flat with ``fused``), which step together and
    so share one count."""
    trees, _, fused = _layout(optim_dict)
    out = {f: v for f, v in states[0].items() if f not in trees}
    for field, key in trees.items():
        if key is None:
            out[field] = None
            continue
        per_model = [_unflatten_tree(s[field], _template(net)) if fused else s[field]
                     for s in states]
        tree = _stack(per_model)
        out[field] = _flatten_tree(tree) if fused else tree
    return out
