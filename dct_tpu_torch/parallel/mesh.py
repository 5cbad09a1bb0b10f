"""dct_tpu's device mesh as a grid of ``torch.distributed`` ranks
(``dct_tpu/parallel/mesh.py``).

The mesh has dct_tpu's two axes:

* ``model``: the K co-trained models, K / n_model on each row of ranks;
* ``data``: the batch, cut into equal contiguous chunks.

Ranks are laid out as ``arange(n).reshape(n_model, n // n_model)``, the
order in which dct_tpu lays out ``devices[:n]``. The mesh holds this rank's
(model, data) coordinate and two process groups: the **model group** (the
ranks of this rank's data column, over which the JSD all-gathers the K
models' probabilities) and the **data group** (the ranks of this rank's
model row, over which gradients and BatchNorm statistics are reduced).
Every rank creates every group, in the same order, as ``new_group``
requires.

dct_tpu's placements become local slices: each rank takes exactly what
dct_tpu's shardings put on its device (``place_batches``,
``place_stacked_state``, ``dp_shard_idx``, ``place_replicated``).
``init_distributed`` joins the process group that ``torchrun`` describes.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A (model, data) grid of ``n`` ranks. Built while a process group is
    up, it makes its groups (``n`` must then be the world size); without
    one it is the layout alone, seen from ``rank``."""

    def __init__(self, n: int, n_model: int = 1, rank: Optional[int] = None) -> None:
        assert n % n_model == 0, f"{n} ranks not divisible into {n_model} model groups"
        self.devices = np.arange(n).reshape(n_model, n // n_model)
        self.shape = {"model": n_model, "data": n // n_model}
        live = dist.is_available() and dist.is_initialized()
        if live:
            assert n == dist.get_world_size(), (n, dist.get_world_size())
            rank = dist.get_rank()
        self.rank = int(rank or 0)
        (self.model_index,), (self.data_index,) = np.nonzero(self.devices == self.rank)
        self.model_index, self.data_index = int(self.model_index), int(self.data_index)
        self.data_group = self.model_group = None
        if live and n > 1:
            for row in self.devices:                     # same order on every rank
                g = dist.new_group(row.tolist())
                if self.rank in row:
                    self.data_group = g
            for col in self.devices.T:
                g = dist.new_group(col.tolist())
                if self.rank in col:
                    self.model_group = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"

    def model_rank(self, model_index: int) -> int:
        """The global rank of ``model_index``'s row in this rank's data
        column: the owner of that row's models, in this rank's model group."""
        return int(self.devices[model_index, self.data_index])

    def owner(self, k: int, K: int) -> int:
        """The row of ranks that owns model ``k`` of ``K``."""
        return k // (K // self.shape["model"])


def make_mesh(n_devices: Optional[int] = None, n_model: int = 1,
              rank: Optional[int] = None) -> Mesh:
    """Mesh of shape (model, data) over ``n_devices`` ranks (default: the
    world)."""
    return Mesh(n_devices or world_size(), n_model, rank)


def choose_parallel_mesh(K: int, n_devices: Optional[int] = None,
                         rank: Optional[int] = None) -> Optional[Mesh]:
    """dct_tpu's chooser: model axis gcd(K, n), the rest data; None for one
    rank."""
    n = n_devices or world_size()
    if n <= 1:
        return None
    return make_mesh(n, math.gcd(K, n), rank)


def data_parallel_mesh(n_devices: Optional[int] = None,
                       rank: Optional[int] = None) -> Optional[Mesh]:
    """Data-only (model = 1) mesh for the single-model trainers; None for
    one rank."""
    n = n_devices or world_size()
    return make_mesh(n, 1, rank) if n > 1 else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or the only process: the one that prints and writes files."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _chunk(a, axis: int, i: int, n: int):
    """Chunk ``i`` of ``n`` equal contiguous chunks of ``a`` along ``axis``."""
    size = a.shape[axis]
    assert size % n == 0, f"axis of {size} not divisible into {n} shards"
    step = size // n
    index = [slice(None)] * a.ndim
    index[axis] = slice(i * step, (i + 1) * step)
    return a[tuple(index)]


def place_replicated(mesh: Mesh, tree):
    """Replicated: every rank keeps the whole value."""
    return tree


def place_stacked_state(mesh: Mesh, stacked, K: int):
    """This rank's K / n_model models: its chunk of a K-long list, array
    or tensor (dct_tpu's ``P("model")``)."""
    k_local = K // mesh.shape["model"]
    return stacked[mesh.model_index * k_local:(mesh.model_index + 1) * k_local]


def dp_shard_idx(mesh: Mesh, idx, batch_axis: int = -1):
    """This rank's data chunk of one index array's batch axis."""
    arr = np.asarray(idx)
    return _chunk(arr, batch_axis % arr.ndim, mesh.data_index, mesh.shape["data"])


def place_batches(mesh: Mesh, idx_lab, idx_unlab, pairs):
    """Labeled (T,K,B) over (model, data) on its last two axes, unlabeled
    (T,Bu) over data, pairs whole: this rank's (T, K/n_model, B/n_data),
    (T, Bu/n_data) and pairs."""
    lab = _chunk(np.asarray(idx_lab), 1, mesh.model_index, mesh.shape["model"])
    lab = _chunk(lab, 2, mesh.data_index, mesh.shape["data"])
    unlab = _chunk(np.asarray(idx_unlab), 1, mesh.data_index, mesh.shape["data"])
    return lab, unlab, pairs


def init_distributed(device, timeout: timedelta = timedelta(minutes=30)) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on
    ``cuda:LOCAL_RANK`` for a CUDA ``device``, gloo for the CPU. Returns
    the rank's device."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no card: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
        device, backend = torch.device("cuda", local), "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=timeout)
    return device


def gather_models(segs, mesh: Mesh) -> None:
    """Rank 0 receives, from their owners, the models of ``segs`` (all K,
    of a model-parallel run) that it does not own, with their optimizer
    state: dct_tpu's ``_replicated_stacked`` before eval and checkpoints.
    Every rank takes part."""
    K = len(segs)
    for k, seg in enumerate(segs):
        src = int(mesh.devices[mesh.owner(k, K), 0])
        if src == 0:
            continue
        box = [seg.state_dict if mesh.rank == src else None]
        dist.broadcast_object_list(box, src=src)
        if mesh.rank == 0:
            seg.load_state_dict(box[0])
