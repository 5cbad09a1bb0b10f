"""Initial weights of the models a cell trains, drawn on the device from the
seed in a few large calls: one normal draw for every element of every
model, scaled and shifted per leaf by the leaf's family.

Families, by a leaf's name and rank: kernels (rank ≥ 2) xavier-normal,
std sqrt(2 / (fan_in + fan_out)); a rank-1 ``weight`` is a BatchNorm scale,
N(1, 0.02); biases 0; PReLU ``alpha`` 0.25; running means 0 and running
variances 1. The benchmark hands the same tensors to the program and to
the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _family(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(std, mean) of a leaf."""
    if name.endswith("running_mean"):
        return 0.0, 0.0
    if name.endswith("running_var"):
        return 0.0, 1.0
    if name.endswith("alpha"):
        return 0.0, 0.25
    if len(shape) >= 2:
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        return math.sqrt(2.0 / (fan_in + fan_out)), 0.0
    if name.endswith("weight"):
        return 0.02, 1.0
    return 0.0, 0.0


def draw(layout: Dict[str, Tuple[int, ...]], models: int, seed: int,
         device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """``models`` state dicts of the shapes in ``layout`` (name → shape),
    float32 on ``device``."""
    names = list(layout)
    sizes = [math.prod(layout[n]) for n in names]
    per_model = sum(sizes)
    fam = [_family(n, tuple(layout[n])) for n in names]
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(torch.tensor([f[0] for f in fam], device=device), counts)
    mean = torch.repeat_interleave(torch.tensor([f[1] for f in fam], device=device), counts)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn((models, per_model), generator=gen, device=device)
    flat = flat * std + mean
    out = []
    for k in range(models):
        leaves = torch.split(flat[k], sizes)
        out.append({n: leaf.view(layout[n]) for n, leaf in zip(names, leaves)})
    return out
