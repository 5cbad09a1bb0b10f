"""What the port's entry points share: ``--device``, dct_tpu's YAML configs
with dotted overrides, the models, the supervised loss and the patient
regex, read from the config as dct_tpu's CLIs read them."""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import resolve_device
from .config import yaml_parser
from .losses import get_loss_fn
from .models import Segmentator
from .train.trainer import DEFAULT_GRP_REGEX


def parse_args(argv: Optional[List[str]], default_config: str
               ) -> Tuple[Dict[str, Any], torch.device]:
    """``[--device cuda|cpu] [--config path] A.B=value ...`` → (config,
    device). The device is resolved first: without a card and without
    ``--device cpu`` this raises before anything is read. In a ``torchrun``
    launch, ranks other than 0 print nothing from here on."""
    if int(os.environ.get("RANK", 0)) != 0:
        sys.stdout = open(os.devnull, "w")
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default: the current card) or cpu")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    return yaml_parser(default_config, rest), device


def build_segmentators(config: Dict[str, Any], generator: torch.Generator,
                       device, n: int, in_channels: int = 1) -> List[Segmentator]:
    """``n`` Segmentators from one Arch/Optim/Scheduler block, each
    initialised from its own seed drawn from ``generator``, for data of
    ``in_channels`` channels (1 for the medical sets, 3 for Cityscapes, as
    dct_tpu's CLIs initialise on)."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator).tolist()
    return [Segmentator(config["Arch"], config["Optim"], config["Scheduler"],
                        torch.Generator().manual_seed(s), device=device,
                        in_channels=in_channels)
            for s in seeds]


def supervised_loss(config: Dict[str, Any]):
    """The ``Loss`` block (default: plain cross-entropy) as a callable."""
    loss_cfg = dict(config.get("Loss", {"name": "cross_entropy"}))
    return get_loss_fn(loss_cfg.pop("name"), **loss_cfg)


def grp_regex(config: Dict[str, Any], loader: str) -> str:
    """The patient regex of the ``loader`` block's PatientSampler, else
    ACDC's."""
    bs_cfg = config.get(loader, {}).get("batch_sampler")
    return bs_cfg[1]["grp_regex"] if bs_cfg else DEFAULT_GRP_REGEX


def parallel_mesh(trainer_cfg: Dict[str, Any], device: torch.device,
                  n_models: Optional[int] = None):
    """``Trainer.parallel`` → (mesh or None, the rank's device), as dct_tpu's
    CLIs choose: for co-training (``n_models`` given) ``auto`` is
    ``choose_parallel_mesh(K, world)`` and an int the model axis of
    ``make_mesh(world, n_model=int)``, even at world 1; for the other CLIs
    any value is ``data_parallel_mesh(world)``. Under ``torchrun`` (its
    ``WORLD_SIZE`` set) the process group is joined first, NCCL on the card
    and gloo with ``--device cpu``; above one rank an unset
    ``Trainer.parallel`` raises, since every rank would write the same run."""
    from .parallel.mesh import (choose_parallel_mesh, data_parallel_mesh,
                                init_distributed, is_main, make_mesh, world_size)
    if "WORLD_SIZE" in os.environ:
        device = init_distributed(device)
    par = trainer_cfg.get("parallel")
    if par is None:
        if world_size() > 1:
            raise ValueError(f"{world_size()} ranks and Trainer.parallel unset: set "
                             "Trainer.parallel (auto, or the model axis) to train "
                             "across them")
        return None, device
    if n_models is None:
        mesh = data_parallel_mesh()
    elif par == "auto":
        mesh = choose_parallel_mesh(n_models)
    else:
        mesh = make_mesh(n_model=int(par))
    if mesh is not None and is_main():
        print(f">> parallel mesh: {mesh.shape}")
    return mesh, device


def finish() -> None:
    """Leave the process group, if the run joined one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
