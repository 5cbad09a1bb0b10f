"""Cityscapes co-training entry point (``train_cotraining_city.py`` of
dct_tpu), on the card:

    python -m dct_tpu_torch.train_cotraining_city \\
        [--config configs/cityscapes_cotraining.yaml] [--device cuda|cpu] \\
        Dataset.root_dir=dataset/Cityscapes Trainer.save_dir=runs/city

K ENets on their labeled shares of the (subsampled) train split and the
shared unlabeled rest, ``train/city.py:CoTrainerCity``. It reads dct_tpu's
YAML configs unchanged, with dotted overrides; ``--device`` defaults to the
card and raises without one, ``--device cpu`` runs on the CPU.
``Trainer.checkpoint`` names a run directory to resume from (its
``last_*.ckpt``). ``Trainer.coco_init_pth`` names the reference's
COCO-pretrained DeepLabV2 weights, a torch ``.pth`` state_dict or a
``.ckpt`` from ``python -m dct_tpu_torch.utils.torch_convert``: every
model takes the tensors whose names and shapes match its own (a DeepLab
trunk; ASPP-v3's names differ, so it keeps its init), as dct_tpu does;
where the file cannot be read or nothing matches (an ENet), it prints the
failure and trains on from its init. ``Trainer.parallel``, any value, is
a data-only mesh over the ranks, as in ``train_sup``;
``Trainer.device`` is ignored, as in dct_tpu. Precision: PyTorch's
defaults, as ``train_cotraining`` says.
"""
from __future__ import annotations

import sys

import torch

from .checkpoint import load_checkpoint
from .cli import build_segmentators, finish, parallel_mesh, parse_args, supervised_loss
from .data.cityscapes import get_cityscapes_split
from .losses import get_loss_fn
from .train import CoTrainerCity
from .utils.convert import params_from_jax, params_to_jax
from .utils.general import fix_all_seed
from .utils.torch_convert import init_from_torch_deeplab

DEFAULT_CONFIG = "configs/cityscapes_cotraining.yaml"


def load_coco_init(segs, pth) -> None:
    """Merge the COCO-pretrained weights at ``pth`` into every model, as
    dct_tpu's ``train_cotraining_city`` does: on any failure of the read or
    the conversion it prints the failure and leaves the models as they
    are. The merge runs on host copies; the models take the result after."""
    hosts = [params_to_jax(s.net.state_dict()) for s in segs]
    try:
        if str(pth).endswith(".ckpt"):
            sd = load_checkpoint(pth)
        else:
            sd = torch.load(pth, map_location="cpu")
        merged = []
        for params, stats in hosts:
            state = init_from_torch_deeplab({"params": params, "batch_stats": stats}, sd)
            merged.append(params_from_jax(state["params"], state["batch_stats"]))
    except Exception as e:  # noqa: BLE001 (dct_tpu warns and goes on)
        print(f"Loading coco pretrained model failed with:\n {e}")
        return
    for s, state_dict in zip(segs, merged):
        s.net.load_state_dict(state_dict)
    print("Coco pretrained model loaded")


def main(argv=None) -> CoTrainerCity:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    mesh, device = parallel_mesh(trainer_cfg, device)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    labeled, unlab, val = get_cityscapes_split(config)
    segs = build_segmentators(config, generator, device,
                              int(config["Lab_Partitions"]["num_models"]), in_channels=3)
    if trainer_cfg.get("coco_init_pth"):
        load_coco_init(segs, trainer_cfg["coco_init_pth"])
    criterions = {"sup": supervised_loss(config), "jsd": get_loss_fn("jsd"),
                  "adv": get_loss_fn("jsd")}
    trainer = CoTrainerCity(
        segs, labeled, unlab, val, criterions,
        max_epoch=int(trainer_cfg["max_epoch"]),
        save_dir=trainer_cfg["save_dir"],
        checkpoint=trainer_cfg.get("checkpoint"),
        metricname=trainer_cfg.get("metricname", "metrics.csv"),
        cot_scheduler_dict=config.get("Cot_Scheduler"),
        adv_scheduler_dict=config.get("Adv_Scheduler"),
        adv_training_dict=config.get("Adv_Training", {}),
        batch_size=int(config["Lab_Dataloader"]["batch_size"]),
        seed=seed,
        augmentations=config["Dataset"].get("augmentations"),
        nan_policy=trainer_cfg.get("nan_policy", "warn"),
        whole_config=config,
        device=device,
        mesh=mesh,
    )
    trainer.start_training(**{k: v for k, v in config.get("StartTraining", {}).items()
                              if k in ("train_jsd", "train_adv", "save_val")})
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
    finish()
