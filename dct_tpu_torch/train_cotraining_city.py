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
``last_*.ckpt``). ``Trainer.coco_init_pth`` (DeepLab's COCO weights) and
``Trainer.parallel`` raise; ``Trainer.device`` is ignored, as in dct_tpu.
Precision: PyTorch's defaults, as ``train_cotraining`` says.
"""
from __future__ import annotations

import sys

from .cli import (build_segmentators, parse_args, reject_coco_init,
                  reject_parallel, supervised_loss)
from .data.cityscapes import get_cityscapes_split
from .losses import get_loss_fn
from .train import CoTrainerCity
from .utils.general import fix_all_seed

DEFAULT_CONFIG = "configs/cityscapes_cotraining.yaml"


def main(argv=None) -> CoTrainerCity:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    reject_coco_init(trainer_cfg)
    reject_parallel(trainer_cfg)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    labeled, unlab, val = get_cityscapes_split(config)
    segs = build_segmentators(config, generator, device,
                              int(config["Lab_Partitions"]["num_models"]), in_channels=3)
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
    )
    trainer.start_training(**{k: v for k, v in config.get("StartTraining", {}).items()
                              if k in ("train_jsd", "train_adv", "save_val")})
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
