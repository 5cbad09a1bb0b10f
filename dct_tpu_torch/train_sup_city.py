"""Supervised Cityscapes entry point (``train_sup_city.py`` of dct_tpu), on
the card:

    python -m dct_tpu_torch.train_sup_city \\
        [--config configs/cityscapes_supervised.yaml] [--device cuda|cpu] \\
        Dataset.root_dir=dataset/Cityscapes Trainer.save_dir=runs/city_sup

One ENet on the whole (subsampled) train split, no partitions and no
semi-supervised terms (``train/city.py:TrainerCity``). Config, overrides,
``--device``, ``Trainer.checkpoint`` (a run directory) and
``Trainer.parallel`` (a data-only mesh) as in ``train_cotraining_city``. As in
dct_tpu, ``Trainer.coco_init_pth`` is not read here and
``StartTraining.save_val`` dumps nothing.
"""
from __future__ import annotations

import sys

from .cli import build_segmentators, finish, parallel_mesh, parse_args, supervised_loss
from .data.cityscapes import CityscapesDataset
from .train import TrainerCity
from .utils.general import fix_all_seed

DEFAULT_CONFIG = "configs/cityscapes_supervised.yaml"


def main(argv=None) -> TrainerCity:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    mesh, device = parallel_mesh(trainer_cfg, device)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    ds_cfg = config["Dataset"]
    size = tuple(ds_cfg.get("image_size", (512, 1024)))
    subsample = int(ds_cfg.get("subsample", 20))
    train = CityscapesDataset(ds_cfg["root_dir"], "train", size, subsample)
    val = CityscapesDataset(ds_cfg["root_dir"], "val", size, subsample, quite=True)
    (seg,) = build_segmentators(config, generator, device, 1, in_channels=3)

    trainer = TrainerCity(
        seg, train, train, val, supervised_loss(config),
        max_epoch=int(trainer_cfg["max_epoch"]),
        save_dir=trainer_cfg["save_dir"],
        checkpoint=trainer_cfg.get("checkpoint"),
        metricname=trainer_cfg.get("metricname", "metrics.csv"),
        batch_size=int(config.get("Dataloader", {}).get("batch_size", 4)),
        seed=seed,
        augmentations=ds_cfg.get("augmentations"),
        nan_policy=trainer_cfg.get("nan_policy", "warn"),
        whole_config=config,
        device=device,
        mesh=mesh,
    )
    trainer.start_training()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
    finish()
