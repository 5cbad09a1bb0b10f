"""Supervised baseline entry point (``train_sup.py`` of dct_tpu), on the card:

    python -m dct_tpu_torch.train_sup [--config configs/acdc_supervised.yaml] \\
        [--device cuda|cpu] Trainer.save_dir=runs/sup Dataset.root_dir=dataset/ACDC-all

One ENet on the whole train folder. It reads dct_tpu's YAML configs
unchanged; ``--device`` defaults to the card and raises without one,
``--device cpu`` runs on the CPU. ``Trainer.checkpoint`` names a checkpoint
file (``last.ckpt``) to resume from. ``Trainer.parallel``, any value, is
dct_tpu's ``data_parallel_mesh(world)``: none on one rank, data-parallel
over the ranks of a ``torchrun --nproc_per_node N -m dct_tpu_torch.train_sup``
launch (``parallel/data_parallel.py``). The other
keys of dct_tpu's config that the port does not read (``Trainer.device``,
the loaders' ``shuffle``/``drop_last``, ``Dataset.augment``) change
nothing there either. Precision: PyTorch's defaults, as
``train_cotraining`` says.
"""
from __future__ import annotations

import sys

from .cli import (build_segmentators, finish, grp_regex, parallel_mesh, parse_args,
                  supervised_loss)
from .data.dataset import MedicalImageDataset
from .train import Trainer
from .utils.general import fix_all_seed

DEFAULT_CONFIG = "configs/acdc_supervised.yaml"


def main(argv=None) -> Trainer:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    mesh, device = parallel_mesh(trainer_cfg, device)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    ds_cfg = dict(config["Dataset"])
    root = ds_cfg.pop("root_dir")
    ds_cfg.pop("name", None)
    datasets = {"train": MedicalImageDataset(root, "train", **ds_cfg),
                "val": MedicalImageDataset(root, "val", **{**ds_cfg, "quite": True})}
    (seg,) = build_segmentators(config, generator, device, 1)

    trainer = Trainer(
        seg, datasets, supervised_loss(config),
        max_epoch=int(trainer_cfg["max_epoch"]),
        save_dir=trainer_cfg["save_dir"],
        axises=trainer_cfg.get("axises"),
        checkpoint=trainer_cfg.get("checkpoint"),
        metricname=trainer_cfg.get("metricname", "metrics.csv"),
        batch_size=int(config.get("Dataloader", {}).get("batch_size", 4)),
        grp_regex=grp_regex(config, "Dataloader"),
        seed=seed,
        whole_config=config,
        nan_policy=trainer_cfg.get("nan_policy", "warn"),
        device=device,
        mesh=mesh,
    )
    trainer.start_training(**config.get("StartTraining", {}))
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
    finish()
