"""VAT entry point (``train_vat.py`` of dct_tpu), on the card:

    python -m dct_tpu_torch.train_vat [--config configs/acdc_vat.yaml] \\
        [--device cuda|cpu] Trainer.save_dir=runs/vat Dataset.root_dir=dataset/ACDC-all

One ENet on the first labeled partition of the dataset's split, the
unlabeled set for the VAT term. ``--device``, ``Trainer.checkpoint`` (a
file), ``Trainer.parallel`` and precision as in ``train_sup``.
"""
from __future__ import annotations

import sys

from .cli import (build_segmentators, finish, grp_regex, parallel_mesh, parse_args,
                  supervised_loss)
from .data.splits import get_dataset_split
from .train import VatTrainer
from .utils.general import fix_all_seed

DEFAULT_CONFIG = "configs/acdc_vat.yaml"


def main(argv=None) -> VatTrainer:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    mesh, device = parallel_mesh(trainer_cfg, device)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    dataset_name = config.get("Dataset", {}).get("name", "acdc")
    labeled_sets, unlab_set, val_set = get_dataset_split(config, dataset_name)
    (seg,) = build_segmentators(config, generator, device, 1)

    trainer = VatTrainer(
        seg, labeled_sets[0], unlab_set, val_set, supervised_loss(config),
        max_epoch=int(trainer_cfg["max_epoch"]),
        save_dir=trainer_cfg["save_dir"],
        axises=trainer_cfg.get("axises", [1, 2, 3]),
        checkpoint=trainer_cfg.get("checkpoint"),
        metricname=trainer_cfg.get("metricname", "metrics.csv"),
        adv_scheduler_dict=config.get("Adv_Scheduler"),
        adv_training_dict=config.get("Adv_Training", {}),
        batch_size=int(config["Lab_Dataloader"]["batch_size"]),
        grp_regex=grp_regex(config, "Lab_Dataloader"),
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
