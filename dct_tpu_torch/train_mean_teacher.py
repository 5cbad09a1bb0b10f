"""Mean-Teacher entry point (``train_mean_teacher.py`` of dct_tpu), on the
card:

    python -m dct_tpu_torch.train_mean_teacher [--config configs/acdc_meanteacher.yaml] \\
        [--device cuda|cpu] Trainer.save_dir=runs/mt Dataset.root_dir=dataset/ACDC-all

A student and a teacher ENet, each initialised from its own seed; plain
cross-entropy, as dct_tpu's CLI uses. A root whose path holds ``GM`` takes
the GM split, any other ACDC's, as dct_tpu sniffs it. ``--device``,
``Trainer.checkpoint`` (a file), ``Trainer.parallel`` and precision as in
``train_sup``.
"""
from __future__ import annotations

import sys

from .cli import build_segmentators, finish, grp_regex, parallel_mesh, parse_args
from .data.splits import get_dataset_split
from .losses import get_loss_fn
from .train import MeanTeacherTrainer
from .utils.general import fix_all_seed

DEFAULT_CONFIG = "configs/acdc_meanteacher.yaml"


def main(argv=None) -> MeanTeacherTrainer:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    mesh, device = parallel_mesh(trainer_cfg, device)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    dataset_name = "gm" if "GM" in str(config["Dataset"]["root_dir"]) else "acdc"
    labeled_sets, unlab_set, val_set = get_dataset_split(config, dataset_name)
    student, teacher = build_segmentators(config, generator, device, 2)

    trainer = MeanTeacherTrainer(
        student_segmentator=student,
        teacher_segmentator=teacher,
        labeled_dataset=labeled_sets[0],
        unlabeled_dataset=unlab_set,
        val_dataset=val_set,
        criterions={"sup": get_loss_fn("cross_entropy"), "con": "mse"},
        max_epoch=int(trainer_cfg["max_epoch"]),
        save_dir=trainer_cfg["save_dir"],
        axises=trainer_cfg.get("axises", [1, 2, 3]),
        cot_scheduler_dict=config.get("Cot_Scheduler"),
        checkpoint=trainer_cfg.get("checkpoint"),
        metricname=trainer_cfg.get("metricname", "metrics.csv"),
        batch_size=int(config["Lab_Dataloader"]["batch_size"]),
        grp_regex=grp_regex(config, "Lab_Dataloader"),
        seed=seed,
        whole_config=config,
        nan_policy=trainer_cfg.get("nan_policy", "warn"),
        device=device,
        mesh=mesh,
    )
    trainer.start_training()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
    finish()
