"""Co-training entry point (``train_cotraining.py`` of dct_tpu), on the card:

    python -m dct_tpu_torch.train_cotraining [--config configs/acdc_cotraining.yaml] \\
        [--device cuda|cpu] Trainer.save_dir=runs/exp \\
        StartTraining.train_jsd=True StartTraining.train_adv=True

It reads dct_tpu's YAML configs unchanged. ``--device`` defaults to the
card and raises without one; ``--device cpu`` runs on the CPU.
``Trainer.fuse_forward`` (default True) runs the labeled and unlabeled
forwards as one two-group forward per model when ``train_jsd`` and B == Bu,
as dct_tpu does; ``Trainer.adv_dtype`` (``float32`` or ``bfloat16``) runs
the FGSM segment in its own dtype. ``Trainer.parallel`` chooses the mesh
as dct_tpu does (``auto``: ``choose_parallel_mesh(K, world)``; an int: the
model axis of ``make_mesh(world, n_model=int)``, even at world 1); to run
on N ranks, launch under torchrun, on the card or on the CPU:

    torchrun --nproc_per_node N -m dct_tpu_torch.train_cotraining \\
        [--device cpu] Trainer.parallel=auto ...

Config keys of dct_tpu this port does
not carry: ``Trainer.iters_per_dispatch``
must divide ``iters_per_epoch`` as in dct_tpu and changes nothing else,
since the port dispatches per iteration; ``Trainer.device`` is ignored, as
in dct_tpu.

Precision: the CLI keeps PyTorch's defaults. With ``Arch.compute_dtype:
float32`` (the configs' setting) cuDNN convolutions run in TF32
(``torch.backends.cudnn.allow_tf32``) and matmuls in full fp32.
"""
from __future__ import annotations

import sys

from .cli import (build_segmentators, finish, grp_regex, parallel_mesh, parse_args,
                  supervised_loss)
from .data.splits import get_dataset_split
from .losses import get_loss_fn
from .train import CoTrainer
from .train.cotrainer import ITERS_PER_EPOCH
from .utils.general import fix_all_seed

DEFAULT_CONFIG = "configs/acdc_cotraining.yaml"


def check_trainer_config(trainer_cfg) -> None:
    """``Trainer.iters_per_dispatch`` must divide the epoch, as in dct_tpu."""
    per = trainer_cfg.get("iters_per_dispatch")
    iters = int(trainer_cfg.get("iters_per_epoch", ITERS_PER_EPOCH))
    if per:
        assert iters % int(per) == 0, (iters, per)


def main(argv=None) -> CoTrainer:
    config, device = parse_args(argv, DEFAULT_CONFIG)
    trainer_cfg = config["Trainer"]
    check_trainer_config(trainer_cfg)
    n_models = int(config["Lab_Partitions"]["num_models"])
    mesh, device = parallel_mesh(trainer_cfg, device, n_models)
    seed = int(config.get("Seed", 1234))
    generator = fix_all_seed(seed)

    dataset_name = config.get("Dataset", {}).get("name", "acdc")
    labeled_sets, unlab_set, val_set = get_dataset_split(config, dataset_name)
    segmentators = build_segmentators(config, generator, device, n_models)
    criterions = {"sup": supervised_loss(config), "jsd": get_loss_fn("jsd"),
                  "adv": get_loss_fn("jsd")}

    cotrainer = CoTrainer(
        segmentators=segmentators,
        labeled_datasets=labeled_sets,
        unlabeled_dataset=unlab_set,
        val_dataset=val_set,
        criterions=criterions,
        max_epoch=int(trainer_cfg["max_epoch"]),
        save_dir=trainer_cfg["save_dir"],
        axises=trainer_cfg.get("axises", [1, 2, 3]),
        checkpoint=trainer_cfg.get("checkpoint"),
        metricname=trainer_cfg.get("metricname", "metrics.csv"),
        cot_scheduler_dict=config.get("Cot_Scheduler"),
        adv_scheduler_dict=config.get("Adv_Scheduler"),
        adv_training_dict=config.get("Adv_Training", {}),
        batch_size=int(config["Lab_Dataloader"]["batch_size"]),
        unlab_batch_size=int(config["Unlab_Dataloader"]["batch_size"]),
        grp_regex=grp_regex(config, "Lab_Dataloader"),
        iters_per_epoch=int(trainer_cfg.get("iters_per_epoch", ITERS_PER_EPOCH)),
        seed=seed,
        nan_policy=trainer_cfg.get("nan_policy", "warn"),
        whole_config=config,
        fuse_forward=bool(trainer_cfg.get("fuse_forward", True)),
        adv_dtype=trainer_cfg.get("adv_dtype"),
        device=device,
        mesh=mesh,
    )
    cotrainer.start_training(**config["StartTraining"])
    return cotrainer


if __name__ == "__main__":
    main(sys.argv[1:])
    finish()
