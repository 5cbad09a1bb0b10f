"""Trainers and their steps (``dct_tpu/train``)."""
from .city import CoTrainerCity, TrainerCity  # noqa: F401
from .cotrainer import CoTrainer  # noqa: F401
from .mean_teacher import MeanTeacherTrainer  # noqa: F401
from .steps import (  # noqa: F401
    make_cotrain_epoch,
    make_eval_patient_step,
    make_supervised_epoch,
)
from .trainer import Trainer  # noqa: F401
from .vat import VatTrainer  # noqa: F401
