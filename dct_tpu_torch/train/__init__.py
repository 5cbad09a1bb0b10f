"""Trainers and their steps (``dct_tpu/train``)."""
from .city import CoTrainerCity, TrainerCity  # noqa: F401
from .cotrainer import CoTrainer  # noqa: F401
from .mean_teacher import MeanTeacherTrainer  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .vat import VatTrainer  # noqa: F401
