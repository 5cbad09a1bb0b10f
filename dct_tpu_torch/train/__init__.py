"""Trainers and their steps (``dct_tpu/train``)."""
from .cotrainer import CoTrainer  # noqa: F401
