"""dct_tpu_torch — the PyTorch/CUDA counterpart of ``dct_tpu`` for one NVIDIA
H100.

Each module mirrors a ``dct_tpu`` module of the same name and keeps its
public functions' names and NHWC layout, so a reader finds each counterpart.
Plain tensor code is stock PyTorch; the two Pallas kernels of
``dct_tpu/ops/pallas_pool.py`` are CUDA kernels written by hand for Hopper
(``csrc/pool_mask.cu``, bound in ``ops/pool_kernels.py``).

This package imports ``torch`` and never JAX or ``dct_tpu``. Entry points
take an explicit ``device``: they run on ``cuda`` and raise when no card is
present, unless the caller passes ``device="cpu"``.
"""
from enum import Enum

import torch

__version__ = "0.1.0"


class ModelMode(Enum):
    """Mode shared by datasets and models."""

    TRAIN = "TRAIN"
    EVAL = "EVAL"
    PRED = "PRED"

    @staticmethod
    def from_str(mode_str: str) -> "ModelMode":
        if mode_str.lower() in ("train", "training"):
            return ModelMode.TRAIN
        if mode_str.lower() in ("eval", "testing", "val", "test"):
            return ModelMode.EVAL
        if mode_str.lower() in ("predict", "pred"):
            return ModelMode.PRED
        raise ValueError(f"unknown mode {mode_str!r}")


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device; ``"cpu"`` → the CPU.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
