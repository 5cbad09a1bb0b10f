"""Architecture registry (``dct_tpu/models/__init__.py``). Ported:
``enet`` and ``deeplabenet``, the reference's 3-channel Cityscapes ENet,
which is ENet with ``in_channels: 3`` by default; the other architectures
come in later slices."""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from .enet import Enet

ARCH_CALLABLES: Dict[str, Any] = {
    "enet": Enet,
    "deeplabenet": lambda **kw: Enet(**{"in_channels": 3, **kw}),
}

# Per-arch BatchNorm momentum, flax convention: new = m·old + (1 − m)·batch.
# The fused two-group co-training forward runs only for an arch listed here.
BN_MOMENTUM: Dict[str, float] = {"enet": 0.9, "deeplabenet": 0.9}


def get_arch(arch: str, kwargs: Dict[str, Any]) -> nn.Module:
    """Build a module from a config dict."""
    kwargs = {k: v for k, v in kwargs.items() if k != "arch"}
    ctor = ARCH_CALLABLES.get(arch)
    if ctor is None:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (a later slice); "
            f"available: {sorted(ARCH_CALLABLES)}")
    return ctor(**kwargs)


from .segmentator import Segmentator  # noqa: E402,F401
