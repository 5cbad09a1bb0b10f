"""Architecture registry (``dct_tpu/models/__init__.py``). Ported: ``enet``,
``deeplabenet`` (the reference's 3-channel Cityscapes ENet, which is ENet
with ``in_channels: 3`` by default), ``unet``, ``unet_bn``, ``segnet``,
``fcn8``, ``fcn16`` and ``fcn32``; the other architectures come in later
slices.

dct_tpu's flax modules take their input channel count from the data they
are initialised on; here ``in_channels`` is a constructor argument, which
``Segmentator`` sets from the data's channel count where its caller gives
one (the CLIs do), whatever the config declares."""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from .enet import Enet
from .fcn import FCN8, FCN16, FCN32
from .segnet import SegNet
from .unet import UNet

ARCH_CALLABLES: Dict[str, Any] = {
    "enet": Enet,
    "deeplabenet": lambda **kw: Enet(**{"in_channels": 3, **kw}),
    "unet": lambda **kw: UNet(use_bn=False, **kw),
    "unet_bn": lambda **kw: UNet(use_bn=True, **kw),
    "segnet": SegNet,
    "fcn8": FCN8,
    "fcn16": FCN16,
    "fcn32": FCN32,
}

# Per-arch BatchNorm momentum, flax convention: new = m·old + (1 − m)·batch.
# The fused two-group co-training forward runs only for an arch listed here
# (the FCNs and UNet without BN have no statistics to fold).
BN_MOMENTUM: Dict[str, float] = {
    "enet": 0.9, "deeplabenet": 0.9, "unet": 0.9, "unet_bn": 0.9, "segnet": 0.9,
    "fcn8": 0.9, "fcn16": 0.9, "fcn32": 0.9}


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
