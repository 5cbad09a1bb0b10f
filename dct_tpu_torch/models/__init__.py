"""Architecture registry (``dct_tpu/models/__init__.py``): every name
dct_tpu registers, ``enet``, ``deeplabenet`` (the reference's 3-channel
Cityscapes ENet, which is ENet with ``in_channels: 3`` by default),
``unet``, ``unet_bn``, ``segnet``, ``fcn8``, ``fcn16``, ``fcn32``,
``pspnet``, ``deeplabv2``, ``deeplabv3``, ``deeplabv3plus``, ``jenet``,
``cnet``, ``vgg11`` and ``resnet18``.

dct_tpu's flax modules take their input channel count from the data they
are initialised on; here ``in_channels`` is a constructor argument, which
``Segmentator`` sets from the data's channel count where its caller gives
one (the CLIs do), whatever the config declares."""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from .classifiers import ResNet18, VGG11
from .deeplab import DeepLabV2, DeepLabV3, DeepLabV3Plus
from .enet import Enet
from .fcn import FCN8, FCN16, FCN32
from .joseent import CorstemNet, JEnet
from .pspnet import PSPNet
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
    "pspnet": PSPNet,
    "deeplabv2": DeepLabV2,
    "deeplabv3": DeepLabV3,
    "deeplabv3plus": DeepLabV3Plus,
    "jenet": JEnet,
    "cnet": CorstemNet,
    "vgg11": VGG11,
    "resnet18": ResNet18,
}

# Per-arch BatchNorm momentum, flax convention: new = m·old + (1 − m)·batch,
# dct_tpu's table as it is. The fused two-group co-training forward runs
# only for an arch listed here; each BatchNorm folds its statistics with
# its own momentum, so the value is a gate, not a rate. ``pspnet``'s 0.9
# ("no BN" in dct_tpu) is not its BatchNorms' 0.001: PSPNet's dropout makes
# every co-training step raise before a fused forward, so it never acts.
BN_MOMENTUM: Dict[str, float] = {
    "enet": 0.9, "unet": 0.9, "unet_bn": 0.9,
    "segnet": 0.9, "jenet": 0.9, "cnet": 0.9,
    "deeplabenet": 0.9,
    "fcn8": 0.9, "fcn16": 0.9, "fcn32": 0.9,
    "pspnet": 0.9,
    "deeplabv2": 0.001, "deeplabv3": 0.001, "deeplabv3plus": 0.001,
    "vgg11": 0.99, "resnet18": 0.99}


def get_arch(arch: str, kwargs: Dict[str, Any]) -> nn.Module:
    """Build a module from a config dict."""
    kwargs = {k: v for k, v in kwargs.items() if k != "arch"}
    ctor = ARCH_CALLABLES.get(arch)
    if ctor is None:       # dct_tpu asserts
        raise AssertionError(f"Architecture {arch} is not found! Available: "
                             f"{sorted(ARCH_CALLABLES)}")
    return ctor(**kwargs)


from .segmentator import Segmentator  # noqa: E402,F401

# dct_tpu's alias of Segmentator (the reference exports both names)
Model = Segmentator
