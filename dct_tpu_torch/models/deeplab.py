"""DeepLab V2 / V3 / V3+ on a dilated ResNet-101 trunk, and the MSC
multi-scale wrapper (``dct_tpu/models/deeplab.py``).

Names follow flax's: ``trunk/layer1_conv1``, ``trunk/layer2/block1/reduce``
(``conv3x3``, ``increase``, ``proj``), each a ``ConvBNReLU`` of ``Conv_0`` and
``BatchNorm_0``; ``aspp/c0`` …, ``aspp/imagepool``, ``fc1``, ``fc2``,
``reduce``, ``fc2_conv1`` … ``fc2_conv3``; MSC's wrapped net is ``scale``.
So ``utils/convert.py`` maps dct_tpu's parameter trees onto these modules
and ``utils/torch_convert.py`` maps the reference's DeepLabV2 state_dicts.

BatchNorm here is flax's ``nn.BatchNorm(momentum=0.001, epsilon=1e-5)``
with its scale initialised to ones, not ``layers.batch_norm``'s N(1, 0.02).
In train mode every BatchNorm runs ``native_batch_norm``, which also takes
ASPP-v3's image-pool branch, one value a channel an image (``F.batch_norm``
refuses a batch of one there). DeepLabV2 returns its logits at 1/8 of the
input and does not resize them (dct_tpu's losses and eval then raise, as
here). NHWC in and out, NCHW ``channels_last`` inside; the input's channel
count is the data's (``in_channels``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .layers import BatchNorm, Conv2d

CL = torch.channels_last
BN_EPS = 1e-5
BN_MOMENTUM = 0.001


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW in ``channels_last`` memory format."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=CL)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, relu: bool = True,
                 momentum: float = BN_MOMENTUM) -> None:
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv2d(cin, features, kernel, stride, padding, dilation, bias=False)
        self.BatchNorm_0 = BatchNorm(features, eps=BN_EPS, momentum=momentum,
                                     scale_init="ones")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        self.reduce = ConvBNReLU(cin, mid, 1, stride)
        self.conv3x3 = ConvBNReLU(mid, mid, 3, 1, dilation, dilation)
        self.increase = ConvBNReLU(mid, out, 1, relu=False)
        if downsample:
            self.proj = ConvBNReLU(cin, out, 1, stride, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.increase(self.conv3x3(self.reduce(x)))
        if hasattr(self, "proj"):
            x = self.proj(x)
        return F.relu(h + x)


class ResBlock(nn.Module):
    """``n_layers`` bottlenecks, the first one projecting; multi-grid ``mg``
    scales each one's dilation."""

    def __init__(self, n_layers: int, cin: int, mid: int, out: int, stride: int,
                 dilation: int, mg: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        mg = list(mg) if mg is not None else [1] * n_layers
        if len(mg) != n_layers:
            raise AssertionError(f"multi-grid {mg} for {n_layers} layers")
        self.block1 = Bottleneck(cin, mid, out, stride, dilation * mg[0], downsample=True)
        for i, g in zip(range(2, n_layers + 1), mg[1:]):
            self.add_module(f"block{i}", Bottleneck(out, mid, out, 1, dilation * g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, pad 1, ceil_mode=True), written as dct_tpu writes it:
    −inf padding, one more row (column) at the end where the side is even."""
    h, w = x.shape[2:]
    eh = 1 if (h + 2 - 3) % 2 else 0
    ew = 1 if (w + 2 - 3) % 2 else 0
    x = F.pad(x, (1, 1 + ew, 1, 1 + eh), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class ResNetTrunk(nn.Module):
    def __init__(self, in_channels: int, n_blocks: Sequence[int], strides: Sequence[int],
                 dilations: Sequence[int], grids: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        self.layer1_conv1 = ConvBNReLU(in_channels, 64, 7, 2, 3)
        self.layer2 = ResBlock(n_blocks[0], 64, 64, 256, strides[0], dilations[0])
        self.layer3 = ResBlock(n_blocks[1], 256, 128, 512, strides[1], dilations[1])
        self.layer4 = ResBlock(n_blocks[2], 512, 256, 1024, strides[2], dilations[2])
        self.layer5 = ResBlock(n_blocks[3], 1024, 512, 2048, strides[3], dilations[3],
                               mg=grids)

    def forward(self, x: torch.Tensor, return_low: bool = False):
        h = self.layer2(stem_pool(self.layer1_conv1(x)))
        low = h
        h = self.layer5(self.layer4(self.layer3(h)))
        return (h, low) if return_low else h


class ASPPv2(nn.Module):
    """Sum of parallel dilated class-score convs (biases; kernels N(0, 0.01))."""

    def __init__(self, cin: int, num_classes: int, pyramids: Sequence[int]) -> None:
        super().__init__()
        for i, d in enumerate(pyramids):
            self.add_module(f"c{i}", Conv2d(cin, num_classes, 3, padding=d, dilation=d,
                                            init=("normal", 0.01)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0
        for conv in self.children():
            out = out + conv(x)
        return out


class ASPPv3(nn.Module):
    """Image pool, a 1×1 and dilated 3×3 branches, concatenated."""

    def __init__(self, cin: int, out_channels: int, pyramids: Sequence[int]) -> None:
        super().__init__()
        self.imagepool = ConvBNReLU(cin, out_channels, 1)
        self.c0 = ConvBNReLU(cin, out_channels, 1)
        for i, d in enumerate(pyramids):
            self.add_module(f"c{i + 1}", ConvBNReLU(cin, out_channels, 3, 1, d, d))
        self.n_dilated = len(pyramids)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = self.imagepool(x.mean(dim=(2, 3), keepdim=True))
        branches = [pool.expand(-1, -1, *x.shape[2:]), self.c0(x)]
        branches += [getattr(self, f"c{i + 1}")(x) for i in range(self.n_dilated)]
        return torch.cat(branches, dim=1).contiguous(memory_format=CL)


class DeepLabV2(nn.Module):
    def __init__(self, num_classes: int, n_blocks: Sequence[int] = (3, 4, 23, 3),
                 pyramids: Sequence[int] = (6, 12, 18, 24), in_channels: int = 3) -> None:
        super().__init__()
        self.trunk = ResNetTrunk(in_channels, n_blocks, (1, 2, 1, 1), (1, 1, 2, 4))
        self.aspp = ASPPv2(2048, num_classes, pyramids)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.aspp(self.trunk(to_nchw(x))))


def os_config(output_stride: int):
    """(strides, dilations) of the trunk's four stages at an output stride."""
    if output_stride == 8:
        return (1, 2, 1, 1), (1, 1, 2, 2)
    if output_stride == 16:
        return (1, 2, 2, 1), (1, 1, 1, 2)
    raise NotImplementedError(output_stride)


class DeepLabV3(nn.Module):
    def __init__(self, num_classes: int, n_blocks: Sequence[int] = (3, 4, 23, 3),
                 pyramids: Sequence[int] = (6, 12, 18), grids: Sequence[int] = (1, 2, 4),
                 output_stride: int = 8, in_channels: int = 3) -> None:
        super().__init__()
        strides, dils = os_config(output_stride)
        self.trunk = ResNetTrunk(in_channels, n_blocks, strides, dils, grids)
        self.aspp = ASPPv3(2048, 256, pyramids)
        self.fc1 = ConvBNReLU(256 * (len(pyramids) + 2), 256, 1)
        self.fc2 = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc2(self.fc1(self.aspp(self.trunk(to_nchw(x)))))
        return to_nhwc(resize_bilinear(h, x.shape[1:3]))


class DeepLabV3Plus(nn.Module):
    def __init__(self, num_classes: int, n_blocks: Sequence[int] = (3, 4, 23, 3),
                 pyramids: Sequence[int] = (6, 12, 18), grids: Sequence[int] = (1, 2, 4),
                 output_stride: int = 8, in_channels: int = 3) -> None:
        super().__init__()
        strides, dils = os_config(output_stride)
        self.trunk = ResNetTrunk(in_channels, n_blocks, strides, dils, grids)
        self.reduce = ConvBNReLU(256, 48, 1)
        self.aspp = ASPPv3(2048, 256, pyramids)
        self.fc1 = ConvBNReLU(256 * (len(pyramids) + 2), 256, 1)
        self.fc2_conv1 = ConvBNReLU(256 + 48, 256, 3, 1, 1)
        self.fc2_conv2 = ConvBNReLU(256, 256, 3, 1, 1)
        self.fc2_conv3 = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, low = self.trunk(to_nchw(x), return_low=True)
        low = self.reduce(low)
        h = resize_bilinear(self.fc1(self.aspp(h)), low.shape[2:])
        h = torch.cat([h, low], dim=1).contiguous(memory_format=CL)
        h = self.fc2_conv3(self.fc2_conv2(self.fc2_conv1(h)))
        return to_nhwc(resize_bilinear(h, x.shape[1:3]))


def resize_nhwc(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(x, (B, *hw, C), "bilinear")`` of an NHWC tensor."""
    return to_nhwc(resize_bilinear(to_nchw(x), hw))


class MSC(nn.Module):
    """The net at scales {1, *pyramids}: eval mode returns the pixelwise max
    of the logits resized to the full-scale logits' size; train mode the
    list [full, *pyramid logits (unresized), max]. The input is shrunk
    with ``jax.image.resize``'s antialiased bilinear."""

    def __init__(self, scale: nn.Module, pyramids: Sequence[float] = (0.5, 0.75)) -> None:
        super().__init__()
        self.scale = scale
        self.pyramids = tuple(pyramids)

    def forward(self, x: torch.Tensor):
        logits = self.scale(x)
        out_hw = logits.shape[1:3]
        pyramid = [self.scale(resize_nhwc(x, (int(x.shape[1] * p), int(x.shape[2] * p))))
                   for p in self.pyramids]
        logits_max = torch.stack([logits] + [resize_nhwc(lg, out_hw) for lg in pyramid]
                                 ).amax(dim=0)
        if self.training:
            return [logits] + pyramid + [logits_max]
        return logits_max


def DeepLabV2_ResNet101_MSC(num_classes: int, **kw) -> MSC:
    return MSC(scale=DeepLabV2(num_classes=num_classes, pyramids=(6, 12, 18, 24), **kw))


def DeepLabV3_ResNet101_MSC(num_classes: int, output_stride: int = 16, **kw) -> MSC:
    pyramids = (6, 12, 18) if output_stride == 16 else (12, 24, 36)
    return MSC(scale=DeepLabV3(num_classes=num_classes, pyramids=pyramids,
                               output_stride=output_stride, **kw))


def DeepLabV3Plus_ResNet101_MSC(num_classes: int, output_stride: int = 16, **kw) -> MSC:
    pyramids = (6, 12, 18) if output_stride == 16 else (12, 24, 36)
    return MSC(scale=DeepLabV3Plus(num_classes=num_classes, pyramids=pyramids,
                                   output_stride=output_stride, **kw))
