"""SegNet, the bilinear-upsampling variant on VGG16 (``dct_tpu/models/segnet.py``).

Each decoder block upsamples 2× (half-pixel bilinear, as
``jax.image.resize``), halves the channels with a 3×3 conv, adds
``num_layers`` more, then a 3×3 conv to its output width, each conv with
BatchNorm and ReLU; encoder features (each VGG stage's output, pooled)
are concatenated in, as dct_tpu does. Names follow flax's (``enc5/Conv_0``,
``enc5/BatchNorm_0``, ``enc1_conv``, ``enc1_bn``, ``final``). NHWC in and
out; the input's channel count is the data's (``in_channels``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .layers import BatchNorm, Conv2d
from .vgg import VGG16Features

CL = torch.channels_last


def _up2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))


class SegNetEnc(nn.Module):
    def __init__(self, cin: int, out_channels: int, num_layers: int) -> None:
        super().__init__()
        half = cin // 2
        widths = [(cin, half)] + [(half, half)] * num_layers + [(half, out_channels)]
        for i, (a, b) in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv2d(a, b, 3, padding=1))
            self.add_module(f"BatchNorm_{i}", BatchNorm(b))
        self.n = len(widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _up2x(x)
        for i in range(self.n):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return x


class SegNet(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 3) -> None:
        super().__init__()
        self.vgg = VGG16Features(in_channels)
        self.enc5 = SegNetEnc(512, 512, 1)
        self.enc4 = SegNetEnc(1024, 256, 1)
        self.enc3 = SegNetEnc(512, 128, 1)
        self.enc2 = SegNetEnc(256, 64, 0)
        self.enc1_conv = Conv2d(128, 64, 3, padding=1)
        self.enc1_bn = BatchNorm(64)
        self.final = Conv2d(64, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        d1p, d2p, d3p, d4p, d5p = (F.max_pool2d(d, 2, 2) for d in self.vgg(x))
        e5 = self.enc5(d5p)
        e4 = self.enc4(torch.cat([d4p, e5], dim=1))
        e3 = self.enc3(torch.cat([d3p, e4], dim=1))
        e2 = self.enc2(torch.cat([d2p, e3], dim=1))
        e1 = _up2x(torch.cat([d1p, e2], dim=1))
        e1 = F.relu(self.enc1_bn(self.enc1_conv(e1)))
        return resize_bilinear(self.final(e1), hw).permute(0, 2, 3, 1)
