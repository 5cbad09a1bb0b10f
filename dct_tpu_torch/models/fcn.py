"""FCN-8s/16s/32s on VGG16 (``dct_tpu/models/fcn.py``).

A valid 7×7 conv of 4096 channels on the pooled 1/32 map, a 1×1 conv of
4096, each with ReLU and dropout (``fconn``, flax's ``_FConn``), a 1×1
class score, then score maps of the 1/16 (FCN16, FCN8) and 1/8 (FCN8)
features added after half-pixel bilinear resizes, and a last resize to the
input. Inputs must be at least 224² (the valid 7×7 conv). Names follow
flax's (``fconn/Conv_0``, ``fconn/Conv_1``, ``score_fconn``,
``score_feat4``, ``score_feat3``). NHWC in and out; the input's channel
count is the data's (``in_channels``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .layers import Conv2d, Dropout
from .vgg import VGG16Features

CL = torch.channels_last


class _FConn(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.Conv_0 = Conv2d(512, 4096, 7)
        self.Dropout_0 = Dropout(0.5)
        self.Conv_1 = Conv2d(4096, 4096, 1)
        self.Dropout_1 = Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dropout_0(F.relu(self.Conv_0(x)))
        return self.Dropout_1(F.relu(self.Conv_1(x)))


class FCN(nn.Module):
    def __init__(self, num_classes: int, skips: int = 2, in_channels: int = 3) -> None:
        super().__init__()
        self.skips = skips
        self.vgg = VGG16Features(in_channels)
        self.fconn = _FConn()
        self.score_fconn = Conv2d(4096, num_classes, 1)
        if skips >= 1:
            self.score_feat4 = Conv2d(512, num_classes, 1)
        if skips >= 2:
            self.score_feat3 = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        _, _, feat3, feat4, feat5 = self.vgg(x)
        score = self.score_fconn(self.fconn(F.max_pool2d(feat5, 2, 2)))
        if self.skips >= 1:
            s4 = self.score_feat4(feat4)
            score = resize_bilinear(score, s4.shape[2:]) + s4
        if self.skips >= 2:
            s3 = self.score_feat3(feat3)
            score = resize_bilinear(score, s3.shape[2:]) + s3
        return resize_bilinear(score, hw).permute(0, 2, 3, 1)


def FCN8(num_classes: int, **kw) -> FCN:
    return FCN(num_classes, skips=2, **kw)


def FCN16(num_classes: int, **kw) -> FCN:
    return FCN(num_classes, skips=1, **kw)


def FCN32(num_classes: int, **kw) -> FCN:
    return FCN(num_classes, skips=0, **kw)
