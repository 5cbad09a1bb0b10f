"""The classifiers ``vgg11`` and ``resnet18`` (``dct_tpu/models/classifiers.py``).

NHWC images in, (B, num_classes) logits out: the segmentation losses and
the eval refuse that shape in both packages, so these nets run forward,
eval and checkpoints only. Their BatchNorm is flax's default (momentum
0.99, eps 1e-5, scale ones), their ``Dense`` layers lecun-normal with zero
biases, their convolutions dct_tpu's xavier-normal. Names are flax's
automatic ones (``Conv_0`` …, ``Dense_0`` …, ``_BasicBlock_0/BatchNorm_1``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, Dense, Dropout

CL = torch.channels_last
VGG11_CFG = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=1e-5, momentum=0.99, scale_init="ones")


class VGG11(nn.Module):
    def __init__(self, num_classes: int = 2, in_channels: int = 1) -> None:
        super().__init__()
        cin, i = in_channels, 0
        for v in VGG11_CFG:
            if v != "M":
                self.add_module(f"Conv_{i}", Conv2d(cin, v, 3, padding=1))
                cin, i = v, i + 1
        self.Dense_0 = Dense(512, 4096)
        self.Dropout_0 = Dropout(0.5)
        self.Dense_1 = Dense(4096, 4096)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_2 = Dense(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        i = 0
        for v in VGG11_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        x = x.mean(dim=(2, 3))
        x = self.Dropout_0(F.relu(self.Dense_0(x)))
        x = self.Dropout_1(F.relu(self.Dense_1(x)))
        return self.Dense_2(x)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = _bn(features)
        self.Conv_1 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.BatchNorm_1 = _bn(features)
        if stride != 1 or cin != features:
            self.Conv_2 = Conv2d(cin, features, 1, stride, bias=False)
            self.BatchNorm_2 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        if hasattr(self, "Conv_2"):
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(h + x)


class ResNet18(nn.Module):
    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2)) -> None:
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = _bn(64)
        cin, k = 64, 0
        for i, (n, feats) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(n):
                stride = 2 if (i > 0 and b == 0) else 1
                self.add_module(f"_BasicBlock_{k}", _BasicBlock(cin, feats, stride))
                cin, k = feats, k + 1
        self.n_blocks = k
        self.Dense_0 = Dense(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)              # pads with −inf, as flax
        for k in range(self.n_blocks):
            x = getattr(self, f"_BasicBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
