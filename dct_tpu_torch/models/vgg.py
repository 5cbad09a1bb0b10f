"""The VGG16 feature backbone of SegNet and FCN (``dct_tpu/models/backbones.py``),
randomly initialised as in dct_tpu (no pretrained weights).

Five stages of 3×3 convolutions (padding 1) and ReLU, 64, 128, 256, 512
and 512 channels; stages 2–5 start with a 2×2/2 max-pool of the previous
stage's output. Names follow flax's: ``vgg/stage1/conv0`` … ``stage5/conv2``.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

# (convolutions, channels) of each stage
VGG16_STAGES = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


class VGGStage(nn.Module):
    def __init__(self, cin: int, n_convs: int, features: int, pool_first: bool) -> None:
        super().__init__()
        self.pool_first = pool_first
        for i in range(n_convs):
            self.add_module(f"conv{i}", Conv2d(cin if i == 0 else features, features, 3,
                                               padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_first:
            x = F.max_pool2d(x, 2, 2)
        for conv in self.children():
            x = F.relu(conv(x))
        return x


class VGG16Features(nn.Module):
    """NCHW in; the five stage outputs, each before the next pool."""

    def __init__(self, in_channels: int) -> None:
        super().__init__()
        cin = in_channels
        for s, (n, c) in enumerate(VGG16_STAGES):
            self.add_module(f"stage{s + 1}", VGGStage(cin, n, c, pool_first=s > 0))
            cin = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for stage in self.children():
            x = stage(x)
            outs.append(x)
        return outs
