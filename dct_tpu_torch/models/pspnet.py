"""PSPNet on the dilated ResNet trunk (``dct_tpu/models/pspnet.py``).

The output-stride-8 trunk of DeepLabV2, a pyramid pooling module (bins 1,
2, 3 and 6: an adaptive average pool, a 1×1 ``ConvBNReLU`` of 512 channels
and a bilinear resize back to the trunk's size, concatenated with the
trunk's features), a 3×3 fuse ``ConvBNReLU``, dropout 0.1 and a 1×1
classifier with flax's default (lecun-normal) init, resized to the input.
Every BatchNorm is DeepLab's (momentum 0.001, eps 1e-5, scale ones). A bin
larger than the trunk's map makes its resize a shrink, antialiased as
``jax.image.resize`` antialiases it. Names follow flax's (``trunk``,
``psp/bin1`` …, ``fuse``, ``final``). NHWC in and out.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .deeplab import CL, ConvBNReLU, ResNetTrunk, to_nchw, to_nhwc
from .layers import Conv2d, Dropout


class PSPModule(nn.Module):
    def __init__(self, cin: int, out_channels: int = 512,
                 bins: Sequence[int] = (1, 2, 3, 6)) -> None:
        super().__init__()
        self.bins = tuple(bins)
        for b in self.bins:
            self.add_module(f"bin{b}", ConvBNReLU(cin, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [x]
        for b in self.bins:
            # torch's cells are dct_tpu's: [floor(i·H/b), ceil((i+1)·H/b))
            h = getattr(self, f"bin{b}")(F.adaptive_avg_pool2d(x, b))
            branches.append(resize_bilinear(h, x.shape[2:]))
        return torch.cat(branches, dim=1).contiguous(memory_format=CL)


class PSPNet(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 3,
                 n_blocks: Sequence[int] = (3, 4, 23, 3), bins: Sequence[int] = (1, 2, 3, 6),
                 psp_channels: int = 512) -> None:
        super().__init__()
        self.trunk = ResNetTrunk(in_channels, n_blocks, (1, 2, 1, 1), (1, 1, 2, 4))
        self.psp = PSPModule(2048, psp_channels, bins)
        self.fuse = ConvBNReLU(2048 + len(bins) * psp_channels, psp_channels, 3, 1, 1)
        self.Dropout_0 = Dropout(0.1)
        self.final = Conv2d(psp_channels, num_classes, 1, init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fuse(self.psp(self.trunk(to_nchw(x))))
        logits = self.final(self.Dropout_0(h))
        return to_nhwc(resize_bilinear(logits, x.shape[1:3]))
