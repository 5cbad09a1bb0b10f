"""The valid-convolution UNet and UNet_bn (``dct_tpu/models/unet.py``).

Encoder stages of two valid 3×3 convolutions (each followed by BatchNorm in
``unet_bn``, except the second of the ``dec*``/``enc1`` stages: dct_tpu's
``bn_second=not bn``) and ReLU, each followed by a ceil-mode 2×2 max-pool;
dropout after ``dec4`` and after ``center``; decoder stages of a double
conv and a stride-2 transposed conv; skip connections are the *post-pool*
stage outputs, resized (align corners) to the running size; a final 1×1
conv resized back to the input. Inputs must be at least 176² (smaller
ones shrink a map to nothing, where dct_tpu fails too).

Names follow flax's (``dec1/Conv_0``, ``enc4/_DoubleConv_0/BatchNorm_0``,
``enc4/ConvTranspose_0``, ``center_up``, ``final``), so
``utils/convert.py`` maps dct_tpu's parameter trees onto it. NHWC in and
out, NCHW ``channels_last`` inside. ``remat`` recomputes each double-conv
and decoder stage in the backward pass (``layers.remat``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear_align_corners as _resize
from .layers import BatchNorm, Conv2d, ConvTranspose2d, Dropout, remat

CL = torch.channels_last


class _DoubleConv(nn.Module):
    def __init__(self, cin: int, features: int, use_bn: bool, bn_second: bool = True) -> None:
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 3)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 3)
        if use_bn and bn_second:
            self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if hasattr(self, "BatchNorm_0"):
            x = self.BatchNorm_0(x)
        x = self.Conv_1(F.relu(x))
        if hasattr(self, "BatchNorm_1"):
            x = self.BatchNorm_1(x)
        return F.relu(x)


class _Enc(nn.Module):
    """A decoder stage: double conv, then a 2× transposed conv and ReLU."""

    def __init__(self, cin: int, features: int, out_channels: int, use_bn: bool) -> None:
        super().__init__()
        self._DoubleConv_0 = _DoubleConv(cin, features, use_bn)
        self.ConvTranspose_0 = ConvTranspose2d(features, out_channels, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.ConvTranspose_0(self._DoubleConv_0(x)))


def _ceil_maxpool(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 max-pool, an odd side padded with −inf at the bottom/right."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class UNet(nn.Module):
    def __init__(self, num_classes: int = 2, in_channels: int = 1, use_bn: bool = False,
                 remat: bool = False) -> None:
        super().__init__()
        bn = use_bn
        self.remat = remat
        self.dec1 = _DoubleConv(in_channels, 64, bn, bn_second=not bn)
        self.dec2 = _DoubleConv(64, 128, bn, bn_second=not bn)
        self.dec3 = _DoubleConv(128, 256, bn, bn_second=not bn)
        self.dec4 = _DoubleConv(256, 512, bn, bn_second=not bn)
        self.dec4_dropout = Dropout(0.5)
        self.center = _DoubleConv(512, 1024, bn)
        self.center_dropout = Dropout(0.5)
        self.center_up = ConvTranspose2d(1024, 512, 2, stride=2)
        self.enc4 = _Enc(1024, 512, 256, bn)
        self.enc3 = _Enc(512, 256, 128, bn)
        self.enc2 = _Enc(256, 128, 64, bn)
        self.enc1 = _DoubleConv(128, 64, bn, bn_second=not bn)
        self.final = Conv2d(64, num_classes, 1)

    def _stage(self, stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return remat(stage, x) if self.remat else stage(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=CL)
        d1 = _ceil_maxpool(self._stage(self.dec1, x))
        d2 = _ceil_maxpool(self._stage(self.dec2, d1))
        d3 = _ceil_maxpool(self._stage(self.dec3, d2))
        d4 = _ceil_maxpool(self.dec4_dropout(self._stage(self.dec4, d3)))
        center = self.center_dropout(self._stage(self.center, d4))
        h = F.relu(self.center_up(center))
        for stage, skip in ((self.enc4, d4), (self.enc3, d3), (self.enc2, d2),
                            (self.enc1, d1)):
            h = self._stage(stage, torch.cat([h, _resize(skip, h.shape[2:])], dim=1))
        logits = _resize(self.final(h), hw)
        return logits.permute(0, 2, 3, 1)
