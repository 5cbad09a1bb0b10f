"""ENet (``dct_tpu/models/enet.py``) in PyTorch.

Same blocks and names as dct_tpu (``initial``, ``bottleneck_1_0`` …
``bottleneck_5_1``, ``fullconv``; inside a block ``proj_in``, ``bn_in``,
``act_in``, ``mid_conv``/``mid_deconv``/``mid_conv_a``+``mid_conv_b``,
``bn_mid``, ``act_mid``, ``proj_out``, ``bn_out``, ``act_out``,
``unpool_proj``, ``bn_unpool``), so ``utils/convert.py`` maps a flax
parameter tree onto it leaf by leaf.

The module takes and returns NHWC tensors, dct_tpu's layout. Inside, the
activations are NCHW tensors in ``torch.channels_last`` memory format for
cuDNN, whose NHWC view ``x.permute(0, 2, 3, 1)`` is contiguous: that view is
what the pool-with-mask and unpool kernels (``ops/pool_kernels.py``) take, at
the two downsampling and the two upsampling bottlenecks.

dct_tpu's space-to-depth / depth-to-space convolutions (``_S2DConv``,
``_D2SConvTranspose3``, ``_D2SConvTranspose``) are exact rewrites of plain
strided convolutions over the same parameters; here they are plain
``Conv2d`` and ``ConvTranspose2d``. The initial block's pool takes ``amax``
over each 2x2 window, which splits a tie's gradient evenly as JAX's
``reduce_max`` does in dct_tpu's default ``fast_paths=True``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool_kernels import mask_unpool_2x2_kernel, max_pool_2x2_with_mask_kernel
from .layers import BatchNorm, Conv2d, ConvTranspose2d, PReLU

CL = torch.channels_last


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW channels_last → its contiguous NHWC view."""
    return x.contiguous(memory_format=CL).permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC → its NCHW channels_last view."""
    return x.permute(0, 3, 1, 2)


class InitialBlock(nn.Module):
    def __init__(self, in_channels: int, conv_features: int = 13) -> None:
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, conv_features, 3, stride=2, padding=1)
        self.BatchNorm_0 = BatchNorm(conv_features)
        self.PReLU_0 = PReLU(conv_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        pool = x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
        conv = self.PReLU_0(self.BatchNorm_0(self.Conv_0(x)))
        return torch.cat([conv, pool.contiguous(memory_format=CL)], dim=1)


class BottleNeck(nn.Module):
    """One ENet bottleneck. ``variant`` selects the middle conv; ``down``
    also returns the pool mask and ``up`` consumes one."""

    def __init__(self, in_channels: int, out_channels: int,
                 variant: str = "regular", dilation_rate: int = 1,
                 use_relu: bool = False) -> None:
        super().__init__()
        internal = out_channels // 4
        self.variant = variant
        self.in_channels = in_channels
        self.out_channels = out_channels
        stride = 2 if variant == "down" else 1
        self.proj_in = Conv2d(in_channels, internal, stride, stride=stride,
                              bias=False)
        self.bn_in = BatchNorm(internal)
        if variant == "up":
            # torch ConvTranspose2d(k=3, s=2, padding=1, output_padding=1)
            # ≡ dct_tpu's ConvTranspose padding ((1, 2), (1, 2))
            self.mid_deconv = ConvTranspose2d(internal, internal, 3, stride=2,
                                              padding=1, output_padding=1)
        elif variant == "asym":
            self.mid_conv_a = Conv2d(internal, internal, (5, 1), padding=(2, 0),
                                     bias=False)
            self.mid_conv_b = Conv2d(internal, internal, (1, 5), padding=(0, 2))
        elif variant in ("regular", "down", "dilated"):
            d = dilation_rate if variant == "dilated" else 1
            self.mid_conv = Conv2d(internal, internal, 3, padding=d, dilation=d)
        else:
            raise ValueError(f"unknown bottleneck variant {variant!r}")
        self.bn_mid = BatchNorm(internal)
        self.proj_out = Conv2d(internal, out_channels, 1, bias=False)
        self.bn_out = BatchNorm(out_channels)
        if use_relu:
            self.act_in = self.act_mid = self.act_out = nn.ReLU()
        else:
            self.act_in = PReLU(internal)
            self.act_mid = PReLU(internal)
            self.act_out = PReLU(out_channels)
        if variant == "up":
            self.unpool_proj = Conv2d(in_channels, out_channels, 1, bias=False)
            self.bn_unpool = BatchNorm(out_channels)

    def _mid(self, h: torch.Tensor) -> torch.Tensor:
        if self.variant == "up":
            return self.mid_deconv(h)
        if self.variant == "asym":
            return self.mid_conv_b(self.mid_conv_a(h))
        return self.mid_conv(h)

    def forward(self, x: torch.Tensor, pool_mask: Optional[torch.Tensor] = None):
        h = self.act_in(self.bn_in(self.proj_in(x)))
        h = self.act_mid(self.bn_mid(self._mid(h)))
        h = self.act_out(self.bn_out(self.proj_out(h)))

        mask_out = None
        if self.variant == "down":
            pooled, mask_out = max_pool_2x2_with_mask_kernel(_nhwc(x))
            main = _nchw(pooled)
            if self.out_channels != self.in_channels:
                # zero-pad the new channels
                main = F.pad(main, (0, 0, 0, 0, 0, self.out_channels - self.in_channels))
                main = main.contiguous(memory_format=CL)
        elif self.variant == "up":
            if pool_mask is None:
                raise ValueError("upsampling bottleneck needs a pool mask")
            main = self.bn_unpool(self.unpool_proj(x))
            main = _nchw(mask_unpool_2x2_kernel(_nhwc(main), pool_mask))
        else:
            main = x

        out = F.relu(main + h)
        if self.variant == "down":
            return out, mask_out
        return out


class Enet(nn.Module):
    """Encoder-decoder ENet; NHWC input (B,H,W,in_channels) → NHWC logits
    (B,H,W,num_classes). H and W must be divisible by 8."""

    def __init__(self, num_classes: int, in_channels: int = 1) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        c0 = 13 + in_channels
        self.initial = InitialBlock(in_channels)
        self.bottleneck_1_0 = BottleNeck(c0, 64, "down")
        for i in range(1, 5):
            self.add_module(f"bottleneck_1_{i}", BottleNeck(64, 64, "regular"))
        self.bottleneck_2_0 = BottleNeck(64, 128, "down")
        idx = 1
        for _section in range(2):
            for variant, d in (("regular", 1), ("dilated", 2), ("asym", 1),
                               ("dilated", 4), ("regular", 1), ("dilated", 8),
                               ("asym", 1), ("dilated", 16)):
                self.add_module(f"bottleneck_2_{idx}",
                                BottleNeck(128, 128, variant, d))
                idx += 1
        self.bottleneck_4_0 = BottleNeck(128, 64, "up", use_relu=True)
        self.bottleneck_4_1 = BottleNeck(64, 64, "regular", use_relu=True)
        self.bottleneck_4_2 = BottleNeck(64, 64, "regular", use_relu=True)
        self.bottleneck_5_0 = BottleNeck(64, c0, "up", use_relu=True)
        self.bottleneck_5_1 = BottleNeck(c0, c0, "regular", use_relu=True)
        self.fullconv = ConvTranspose2d(c0, num_classes, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError("Enet needs H,W divisible by 8 (3 downsampling "
                             f"stages), got {tuple(x.shape[1:3])}")
        h = self.initial(_nchw(x).contiguous(memory_format=CL))
        h, mask1 = self.bottleneck_1_0(h)
        for i in range(1, 5):
            h = getattr(self, f"bottleneck_1_{i}")(h)
        h, mask2 = self.bottleneck_2_0(h)
        for i in range(1, 17):
            h = getattr(self, f"bottleneck_2_{i}")(h)
        h = self.bottleneck_4_0(h, mask2)
        h = self.bottleneck_4_2(self.bottleneck_4_1(h))
        h = self.bottleneck_5_0(h, mask1)
        h = self.bottleneck_5_1(h)
        return _nhwc(self.fullconv(h))
