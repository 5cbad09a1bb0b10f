"""The 'joseent' ENet (``jenet``) and CorstemNet (``cnet``) of
``dct_tpu/models/joseent.py``.

JEnet: a 16-kernel initial stage (15 conv channels and a 2×2 max-pool of
the input), residual bottlenecks whose dropout is applied in forward, a
dilated third group that ends by projecting back to 64 channels with a
3×3 residual conv, and a decoder that concatenates encoder features after
each unpool; a 2× nearest upsample and two conv-BN-PReLUs close it. Its
three pools and two unpools are the CUDA kernels of
``ops/pool_kernels.py``, as ENet's: the initial stage's pool takes the
raw input (one channel for the medical sets) and its mask is dropped; the
two downsampling bottlenecks' masks feed the two unpools.

CorstemNet: residual conv blocks (LeakyReLU 0.2 in the encoder, ReLU in
the decoder) over four 2×2 max-pools (no mask) and four stride-2
transposed convs. flax's ``ConvTranspose(3, strides=2, padding="SAME")``
pads the dilated input by (2, 1); here it is ``ConvTranspose2d(3, 2)``
with no padding, whose (2H+1)-side output loses its last row and column
(the kernel flipped by ``utils/convert.py``, as ENet's). ``padding=1,
output_padding=1`` would pad (1, 2) instead: another function.

Both use ``layers.batch_norm``'s BatchNorm (eps 1e-3, momentum 0.9, scale
N(1, 0.02)). Names follow flax's (``bn1_0/conv0/Conv_0``,
``bn2_3/asym_bn``, ``up1_act``, ``down_1/conv2a_bn``, ``deconv_1``, …).
NHWC in and out, NCHW ``channels_last`` inside.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool_kernels import mask_unpool_2x2_kernel, max_pool_2x2_with_mask_kernel
from .enet import CL, _nchw, _nhwc
from .layers import BatchNorm, Conv2d, ConvTranspose2d, Dropout, PReLU


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=1).contiguous(memory_format=CL)


class ConvBNPReLU(nn.Module):
    """A conv (a 3×3 one padded by its dilation), BatchNorm and PReLU."""

    def __init__(self, cin: int, features: int, kernel=3, stride: int = 1,
                 padding=None, use_bias: bool = True, dilation: int = 1) -> None:
        super().__init__()
        if padding is None:
            padding = dilation
        self.Conv_0 = Conv2d(cin, features, kernel, stride, padding, dilation, bias=use_bias)
        self.BatchNorm_0 = BatchNorm(features)
        self.PReLU_0 = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLU_0(self.BatchNorm_0(self.Conv_0(x)))


class _Bottleneck(nn.Module):
    """1×1 projection, middle (3×3, dilated 3×3 or 5×1 + 1×5), 1×1
    expansion, dropout, plus the input (or its 1×1 or 3×3 projection), PReLU."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.1,
                 middle: str = "3x3", dilation: int = 1, residual_conv: str = "auto",
                 projection_factor: int = 4) -> None:
        super().__init__()
        mid = in_dim // projection_factor
        self.middle = middle
        self.block0 = ConvBNPReLU(in_dim, mid, 1, padding=0)
        if middle == "asym":
            self.asym_a = Conv2d(mid, mid, (5, 1), padding=(2, 0))
            self.asym_b = Conv2d(mid, mid, (1, 5), padding=(0, 2))
            self.asym_bn = BatchNorm(mid)
            self.asym_act = PReLU(mid)
        else:
            self.block1 = ConvBNPReLU(mid, mid, 3, dilation=dilation)
        self.block2 = ConvBNPReLU(mid, out_dim, 1, padding=0)
        self.Dropout_0 = Dropout(dropout)
        if residual_conv == "3x3":
            self.conv_out = Conv2d(in_dim, out_dim, 3, padding=1)
        elif in_dim > out_dim:
            self.conv_out = ConvBNPReLU(in_dim, out_dim, 1, padding=0)
        self.act_out = PReLU(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block0(x)
        if self.middle == "asym":
            h = self.asym_act(self.asym_bn(self.asym_b(self.asym_a(h))))
        else:
            h = self.block1(h)
        h = self.Dropout_0(self.block2(h))
        res = self.conv_out(x) if hasattr(self, "conv_out") else x
        return self.act_out(res + h)


class _BottleneckDown(nn.Module):
    """Downsampling bottleneck: the pooled input, zero-padded to
    ``out_dim`` channels, plus a strided conv branch; returns the pool mask."""

    def __init__(self, in_dim: int, out_dim: int, projection_factor: int = 4) -> None:
        super().__init__()
        mid = in_dim // projection_factor
        self.pad = out_dim - in_dim
        self.conv0 = ConvBNPReLU(in_dim, mid, 2, stride=2, padding=0)
        self.conv1 = ConvBNPReLU(mid, mid, 3)
        self.block2 = ConvBNPReLU(mid, out_dim, 1, padding=0)
        self.Dropout_0 = Dropout(0.01)
        self.act_out = PReLU(out_dim)

    def forward(self, x: torch.Tensor):
        pooled, mask = max_pool_2x2_with_mask_kernel(_nhwc(x))
        h = self.Dropout_0(self.block2(self.conv1(self.conv0(x))))
        main = F.pad(_nchw(pooled), (0, 0, 0, 0, 0, self.pad)).contiguous(memory_format=CL)
        return self.act_out(main + h), mask


class _BottleneckUp(nn.Module):
    """Up-path bottleneck over concat(unpooled, skip)."""

    def __init__(self, in_dim: int, out_dim: int, projection_factor: int = 4) -> None:
        super().__init__()
        mid = in_dim // projection_factor
        self.conv0 = ConvBNPReLU(in_dim, mid, 3)
        self.conv1 = ConvBNPReLU(mid, mid, 3)
        self.block2 = ConvBNPReLU(mid, out_dim, 1, padding=0)
        self.Dropout_0 = Dropout(0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dropout_0(self.block2(self.conv1(self.conv0(x))))


# the middle of the 8 bottlenecks of groups 2 and 3, with its dilation
_GROUP_SPECS = [("3x3", 1), ("dilated", 2), ("asym", 1), ("dilated", 4),
                ("3x3", 1), ("dilated", 8), ("asym", 1), ("dilated", 16)]


class JEnet(nn.Module):
    """NHWC (B,H,W,in_channels) → NHWC logits; H and W divisible by 8."""

    def __init__(self, num_classes: int = 2, in_channels: int = 1, nk: int = 16) -> None:
        super().__init__()
        self.conv0 = Conv2d(in_channels, nk - in_channels, 3, stride=2, padding=1)
        self.bn1_0 = _BottleneckDown(nk, nk * 4)
        for i in range(1, 5):
            self.add_module(f"bn1_{i}", _Bottleneck(nk * 4, nk * 4, dropout=0.01))
        self.bn2_0 = _BottleneckDown(nk * 4, nk * 8)
        for grp in (2, 3):
            for i, (middle, d) in enumerate(_GROUP_SPECS, 1):
                last = grp == 3 and i == 8
                self.add_module(f"bn{grp}_{i}", _Bottleneck(
                    nk * 8, nk * 4 if last else nk * 8, middle=middle, dilation=d,
                    dropout=0.01 if middle == "dilated" else 0.1,
                    residual_conv="3x3" if last else "auto"))
        self.up1_0 = _BottleneckUp(nk * 8, nk * 4)
        self.up1_act = PReLU(nk * 4)
        self.up1_1 = _Bottleneck(nk * 4, nk * 4, dropout=0.1)
        self.up1_2 = _Bottleneck(nk * 4, nk, dropout=0.1)
        self.up2_1 = _BottleneckUp(nk * 2, nk)
        self.up2_2 = _Bottleneck(nk, nk, dropout=0.1)
        self.up2_act = PReLU(nk)
        self.deconv3_a = ConvBNPReLU(nk, nk, 3, use_bias=False)
        self.deconv3_b = ConvBNPReLU(nk, nk, 3, use_bias=False)
        self.final = Conv2d(nk, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError("JEnet needs H,W divisible by 8 (3 pooling stages), "
                             f"got {tuple(x.shape[1:3])}")
        x = x.contiguous()
        pool0, _ = max_pool_2x2_with_mask_kernel(x)
        initial = _cat(self.conv0(_nchw(x)), _nchw(pool0))

        h, mask1 = self.bn1_0(initial)
        for i in range(1, 5):
            h = getattr(self, f"bn1_{i}")(h)
        bn1_4 = h
        h, mask2 = self.bn2_0(h)
        for grp in (2, 3):
            for i in range(1, 9):
                h = getattr(self, f"bn{grp}_{i}")(h)

        up0 = _nchw(mask_unpool_2x2_kernel(_nhwc(h), mask2))
        h = self.up1_act(up0 + self.up1_0(_cat(up0, bn1_4)))
        h = self.up1_2(self.up1_1(h))
        up1 = _nchw(mask_unpool_2x2_kernel(_nhwc(h), mask1))
        b = self.up2_2(self.up2_1(_cat(up1, initial)))
        h = self.up2_act(up1 + b)

        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = self.deconv3_b(self.deconv3_a(h.contiguous(memory_format=CL)))
        return _nhwc(self.final(h))


class _ConvResidualConv(nn.Module):
    """conv → (conv, conv, conv + BN) residual → conv, each conv with BN."""

    def __init__(self, cin: int, features: int, negative_slope: float = 0.2) -> None:
        super().__init__()
        self.negative_slope = negative_slope
        for i, name in enumerate(("conv1", "conv2a", "conv2b", "conv2c", "conv3")):
            self.add_module(name, Conv2d(cin if i == 0 else features, features, 3, padding=1))
            self.add_module(name + "_bn", BatchNorm(features))

    def _act(self, v: torch.Tensor) -> torch.Tensor:
        if self.negative_slope:
            return F.leaky_relu(v, self.negative_slope)
        return F.relu(v)

    def _conv_bn(self, v: torch.Tensor, name: str) -> torch.Tensor:
        return getattr(self, name + "_bn")(getattr(self, name)(v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self._act(self._conv_bn(x, "conv1"))
        h = self._act(self._conv_bn(c1, "conv2a"))
        h = self._act(self._conv_bn(h, "conv2b"))
        h = self._conv_bn(h, "conv2c")
        return self._act(self._conv_bn(c1 + h, "conv3"))


class DeconvSame(ConvTranspose2d):
    """flax's ``ConvTranspose(3, strides=2, padding="SAME")``: H → 2H."""

    def __init__(self, cin: int, features: int) -> None:
        super().__init__(cin, features, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[:, :, :-1, :-1]


class CorstemNet(nn.Module):
    """NHWC in and out; H and W divisible by 16."""

    def __init__(self, num_classes: int = 2, in_channels: int = 1, ngf: int = 32) -> None:
        super().__init__()
        g = ngf
        self.down_1 = _ConvResidualConv(in_channels, g)
        self.down_2 = _ConvResidualConv(g, g * 2)
        self.down_3 = _ConvResidualConv(g * 2, g * 4)
        self.down_4 = _ConvResidualConv(g * 4, g * 8)
        self.bridge = _ConvResidualConv(g * 8, g * 16)
        for i, (cin, feats) in enumerate(((g * 16, g * 8), (g * 8, g * 4), (g * 4, g * 2),
                                          (g * 2, g)), 1):
            self.add_module(f"deconv_{i}", DeconvSame(cin, feats))
            self.add_module(f"deconv_{i}_bn", BatchNorm(feats))
            self.add_module(f"up_{i}", _ConvResidualConv(feats, feats, 0.0))
        self.out = Conv2d(g, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = self.down_1(x.permute(0, 3, 1, 2).contiguous(memory_format=CL))
        d2 = self.down_2(F.max_pool2d(d1, 2, 2))
        d3 = self.down_3(F.max_pool2d(d2, 2, 2))
        d4 = self.down_4(F.max_pool2d(d3, 2, 2))
        h = self.bridge(F.max_pool2d(d4, 2, 2))
        for i, skip in enumerate((d4, d3, d2, d1), 1):
            up = F.relu(getattr(self, f"deconv_{i}_bn")(getattr(self, f"deconv_{i}")(h)))
            h = getattr(self, f"up_{i}")((up + skip) / 2)
        return self.out(h).permute(0, 2, 3, 1)
