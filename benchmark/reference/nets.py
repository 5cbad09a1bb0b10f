"""Plain float32 PyTorch nets that the benchmark holds the program's
training step against: ENet (arXiv:1606.02147) and DeepLabV3+
(arXiv:1802.02611) on the dilated ResNet-101 trunk, with the semantics of
the configurations the benchmark runs.

Frozen copies, written with stock operations only: NCHW activations in the
default memory format, plain ``nn.Conv2d``/``nn.ConvTranspose2d``, batch
norm as ``F.batch_norm`` over the batch with its running statistics folded
from their formulas, the pool-with-mask and its unpool as the 2x2 window
arithmetic. The module and parameter names are the program's,
so one state dict loads into both. NHWC in, NHWC logits out.

Semantics that the configurations fix and that these copies keep:

* BatchNorm follows flax: the biased batch variance folds into the running
  one, ``running = m·running + (1 − m)·batch`` (ENet m 0.9, eps 1e-3;
  DeepLab m 0.001, eps 1e-5); ``update_stats`` False leaves the running
  statistics alone. A batch with one value a channel outputs the bias.
  (The program's fused two-group forward normalises its labeled and
  unlabeled halves apart; the reference runs them as two forwards.)
* ENet's 2x2 pools take ``maximum(maximum(a, b), maximum(c, d))`` over the
  window corners (a tie's gradient splits as that tree's derivative does),
  the mask marks the first corner in row-major order that attains the max,
  and the unpool multiplies the broadcast values by that mask. The initial
  block's pool is ``amax`` over the window.
* DeepLabV3+ resizes bilinearly with half-pixel centres, antialiased where
  a side shrinks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.9) -> None:
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.numel() == x.shape[1]:
            y = (x - x) * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                mean = x.mean(dim=(0, 2, 3))
                var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        return y


def keep_stats(net: nn.Module, update_stats: bool) -> None:
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.update_stats = update_stats


# ----------------------------------------------------------------- ENet

def _corners(x: torch.Tensor):
    """NCHW → the four 2x2-window corners, each (N,C,H/2,W/2)."""
    return x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]


def pool_with_mask(x: torch.Tensor):
    a, b, c, d = _corners(x)
    pooled = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    with torch.no_grad():
        m00 = a == pooled
        m01 = (b == pooled) & ~m00
        m10 = (c == pooled) & ~m00 & ~m01
        m11 = ~m00 & ~m01 & ~m10
        mask = torch.zeros_like(x)
        mask[:, :, 0::2, 0::2] = m00.to(x.dtype)
        mask[:, :, 0::2, 1::2] = m01.to(x.dtype)
        mask[:, :, 1::2, 0::2] = m10.to(x.dtype)
        mask[:, :, 1::2, 1::2] = m11.to(x.dtype)
    return pooled, mask


def unpool_with_mask(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    up = y.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up * mask


class PReLU(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha[None, :, None, None] * x)


class InitialBlock(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, 13, 3, stride=2, padding=1)
        self.BatchNorm_0 = BatchNorm(13)
        self.PReLU_0 = PReLU(13)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        pool = x.reshape(n, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
        return torch.cat([self.PReLU_0(self.BatchNorm_0(self.Conv_0(x))), pool], dim=1)


class BottleNeck(nn.Module):
    def __init__(self, cin: int, cout: int, variant: str = "regular",
                 dilation: int = 1, use_relu: bool = False) -> None:
        super().__init__()
        mid = cout // 4
        self.variant, self.cin, self.cout = variant, cin, cout
        stride = 2 if variant == "down" else 1
        self.proj_in = nn.Conv2d(cin, mid, stride, stride=stride, bias=False)
        self.bn_in = BatchNorm(mid)
        if variant == "up":
            self.mid_deconv = nn.ConvTranspose2d(mid, mid, 3, stride=2, padding=1,
                                                 output_padding=1)
        elif variant == "asym":
            self.mid_conv_a = nn.Conv2d(mid, mid, (5, 1), padding=(2, 0), bias=False)
            self.mid_conv_b = nn.Conv2d(mid, mid, (1, 5), padding=(0, 2))
        else:
            d = dilation if variant == "dilated" else 1
            self.mid_conv = nn.Conv2d(mid, mid, 3, padding=d, dilation=d)
        self.bn_mid = BatchNorm(mid)
        self.proj_out = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn_out = BatchNorm(cout)
        if use_relu:
            self.act_in = self.act_mid = self.act_out = nn.ReLU()
        else:
            self.act_in, self.act_mid, self.act_out = PReLU(mid), PReLU(mid), PReLU(cout)
        if variant == "up":
            self.unpool_proj = nn.Conv2d(cin, cout, 1, bias=False)
            self.bn_unpool = BatchNorm(cout)

    def forward(self, x: torch.Tensor, pool_mask: Optional[torch.Tensor] = None):
        h = self.act_in(self.bn_in(self.proj_in(x)))
        if self.variant == "up":
            h = self.mid_deconv(h)
        elif self.variant == "asym":
            h = self.mid_conv_b(self.mid_conv_a(h))
        else:
            h = self.mid_conv(h)
        h = self.act_mid(self.bn_mid(h))
        h = self.act_out(self.bn_out(self.proj_out(h)))
        mask = None
        if self.variant == "down":
            main, mask = pool_with_mask(x)
            if self.cout != self.cin:
                main = F.pad(main, (0, 0, 0, 0, 0, self.cout - self.cin))
        elif self.variant == "up":
            main = unpool_with_mask(self.bn_unpool(self.unpool_proj(x)), pool_mask)
        else:
            main = x
        out = F.relu(main + h)
        return (out, mask) if self.variant == "down" else out


class ENet(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 1) -> None:
        super().__init__()
        c0 = 13 + in_channels
        self.initial = InitialBlock(in_channels)
        self.bottleneck_1_0 = BottleNeck(c0, 64, "down")
        for i in range(1, 5):
            self.add_module(f"bottleneck_1_{i}", BottleNeck(64, 64))
        self.bottleneck_2_0 = BottleNeck(64, 128, "down")
        pattern = (("regular", 1), ("dilated", 2), ("asym", 1), ("dilated", 4),
                   ("regular", 1), ("dilated", 8), ("asym", 1), ("dilated", 16))
        for i, (variant, d) in enumerate(pattern * 2, start=1):
            self.add_module(f"bottleneck_2_{i}", BottleNeck(128, 128, variant, d))
        self.bottleneck_4_0 = BottleNeck(128, 64, "up", use_relu=True)
        self.bottleneck_4_1 = BottleNeck(64, 64, use_relu=True)
        self.bottleneck_4_2 = BottleNeck(64, 64, use_relu=True)
        self.bottleneck_5_0 = BottleNeck(64, c0, "up", use_relu=True)
        self.bottleneck_5_1 = BottleNeck(c0, c0, use_relu=True)
        self.fullconv = nn.ConvTranspose2d(c0, num_classes, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.initial(x.permute(0, 3, 1, 2).contiguous())
        h, mask1 = self.bottleneck_1_0(h)
        for i in range(1, 5):
            h = getattr(self, f"bottleneck_1_{i}")(h)
        h, mask2 = self.bottleneck_2_0(h)
        for i in range(1, 17):
            h = getattr(self, f"bottleneck_2_{i}")(h)
        h = self.bottleneck_4_2(self.bottleneck_4_1(self.bottleneck_4_0(h, mask2)))
        h = self.bottleneck_5_1(self.bottleneck_5_0(h, mask1))
        return self.fullconv(h).permute(0, 2, 3, 1)


# ----------------------------------------------------- DeepLabV3+ / ResNet-101

DL_EPS, DL_MOMENTUM = 1e-5, 0.001


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, relu: bool = True) -> None:
        super().__init__()
        self.relu = relu
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride, padding, dilation, bias=False)
        self.BatchNorm_0 = BatchNorm(cout, DL_EPS, DL_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int, dilation: int,
                 downsample: bool) -> None:
        super().__init__()
        self.reduce = ConvBNReLU(cin, mid, 1, stride)
        self.conv3x3 = ConvBNReLU(mid, mid, 3, 1, dilation, dilation)
        self.increase = ConvBNReLU(mid, cout, 1, relu=False)
        self.downsample = downsample
        if downsample:
            self.proj = ConvBNReLU(cin, cout, 1, stride, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.increase(self.conv3x3(self.reduce(x)))
        return F.relu(h + (self.proj(x) if self.downsample else x))


class ResBlock(nn.Module):
    def __init__(self, n: int, cin: int, mid: int, cout: int, stride: int,
                 dilation: int, grids: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        grids = list(grids) if grids is not None else [1] * n
        self.block1 = Bottleneck(cin, mid, cout, stride, dilation * grids[0], True)
        for i in range(2, n + 1):
            self.add_module(f"block{i}", Bottleneck(cout, mid, cout, 1,
                                                    dilation * grids[i - 1], False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class ResNetTrunk(nn.Module):
    def __init__(self, cin: int, n_blocks, strides, dilations, grids) -> None:
        super().__init__()
        self.layer1_conv1 = ConvBNReLU(cin, 64, 7, 2, 3)
        self.layer2 = ResBlock(n_blocks[0], 64, 64, 256, strides[0], dilations[0])
        self.layer3 = ResBlock(n_blocks[1], 256, 128, 512, strides[1], dilations[1])
        self.layer4 = ResBlock(n_blocks[2], 512, 256, 1024, strides[2], dilations[2])
        self.layer5 = ResBlock(n_blocks[3], 1024, 512, 2048, strides[3], dilations[3], grids)

    def forward(self, x: torch.Tensor):
        h = self.layer1_conv1(x)
        # MaxPool2d(3, 2, padding 1, ceil_mode) as −inf padding and one more
        # row (column) at the end where the side is even
        eh, ew = (h.shape[2] - 1) % 2, (h.shape[3] - 1) % 2
        h = F.max_pool2d(F.pad(h, (1, 1 + ew, 1, 1 + eh), value=float("-inf")), 3, 2)
        low = self.layer2(h)
        return self.layer5(self.layer4(self.layer3(low))), low


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[2:]) == hw:
        return x
    shrinks = hw[0] < x.shape[2] or hw[1] < x.shape[3]
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                         antialias=shrinks)


class ASPP(nn.Module):
    def __init__(self, cin: int, cout: int, pyramids: Sequence[int]) -> None:
        super().__init__()
        self.imagepool = ConvBNReLU(cin, cout, 1)
        self.c0 = ConvBNReLU(cin, cout, 1)
        for i, d in enumerate(pyramids):
            self.add_module(f"c{i + 1}", ConvBNReLU(cin, cout, 3, 1, d, d))
        self.n = len(pyramids)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = self.imagepool(x.mean(dim=(2, 3), keepdim=True))
        out = [pool.expand(-1, -1, *x.shape[2:]), self.c0(x)]
        out += [getattr(self, f"c{i + 1}")(x) for i in range(self.n)]
        return torch.cat(out, dim=1)


class DeepLabV3Plus(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 3, output_stride: int = 8,
                 n_blocks: Sequence[int] = (3, 4, 23, 3), pyramids: Sequence[int] = (6, 12, 18),
                 grids: Sequence[int] = (1, 2, 4)) -> None:
        super().__init__()
        if output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 2)
        elif output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        else:
            raise ValueError(f"output stride {output_stride}")
        self.trunk = ResNetTrunk(in_channels, n_blocks, strides, dilations, grids)
        self.reduce = ConvBNReLU(256, 48, 1)
        self.aspp = ASPP(2048, 256, pyramids)
        self.fc1 = ConvBNReLU(256 * (len(pyramids) + 2), 256, 1)
        self.fc2_conv1 = ConvBNReLU(256 + 48, 256, 3, 1, 1)
        self.fc2_conv2 = ConvBNReLU(256, 256, 3, 1, 1)
        self.fc2_conv3 = nn.Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, low = self.trunk(x.permute(0, 3, 1, 2).contiguous())
        low = self.reduce(low)
        h = torch.cat([resize(self.fc1(self.aspp(h)), low.shape[2:]), low], dim=1)
        h = self.fc2_conv3(self.fc2_conv2(self.fc2_conv1(h)))
        return resize(h, x.shape[1:3]).permute(0, 2, 3, 1)


def build(arch: dict, in_channels: int) -> nn.Module:
    """The reference net of a configuration's ``arch`` block."""
    name = arch["name"]
    if name == "enet":
        return ENet(arch["num_classes"], in_channels)
    if name == "deeplabv3plus":
        return DeepLabV3Plus(arch["num_classes"], in_channels,
                             int(arch.get("output_stride", 8)),
                             tuple(arch.get("n_blocks", (3, 4, 23, 3))),
                             grids=tuple(arch.get("grids", (1, 2, 4))))
    raise KeyError(f"no reference net for arch {name!r}")
