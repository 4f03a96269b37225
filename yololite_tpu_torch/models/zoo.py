"""The extended block zoo as torch modules (NCHW): port of yololite_tpu/models/zoo.py.

Every block the graph builder can instantiate beyond YOLO11: C1/C2/C3x/
C3Ghost/RepC3/BottleneckCSP, Ghost convs, the HGNet stem and blocks, ResNet
layers, YOLOv9's ELAN1/RepNCSPELAN4/AConv/ADown/SPPELAN/CBLinear/CBFuse,
YOLOv10's CIB/C2fCIB/RepVGGDW/PSA/C2fPSA/SCDown, CBAM's attention pieces,
Focus, Proto, the transposed convs, and the YOLO-World blocks that take a
guide or text input (which DetectionModel never feeds).

As in models/modules.py, submodule names follow the upstream torch blocks,
so a state_dict with upstream names loads with strict=True, and children
are registered in the order in which the JAX modules draw their initial
weights; a block that draws or sets leaves of its own defines
`init_weights(rng)`. `fuse_` folds each Conv+BN pair (Conv2 first folds its
1x1 into the kxk center tap) and leaves the standalone BNs and RepConv's
two branches as they are, as the JAX package's fuse_tree does. None of these
blocks takes an int8 edge: int8 serving refuses a model that holds one
(models/quant.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yololite_tpu_torch.models.checkpoint import from_jax_layout
from yololite_tpu_torch.models.modules import (
    Attention,
    BN_EPS,
    BN_MOMENTUM,
    Bottleneck,
    C2f,
    C3,
    Conv,
    DWConv,
    PSABlock,
    autopad,
    init_conv2d_,
    init_weights_,
    kaiming_uniform,
)
from yololite_tpu_torch.models.transformer import LayerNorm, Linear

Identity = nn.Identity


def _maxpool(x, k, s=1, p=0, ceil=False):
    """Max-pool with -inf padding; ceil pads the far side by what the last window needs, as the JAX package does."""
    if not ceil:
        return F.max_pool2d(x, k, s, p)
    h, w = x.shape[2:]
    eh = -(-(h + 2 * p - k) // s) * s - (h + 2 * p - k)
    ew = -(-(w + 2 * p - k) // s) * s - (w + 2 * p - k)
    return F.max_pool2d(F.pad(x, (p, p + ew, p, p + eh), value=float("-inf")), k, s)


def _avgpool2(x):
    """The 2x2 stride-1 average pool, no padding."""
    return F.avg_pool2d(x, 2, 1, 0, count_include_pad=True)


def _bn(c: int) -> nn.BatchNorm2d:
    """A standalone BatchNorm2d with the package's eps and momentum."""
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class MaxPool(nn.Module):
    def __init__(self, k, s=1, p=0, ceil=False):
        super().__init__()
        self.k, self.s, self.p, self.ceil = k, s, p, ceil
        self.downsample = s

    def forward(self, x):
        return _maxpool(x, self.k, self.s, self.p, self.ceil)


class Focus(nn.Module):
    """Space-to-depth stem: the four 2x2 phases (rows even/odd first) stacked on channels, then a Conv."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act)
        self.downsample = 2 * s

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class GhostConv(nn.Module):
    """Primary conv and a cheap 5x5 depthwise conv of its output, concatenated."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)
        self.downsample = s

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck with an optional stride-2 depthwise conv."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.downsample = s
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1), DWConv(c_, c_, k, s, act=False) if s == 2 else Identity(),
                                  GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False), Conv(c1, c2, 1, 1, act=False)) if s == 2
                         else Identity())

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class LightConv(nn.Module):
    """1x1 conv (no activation), then a depthwise conv."""

    def __init__(self, c1, c2, k=1, act="relu"):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv; init draws the weight as the JAX package does (flipped HWIO, fan_in c_out * k * k), bias 0."""

    def __init__(self, c1, c2, k=2, s=2, p=0, bias=True):
        super().__init__(c1, c2, k, s, p, bias=bias)
        self.downsample = 1 / s

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        c1, c2, k, _ = self.weight.shape
        v = kaiming_uniform(rng, (k, k, c1, c2), c2 * k * k).numpy()
        self.weight.copy_(torch.from_numpy(from_jax_layout("convT", v).copy()))
        if self.bias is not None:
            self.bias.zero_()


class ConvTranspose(nn.Module):
    """ConvTranspose2d + a standalone BN + SiLU."""

    def __init__(self, c1, c2, k=2, s=2, p=0, bn=True, act=True):
        super().__init__()
        self.conv_transpose = ConvTranspose2d(c1, c2, k, s, p, bias=not bn)
        self.bn = _bn(c2) if bn else None
        self.act = nn.SiLU() if act is True else Identity()
        self.downsample = 1 / s

    def forward(self, x):
        y = self.conv_transpose(x)
        return self.act(self.bn(y) if self.bn is not None else y)


class ChannelAttention(nn.Module):
    """Global-average squeeze-excite gate."""

    def __init__(self, channels):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, 1, 0, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """Gate from a conv of the channel mean and max."""

    def __init__(self, kernel_size=7):
        super().__init__()
        if kernel_size not in (3, 7):
            raise ValueError(f"SpatialAttention takes kernel_size 3 or 7, got {kernel_size}")
        self.cv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.cv1(torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)))


class CBAM(nn.Module):
    """Channel attention, then spatial attention."""

    def __init__(self, c1, kernel_size=7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(kernel_size)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class RepConv(nn.Module):
    """3x3 and 1x1 conv branches (each Conv + BN), an optional identity BN, summed, then SiLU."""

    def __init__(self, c1, c2, k=3, s=1, p=1, g=1, d=1, act=True, bn=False):
        super().__init__()
        if k != 3 or p != 1:
            raise ValueError(f"RepConv takes k=3, p=1, got k={k}, p={p}")
        self.conv1 = Conv(c1, c2, k, s, p=p, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=(p - k // 2), g=g, act=False)
        self.bn = _bn(c1) if bn and c2 == c1 and s == 1 else None
        self.act = nn.SiLU() if act is True else Identity()
        self.downsample = s

    def forward(self, x):
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            y = y + self.bn(x)
        return self.act(y)


class RepVGGDW(nn.Module):
    """Depthwise 7x7 and 3x3 branches, summed, then SiLU."""

    def __init__(self, ed):
        super().__init__()
        self.conv = Conv(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, 1, 1, g=ed, act=False)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.conv(x) + self.conv1(x))


# ---- CSP family ----


class C1(nn.Module):
    """CSP with 1 conv and a residual over n 3x3 Convs."""

    def __init__(self, c1, c2, n=1):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.m = nn.Sequential(*(Conv(c2, c2, 3) for _ in range(n)))

    def forward(self, x):
        y = self.cv1(x)
        return self.m(y) + y


class C2(nn.Module):
    """CSP with 2 convs."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat([self.m(a), b], 1))


class C3x(C3):
    """C3 with cross (1, 3) / (3, 1) kernels."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e, bottleneck_k=((1, 3), (3, 1)))


class C3Ghost(C3):
    """C3 with GhostBottlenecks."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class RepC3(nn.Module):
    """Rep C3 of RT-DETR necks."""

    def __init__(self, c1, c2, n=3, e=1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c1, c2, 1, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_) for _ in range(n)))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else Identity()

    def forward(self, x):
        return self.cv3(self.m(self.cv1(x)) + self.cv2(x))


class BottleneckCSP(nn.Module):
    """The original CSP bottleneck: bias-free plain 1x1 convs cv2 and cv3, and a standalone BN over their concat."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))
        self.bn = _bn(2 * c_)
        self.act = nn.SiLU()

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        """cv1, cv2, cv3, cv4, m: the JAX package draws cv2's and cv3's biases too, then drops them."""
        self.cv1.init_weights(rng)
        for conv in (self.cv2, self.cv3):
            init_conv2d_(conv, rng)
            kaiming_uniform(rng, (conv.out_channels,), conv.in_channels)
        self.cv4.init_weights(rng)
        init_weights_(self.m, rng)
        self.bn.reset_parameters()

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        y2 = self.cv2(x)
        return self.cv4(self.act(self.bn(torch.cat([y1, y2], 1))))


class SPP(nn.Module):
    """Spatial pyramid pooling with parallel max-pools."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [_maxpool(y, k, 1, k // 2) for k in self.k], 1))


class Proto(nn.Module):
    """Mask prototypes: Conv, 2x transposed-conv upsample, Conv, Conv."""

    def __init__(self, c1, c_=256, c2=32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


# ---- HGNetV2 ----


class HGStem(nn.Module):
    """PPHGNetV2 stem: a zero pad on the far side before each 2x2 conv branch and the ceil-mode 2x2 pool."""

    def __init__(self, c1, cm, c2):
        super().__init__()
        self.downsample = 4
        self.stem1 = Conv(c1, cm, 3, 2, act="relu")
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = Conv(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = Conv(cm, c2, 1, 1, act="relu")

    def forward(self, x):
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x1 = _maxpool(x, 2, 1, 0, ceil=True)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2 block: a chain of n Convs (or LightConvs), all outputs concatenated, squeezed and excited."""

    def __init__(self, c1, cm, c2, k=3, n=6, lightconv=False, shortcut=False, act="relu"):
        super().__init__()
        block = LightConv if lightconv else Conv
        self.add = shortcut and c1 == c2
        self.m = nn.ModuleList(block(c1 if i == 0 else cm, cm, k=k, act=act) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=act)
        self.ec = Conv(c2 // 2, c2, 1, 1, act=act)

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


# ---- ResNet ----


class ResNetBlock(nn.Module):
    """Bottleneck residual block with ReLU after the sum."""

    def __init__(self, c1, c2, s=1, e=4):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1, act=True)
        self.cv2 = Conv(c2, c2, 3, s, p=1, act=True)
        self.cv3 = Conv(c2, c3, 1, act=False)
        self.shortcut = nn.Sequential(Conv(c1, c3, 1, s, act=False)) if s != 1 or c1 != c3 else Identity()

    def forward(self, x):
        return F.relu(self.cv3(self.cv2(self.cv1(x))) + self.shortcut(x))


class ResNetLayer(nn.Module):
    """A stack of ResNet blocks, or the 7x7 stride-2 stem and a 3x3 stride-2 max-pool."""

    def __init__(self, c1, c2, s=1, is_first=False, n=1, e=4):
        super().__init__()
        self.is_first = is_first
        if is_first:
            self.layer = nn.Sequential(Conv(c1, c2, 7, 2, p=3, act=True), MaxPool(3, 2, 1))
        else:
            self.layer = nn.Sequential(ResNetBlock(c1, c2, s, e=e),
                                       *(ResNetBlock(e * c2, c2, 1, e=e) for _ in range(n - 1)))

    def forward(self, x):
        return self.layer(x)


# ---- YOLOv9 ----


class RepBottleneck(Bottleneck):
    """Bottleneck whose cv1 is a RepConv."""

    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__(c1, c2, shortcut, g, k, e)
        self.cv1 = RepConv(c1, int(c2 * e), k[0] if isinstance(k[0], int) else 3, 1)


class RepCSP(C3):
    """C3 with RepBottlenecks."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(RepBottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN: split, two RepCSP + Conv stages on the second half, all four concatenated."""

    def __init__(self, c1, c2, c3, c4, n=1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), Conv(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3, 1))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


class ELAN1(RepNCSPELAN4):
    """ELAN with plain 3x3 Convs for the two stages."""

    def __init__(self, c1, c2, c3, c4):
        nn.Module.__init__(self)
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 // 2, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)


class AConv(nn.Module):
    """2x2 average pool (stride 1), then a stride-2 3x3 Conv."""

    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, 1)
        self.downsample = 2

    def forward(self, x):
        return self.cv1(_avgpool2(x))


class ADown(nn.Module):
    """Average pool, then half the channels through a stride-2 Conv and half through a max-pool and a 1x1 Conv."""

    def __init__(self, c1, c2):
        super().__init__()
        self.c = c2 // 2
        self.c1h = c1 // 2
        self.cv1 = Conv(c1 // 2, self.c, 3, 2, 1)
        self.cv2 = Conv(c1 // 2, self.c, 1, 1, 0)
        self.downsample = 2

    def forward(self, x):
        x = _avgpool2(x)
        x1, x2 = x[:, :self.c1h], x[:, self.c1h:]
        return torch.cat([self.cv1(x1), self.cv2(_maxpool(x2, 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """SPP-ELAN: three chained k x k max-pools of cv1's output, all four concatenated."""

    def __init__(self, c1, c2, c3, k=5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(_maxpool(ys[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(ys, 1))


class CBLinear(nn.Module):
    """A biased conv whose output is split into channel groups (returns the list)."""

    def __init__(self, c1, c2s, k=1, s=1, p=None, g=1):
        super().__init__()
        self.c2s = list(c2s)
        self.conv = nn.Conv2d(c1, sum(c2s), k, s, autopad(k, p), groups=g, bias=True)

    def forward(self, x):
        return list(self.conv(x).split(self.c2s, 1))


class CBFuse(nn.Module):
    """Each CBLinear output's idx-th group repeated up to the last input's size, summed onto it."""

    def __init__(self, idx):
        super().__init__()
        self.idx = list(idx)

    def forward(self, xs):
        th, tw = xs[-1].shape[2:]
        res = []
        for i, x in enumerate(xs[:-1]):
            t = x[self.idx[i]]
            res.append(t.repeat_interleave(th // t.shape[2], 2).repeat_interleave(tw // t.shape[3], 3))
        return sum(res) + xs[-1]


# ---- YOLOv10 ----


class CIB(nn.Module):
    """Conditional identity block: depthwise / pointwise chain (a RepVGGDW in the middle with lk)."""

    def __init__(self, c1, c2, shortcut=True, e=0.5, lk=False):
        super().__init__()
        c_ = int(c2 * e)
        self.add = shortcut and c1 == c2
        self.cv1 = nn.Sequential(
            Conv(c1, c1, 3, g=c1),
            Conv(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
            Conv(2 * c_, c2, 1),
            Conv(c2, c2, 3, g=c2),
        )

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB inner blocks."""

    def __init__(self, c1, c2, n=1, shortcut=False, lk=False, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class PSA(nn.Module):
    """Position-sensitive attention: split, attention and FFN with residuals on one half, merge."""

    def __init__(self, c1, c2, e=0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"PSA needs c1 == c2, got {c1} and {c2}")
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.attn = Attention(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1))
        self.ffn = nn.Sequential(Conv(self.c, self.c * 2, 1), Conv(self.c * 2, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


class C2fPSA(C2f):
    """C2f with PSABlock inner blocks."""

    def __init__(self, c1, c2, n=1, e=0.5):
        if c1 != c2:
            raise ValueError(f"C2fPSA needs c1 == c2, got {c1} and {c2}")
        super().__init__(c1, c2, n=n, shortcut=False, e=e)
        self.m = nn.ModuleList(PSABlock(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1)) for _ in range(n))


class SCDown(nn.Module):
    """Separable downsample: 1x1 Conv, then a strided depthwise Conv."""

    def __init__(self, c1, c2, k, s):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k=k, s=s, g=c2, act=False)
        self.downsample = s

    def forward(self, x):
        return self.cv2(self.cv1(x))


class C3f(nn.Module):
    """C3-style split whose Bottleneck chain grows the concat list."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv((2 + n) * c_, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n))

    def forward(self, x):
        ys = [self.cv2(x), self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv3(torch.cat(ys, 1))


class Conv2(Conv):
    """Conv with a parallel bias-free 1x1 branch that shares the BN and activation.

    fuse() folds the 1x1 into the kxk center tap, then the BN into the conv.
    """

    def __init__(self, c1, c2, k=3, s=1, p=None, g=1, d=1, act=True):
        super().__init__(c1, c2, k, s, p, g, d, act)
        self.cv2 = nn.Conv2d(c1, c2, 1, s, 0, dilation=d, groups=g, bias=False)

    def init_weights(self, rng: np.random.Generator) -> None:
        init_conv2d_(self.conv, rng)
        init_conv2d_(self.cv2, rng)
        self.bn.reset_parameters()

    def forward(self, x):
        y = self.conv(x)
        if self.cv2 is not None:
            y = y + self.cv2(x)
        if self.bn is not None:
            y = self.bn(y)
        return self.act(y)

    @torch.no_grad()
    def fuse(self) -> None:
        if self.cv2 is not None:
            kh, kw = self.conv.weight.shape[2:]
            self.conv.weight[:, :, kh // 2, kw // 2] += self.cv2.weight[:, :, 0, 0]
            self.cv2 = None
        super().fuse()


class DWConvTranspose2d(nn.ConvTranspose2d):
    """Depthwise transposed conv, groups = gcd(c1, c2), without bias (the JAX package's block has none).

    Its JAX leaf 'wt' is 5-dim, (kh, kw, c1/g, g, c2/g), flipped; init draws that shape.
    """

    def __init__(self, c1, c2, k=1, s=1, p1=0, p2=0):
        if p2 != 0:
            raise ValueError("DWConvTranspose2d: output_padding is not supported")
        g = math.gcd(c1, c2)
        super().__init__(c1, c2, k, s, p1, groups=g, bias=False)
        self.downsample = 1 / s

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        c1, og, k, _ = self.weight.shape
        g = self.groups
        v = kaiming_uniform(rng, (k, k, c1 // g, g, og), og * k * k).numpy()
        self.weight.copy_(torch.from_numpy(from_jax_layout("convT5", v).copy()))


# ---- YOLO-World ----


class MaxSigmoidAttnBlock(nn.Module):
    """Guide-conditioned max-sigmoid gate on a projected map. Input: [x (B, c1, H, W), guide (B, N, gc)]."""

    def __init__(self, c1, c2, nh=1, ec=128, gc=512, scale=False):
        super().__init__()
        self.nh, self.hc = nh, c2 // nh
        self.gl = Linear(gc, ec)
        self.proj_conv = Conv(c1, c2, 3, 1, act=False)
        self.ec = Conv(c1, ec, 1, act=False) if c1 != ec else None
        self.bias = nn.Parameter(torch.zeros(nh))
        self.scale = nn.Parameter(torch.ones(1, nh, 1, 1)) if scale else None

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        for child in self.children():
            init_weights_(child, rng)
        self.bias.zero_()
        if self.scale is not None:
            self.scale.fill_(1.0)

    def forward(self, x):
        x, guide = x
        B, _, H, W = x.shape
        guide = self.gl(guide).view(B, -1, self.nh, self.hc)
        embed = (self.ec(x) if self.ec is not None else x).view(B, self.nh, self.hc, H, W)
        aw = torch.einsum("bmchw,bnmc->bmhwn", embed, guide).amax(-1)
        aw = torch.sigmoid(aw / (self.hc ** 0.5) + self.bias[None, :, None, None])
        if self.scale is not None:
            aw = aw * self.scale
        y = self.proj_conv(x).view(B, self.nh, self.hc, H, W)
        return (y * aw.unsqueeze(2)).view(B, -1, H, W)


class C2fAttn(nn.Module):
    """C2f with a guide-attention branch at the end of the concat. Input: [x, guide]."""

    def __init__(self, c1, c2, n=1, ec=128, nh=1, gc=512, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((3 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(self.c, self.c, gc=gc, ec=ec, nh=nh)

    def forward(self, x):
        x, guide = x
        ys = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn([ys[-1], guide]))
        return self.cv2(torch.cat(ys, 1))


class ImagePoolingAttn(nn.Module):
    """Text embeddings attending over k x k max-pooled projections of image maps. Input: [*maps, text (B, N, ct)]."""

    def __init__(self, ec=256, ch=(), ct=512, nh=8, k=3, scale=False):
        super().__init__()
        self.ec, self.nh, self.nf, self.hc, self.k = ec, nh, len(ch), ec // nh, k
        self.query = nn.Sequential(LayerNorm(ct), Linear(ct, ec))
        self.key = nn.Sequential(LayerNorm(ec), Linear(ec, ec))
        self.value = nn.Sequential(LayerNorm(ec), Linear(ec, ec))
        self.proj = Linear(ec, ct)
        self.projections = nn.ModuleList(nn.Conv2d(c, ec, 1) for c in ch)
        self.scale = nn.Parameter(torch.zeros(1)) if scale else None

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        for child in self.children():
            init_weights_(child, rng)
        if self.scale is not None:
            self.scale.zero_()

    def forward(self, x):
        *feats, text = x
        if len(feats) != self.nf:
            raise ValueError(f"ImagePoolingAttn expects {self.nf} maps, got {len(feats)}")
        B = feats[0].shape[0]
        pooled = [F.adaptive_max_pool2d(p(f), self.k).flatten(2).permute(0, 2, 1)
                  for p, f in zip(self.projections, feats)]
        kv = torch.cat(pooled, 1)
        q = self.query(text).reshape(B, -1, self.nh, self.hc)
        k = self.key(kv).reshape(B, -1, self.nh, self.hc)
        v = self.value(kv).reshape(B, -1, self.nh, self.hc)
        aw = (torch.einsum("bnmc,bkmc->bmnk", q, k) / (self.hc ** 0.5)).softmax(-1)
        out = self.proj(torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(B, -1, self.ec))
        return out * (self.scale if self.scale is not None else 1.0) + text


class ContrastiveHead(nn.Module):
    """Region-text similarity logits from L2-normalized features. Input: [x (B, C, H, W), w (B, K, C)]."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        self.bias.fill_(-10.0)
        self.logit_scale.fill_(math.log(1 / 0.07))

    def forward(self, x):
        x, w = x
        y = torch.einsum("bchw,bkc->bkhw", F.normalize(x, dim=1, eps=1e-12), F.normalize(w, dim=-1, eps=1e-12))
        return y * self.logit_scale.exp() + self.bias


class BNContrastiveHead(nn.Module):
    """ContrastiveHead with a BN on the region features in place of their L2 norm."""

    def __init__(self, embed_dims):
        super().__init__()
        self.norm = _bn(embed_dims)
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        self.norm.reset_parameters()
        self.bias.fill_(-10.0)
        self.logit_scale.fill_(-1.0)

    def forward(self, x):
        x, w = x
        y = torch.einsum("bchw,bkc->bkhw", self.norm(x), F.normalize(w, dim=-1, eps=1e-12))
        return y * self.logit_scale.exp() + self.bias
