"""YOLO11 building blocks as torch modules (NCHW).

Port of the YOLO11 part of yololite_tpu/models/modules.py. Submodule names
follow the upstream torch model (cv1, m.0, bn, ...), so a state_dict with
upstream names loads with strict=True, and submodules are registered in the
order in which the JAX modules draw their initial weights, so that
`DetectionModel.init(seed)` gives the same weights as the JAX `init(seed)`.

int8 serving (models/quant.py): a quantized Conv holds a `QConv` in place of
its conv and runs K8 (`ops.kernels.int8_conv`); the edges between quantized
convs are int8 tensors at one global scale, channels-last in memory.
Bottleneck adds them saturating in int16, SPPF max-pools them, Upsample and
Concat pass them on, all in integers; an unquantized Conv dequantizes an
int8 input at its `deq_s`.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yololite_tpu_torch.ops.kernels import ACTS, dequantize_act, int8_conv

BN_EPS = 1e-3  # upstream BatchNorm2d eps
BN_MOMENTUM = 0.03  # and momentum


def autopad(k, p=None, d: int = 1):
    """'same'-shape padding, int or (kh, kw)."""
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else tuple(d * (x - 1) + 1 for x in k)
    if p is None:
        p = k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)
    return p


def kaiming_uniform(rng: np.random.Generator, shape, fan_in: int) -> torch.Tensor:
    """torch.nn.Conv2d's default init, U(-b, b) with b = 1/sqrt(fan_in), drawn from a numpy rng.

    Same draw as the JAX package's `_kaiming_uniform`: a conv weight is drawn in
    HWIO order there, so callers draw that shape and transpose to OIHW.
    """
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.from_numpy(rng.uniform(-bound, bound, size=shape).astype(np.float32))


@torch.no_grad()
def init_conv2d_(conv: nn.Conv2d, rng: np.random.Generator) -> None:
    """Draw a conv's weight (HWIO order, then OIHW) and, if it has one, its bias."""
    o, i, kh, kw = conv.weight.shape
    fan_in = i * kh * kw
    conv.weight.copy_(kaiming_uniform(rng, (kh, kw, i, o), fan_in).permute(3, 2, 0, 1))
    if conv.bias is not None:
        conv.bias.copy_(kaiming_uniform(rng, (o,), fan_in))


class QConv(nn.Module):
    """The quantized conv of a Conv (port of the `q` branch of yololite_tpu Conv.__call__, modules.py:176-185).

    Buffers: `weight` int8 OHWI (Cout, KH, KW, Cin/groups), per-output-channel
    `sw`, `scale` = sin * sw and the folded `bias` in fp32, the input scale
    `sin` (0-d fp32; a float input is quantized at it inside K8, and on the
    CPU by K8's plain version) and, when the consumer is quantized, `sout`
    (else the output stays bf16).
    """

    def __init__(self, weight: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor, sin: float,
                 sout: Optional[float], stride: int, padding: int, groups: int):
        super().__init__()
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)
        self.register_buffer("weight", weight.to(torch.int8).contiguous())
        self.register_buffer("sw", f32(sw).clone())
        self.register_buffer("scale", f32(sin) * f32(sw))  # fp32 product, as the JAX epilogue forms it
        self.register_buffer("bias", f32(bias).clone())
        self.register_buffer("sin", f32(sin).clone())
        self.sin_value = float(self.sin)  # the op's argument: a Python float, so torch.export records a constant
        self.sout = None if sout is None else float(f32(sout))
        self.stride, self.padding, self.groups = int(stride), int(padding), int(groups)

    def forward(self, x: torch.Tensor, act: int) -> torch.Tensor:
        # a bf16 island boundary (or the image) comes in as floats: K8 quantizes them at sin as it loads them
        return int8_conv(x, self.weight, self.scale, self.bias, self.stride, self.padding, self.groups, act,
                         self.sout or 0.0, self.sin_value)


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d + SiLU; after fuse() a biased Conv2d + SiLU; quantized, a QConv."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        if isinstance(k, (tuple, list)) and k[0] == k[1]:
            k = k[0]
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act is True else nn.ReLU() if act == "relu" else nn.Identity()
        self.downsample = s if isinstance(s, int) else int(s[0])
        self.deq_s = None  # int8 serving: the scale at which an int8 input is dequantized

    def forward(self, x):
        if isinstance(self.conv, QConv):
            return self.conv(x, self.act_code)
        if x.dtype == torch.int8:  # int8 edge into an unquantized conv
            if self.deq_s is None:
                raise ValueError("an int8 input reached a Conv that models/quant.py left without a deq_s")
            x = dequantize_act(x, self.deq_s)
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return self.act(y)

    @property
    def act_code(self) -> int:
        """The activation as K8's epilogue code."""
        return ACTS["silu" if isinstance(self.act, nn.SiLU) else "relu" if isinstance(self.act, nn.ReLU) else "none"]

    def init_weights(self, rng: np.random.Generator) -> None:
        init_conv2d_(self.conv, rng)
        if self.bn is not None:
            self.bn.reset_parameters()  # weight 1, bias 0, running mean 0, var 1

    @torch.no_grad()
    def fuse(self) -> None:
        """Fold BN into the conv in place (inference), as yololite_tpu's Conv.fuse."""
        if self.bn is None:
            return
        bn = self.bn
        g = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
        conv = self.conv
        fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
                          dilation=conv.dilation, groups=conv.groups, bias=True).to(conv.weight)
        fused.weight.copy_(conv.weight * g[:, None, None, None])
        fused.bias.copy_(bn.bias - bn.running_mean * g)
        self.conv = fused
        self.bn = None


class DWConv(Conv):
    """Depthwise conv: groups = gcd(c1, c2)."""

    def __init__(self, c1, c2, k=1, s=1, d=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class Bottleneck(nn.Module):
    """cv1 -> cv2 (+ residual)."""

    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if not self.add:
            return y
        if x.dtype == torch.int8:  # int8 serving: both edges share the global scale; saturating add
            return torch.clamp(x.to(torch.int16) + y.to(torch.int16), -127, 127).to(torch.int8)
        return x + y


class C3(nn.Module):
    """CSP with 3 convs."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, bottleneck_k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=bottleneck_k, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 with square-k bottlenecks."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        super().__init__(c1, c2, n, shortcut, g, e, bottleneck_k=((k, k), (k, k)))


class C2f(nn.Module):
    """Split-and-grow CSP block."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class C3k2(C2f):
    """C2f whose inner blocks are C3k or Bottleneck."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k else Bottleneck(self.c, self.c, shortcut, g)
            for _ in range(n)
        )


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast: three chained k x k max-pools (padding acts as -inf)."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)

    def _pool(self, x):
        if x.dtype != torch.int8:
            return F.max_pool2d(x, self.k, 1, self.k // 2)
        # int8: torch's CUDA max-pool takes no integers. The k x k max, separable, over an input padded
        # with -128 (the int8 minimum, as the JAX package's reduce_window init): exact, and stays int8.
        p, (h, w) = self.k // 2, x.shape[2:]
        xp = F.pad(x, (p, p, p, p), value=-128)
        y = xp[:, :, 0:h]
        for i in range(1, self.k):
            y = torch.maximum(y, xp[:, :, i:i + h])
        out = y[:, :, :, 0:w]
        for i in range(1, self.k):
            out = torch.maximum(out, y[:, :, :, i:i + w])
        return out

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self._pool(y[-1]))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """Spatial MHSA with conv qkv + depthwise positional encoding.

    The logits and softmax stay in the activation dtype, bf16 on the half path,
    as in the JAX package.
    """

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        nh_kd = self.key_dim * num_heads
        h = dim + nh_kd * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).view(B, self.num_heads, self.key_dim * 2 + self.head_dim, N)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = (q.transpose(-2, -1) @ k) * self.scale  # (B, nh, N, N)
        attn = attn.softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).view(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    """Attention + conv FFN with residuals."""

    def __init__(self, c, attn_ratio=0.5, num_heads=4, shortcut=True):
        super().__init__()
        self.attn = Attention(c, attn_ratio=attn_ratio, num_heads=num_heads)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x):
        a = self.attn(x)
        x = x + a if self.add else a
        f = self.ffn(x)
        return x + f if self.add else f


class C2PSA(nn.Module):
    """Split + stacked PSA blocks + merge."""

    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"C2PSA needs c1 == c2, got {c1} and {c2}")
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1)) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class Concat(nn.Module):
    """Channel concat of multiple inputs."""

    def __init__(self, dim=1):
        super().__init__()
        self.d = dim

    def forward(self, xs: List[torch.Tensor]):
        return torch.cat(xs, self.d)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer factor (nn.Upsample(scale_factor=2, mode='nearest'))."""

    def __init__(self, size=None, scale_factor=2, mode="nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError("only nearest upsampling is used by YOLO11")
        self.scale = int(scale_factor)
        self.downsample = 1 / self.scale

    def forward(self, x):
        if x.dtype == torch.int8:  # torch's nearest upsample takes no channels-last int8: repeat each pixel
            b, c, h, w = x.shape
            s = self.scale
            # in NHWC, so that the copy comes out channels-last, as the int8 edges and K8 keep them
            y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(b, h, s, w, s, c).reshape(b, h * s, w * s, c)
            return y.permute(0, 3, 1, 2)
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Detect(nn.Module):
    """Decoupled detect head over P3/P4/P5; returns the raw per-level maps (B, no, H, W).

    Decoding to boxes lives in yololite_tpu_torch.ops. end2end=True adds the
    NMS-free one2one branch pair, which sees detached inputs; forward then
    returns {"one2many": [maps], "one2one": [maps]}.
    """

    def __init__(self, nc=80, ch=(), end2end: bool = False):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = 16
        self.no = nc + self.reg_max * 4
        self.stride = [8, 16, 32][: self.nl]  # set by parse_spec
        self.end2end = bool(end2end)
        self.max_det = 300  # one2one top-k pool
        c2 = max(16, ch[0] // 4, self.reg_max * 4)
        c3 = max(ch[0], min(nc, 100))

        def _branches():
            box = nn.ModuleList(
                nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * self.reg_max, 1)) for x in ch
            )
            cls = nn.ModuleList(
                nn.Sequential(
                    nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                    nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                    nn.Conv2d(c3, nc, 1),
                )
                for x in ch
            )
            return box, cls

        self.cv2, self.cv3 = _branches()
        if self.end2end:
            self.one2one_cv2, self.one2one_cv3 = _branches()

    @torch.no_grad()
    def bias_init(self) -> None:
        """Prior-aware bias init: box biases 1, class biases log(5 / nc / (640 / s)^2)."""
        pairs = [(self.cv2, self.cv3)]
        if self.end2end:
            pairs.append((self.one2one_cv2, self.one2one_cv3))
        for box, cls in pairs:
            for i, s in enumerate(self.stride):
                box[i][-1].bias.fill_(1.0)
                cls[i][-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    @staticmethod
    def _branch(xs, box, cls):
        return [torch.cat((box[i](x), cls[i](x)), 1) for i, x in enumerate(xs)]

    def forward(self, xs):
        if self.end2end:
            return {
                "one2many": self._branch(xs, self.cv2, self.cv3),
                "one2one": self._branch([x.detach() for x in xs], self.one2one_cv2, self.one2one_cv3),
            }
        return self._branch(xs, self.cv2, self.cv3)


class _CrossRankBN(torch.autograd.Function):
    """Train-mode batch norm over the global batch of data-parallel ranks (N, C, H, W).

    Forward: each rank's per-channel count, mean and sum of squared deviations
    go into its own row of a (world, 3, C) buffer, one all_reduce gathers the
    rows, and they combine into the global mean and biased variance (Chan's
    formula: no E[x^2] - E[x]^2 cancellation). The running statistics take
    the global mean and the unbiased global variance. Backward: one
    all_reduce of the per-channel sums of dy and dy * x_hat; the weight and
    bias gradients stay this rank's share (the trainer sums gradients over
    the ranks). All math is fp32; the output has the input's dtype.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum, group):
        import torch.distributed as dist

        xf = x.float()
        c = x.shape[1]
        n_local = x.numel() // c
        mean_l = xf.mean((0, 2, 3))
        m2_l = (xf - mean_l[:, None, None]).square().sum((0, 2, 3))
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        rows = xf.new_zeros(world, 3, c)
        rows[rank, 0] = n_local
        rows[rank, 1] = mean_l
        rows[rank, 2] = m2_l
        dist.all_reduce(rows, group=group)
        counts, means, m2s = rows[:, 0], rows[:, 1], rows[:, 2]
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        m2 = (m2s + counts * (means - mean).square()).sum(0)
        invstd = torch.rsqrt(m2 / n + eps)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean.to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1 - momentum).add_((m2 / (n - 1)).to(running_var.dtype), alpha=momentum)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.group = group
        return (xhat * weight.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        import torch.distributed as dist

        xhat, weight, invstd, n = ctx.saved_tensors
        dyf = dy.float()
        sum_dy = dyf.sum((0, 2, 3))
        sum_dy_xhat = (dyf * xhat).sum((0, 2, 3))
        sums = torch.stack([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        g_dy, g_dy_xhat = sums[0] / n, sums[1] / n
        scale = (weight.float() * invstd)[:, None, None]
        dx = scale * (dyf - g_dy[:, None, None] - xhat * g_dy_xhat[:, None, None])
        return dx.to(dy.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None, None, None, None, None


_BN_GROUP = None  # the process group of the cross-rank BNs while `cross_rank_bn` holds one


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """A BatchNorm2d that, in train mode inside `cross_rank_bn(group)`, normalizes by the global batch.

    Same parameters, buffers and state_dict keys as BatchNorm2d; outside the
    context, or in eval mode, it is BatchNorm2d.
    """

    def forward(self, x):
        if self.training and _BN_GROUP is not None:
            self.num_batches_tracked.add_(1)
            return _CrossRankBN.apply(x, self.weight, self.bias, self.running_mean, self.running_var, self.eps,
                                      self.momentum, _BN_GROUP)
        return super().forward(x)


def cross_rank_bn_(module: nn.Module) -> nn.Module:
    """Make every BatchNorm2d of `module` a CrossRankBatchNorm2d, in place (its state stays as it is)."""
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = CrossRankBatchNorm2d
    return module


class cross_rank_bn:
    """Context: the CrossRankBatchNorm2d layers take train-mode statistics over `group`'s ranks (None: local)."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        global _BN_GROUP
        self._prev, _BN_GROUP = _BN_GROUP, self.group
        return self

    def __exit__(self, *exc):
        global _BN_GROUP
        _BN_GROUP = self._prev
        return False


def init_weights_(module: nn.Module, rng: np.random.Generator) -> None:
    """Draw every conv weight (and plain-conv bias) from `rng`, in the JAX package's order.

    A module that draws leaves of its own (Conv, and the zoo's transposed
    convs, Linear, attention) has `init_weights(rng)`; a norm layer is reset
    to weight 1, bias 0 (and running mean 0, var 1); anything else passes
    the draw on to its children in registration order.
    """
    if hasattr(module, "init_weights"):
        module.init_weights(rng)
        return
    if isinstance(module, nn.Conv2d):
        init_conv2d_(module, rng)
        return
    if isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
        module.reset_parameters()
        return
    for child in module.children():
        init_weights_(child, rng)


def fuse_(module: nn.Module) -> nn.Module:
    """Fold every Conv+BN pair in place for inference (counterpart of yololite_tpu fuse_tree).

    Standalone BNs (RepConv's identity BN, BottleneckCSP's, ConvTranspose's)
    stay unfused, and RepConv's branches stay two convs, as fuse_tree leaves them.
    """
    for m in module.modules():
        if isinstance(m, Conv):
            m.fuse()
    return module
