"""Transformer layers of the encoder side as torch modules: port of yololite_tpu/models/transformer.py.

Tokens are (B, N, C). A block that takes a feature map (AIFI,
TransformerBlock) takes it NCHW and flattens it to tokens in pixel order
(y * W + x), which is the order in which the JAX package reshapes its NHWC
map. Parameter names follow the upstream torch modules (nn.Linear,
nn.LayerNorm, nn.MultiheadAttention's packed `in_proj_weight`), and each
module draws its initial weights as the JAX module does (`init_weights`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yololite_tpu_torch.models.modules import C3, Conv, kaiming_uniform


class Linear(nn.Linear):
    """nn.Linear; init draws the (out, in) weight, then the bias, both with fan_in = in."""

    def __init__(self, c1, c2, bias=True):
        super().__init__(c1, c2, bias=bias)

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        self.weight.copy_(kaiming_uniform(rng, tuple(self.weight.shape), self.in_features))
        if self.bias is not None:
            self.bias.copy_(kaiming_uniform(rng, (self.out_features,), self.in_features))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5."""

    def __init__(self, c, eps=1e-5):
        super().__init__(c, eps=eps)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map, eps 1e-6."""

    def __init__(self, num_channels, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = ((x - u) ** 2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj) on (B, N, E) tokens; no dropout.

    The logits are formed in fp32 and the softmax cast to the values' dtype, as in the JAX package.
    """

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.e, self.h = embed_dim, num_heads
        self.hd = embed_dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        self.in_proj_weight.copy_(kaiming_uniform(rng, (3 * self.e, self.e), self.e))
        self.in_proj_bias.zero_()
        self.out_proj.weight.copy_(kaiming_uniform(rng, (self.e, self.e), self.e))
        self.out_proj.bias.zero_()

    def forward(self, q, k, v):
        e, w, b = self.e, self.in_proj_weight, self.in_proj_bias
        q = F.linear(q, w[:e], b[:e])
        k = F.linear(k, w[e:2 * e], b[e:2 * e])
        v = F.linear(v, w[2 * e:], b[2 * e:])
        B, N, _ = q.shape
        q = q.reshape(B, N, self.h, self.hd)
        k = k.reshape(B, -1, self.h, self.hd)
        v = v.reshape(B, -1, self.h, self.hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(self.hd)
        attn = attn.softmax(-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, e)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm (or pre-norm) encoder layer on tokens; dropout 0."""

    def __init__(self, c1, cm=2048, num_heads=8, dropout=0.0, act="gelu", normalize_before=False):
        super().__init__()
        self.normalize_before = normalize_before
        self.act = act
        self.ma = MultiheadAttention(c1, num_heads)
        self.fc1 = Linear(c1, cm)
        self.fc2 = Linear(cm, c1)
        self.norm1 = LayerNorm(c1)
        self.norm2 = LayerNorm(c1)

    def _ffn(self, x):
        y = self.fc1(x)
        return self.fc2(F.gelu(y) if self.act == "gelu" else F.relu(y))

    def forward_tokens(self, src, pos=None):
        def attn(s, q_src):
            q = q_src if pos is None else q_src + pos
            return self.ma(q, q, s)

        if self.normalize_before:
            s2 = self.norm1(src)
            src = src + attn(s2, s2)
            return src + self._ffn(self.norm2(src))
        src = self.norm1(src + attn(src, src))
        return self.norm2(src + self._ffn(src))

    def forward(self, x):
        return self.forward_tokens(x)


def sincos_2d(w: int, h: int, embed_dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """2D sin-cos positional embedding (1, w * h, embed_dim), rows in (w, h) order as the JAX package builds it."""
    if embed_dim % 4:
        raise ValueError(f"sincos_2d needs embed_dim divisible by 4, got {embed_dim}")
    grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32), torch.arange(h, dtype=torch.float32),
                                    indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim))
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


class AIFI(TransformerEncoderLayer):
    """Encoder layer over an NCHW map's pixels with the 2D sin-cos position added to queries and keys."""

    def forward(self, x):
        B, C, H, W = x.shape
        pos = sincos_2d(W, H, C).to(x)
        out = self.forward_tokens(x.flatten(2).permute(0, 2, 1), pos=pos)
        return out.permute(0, 2, 1).reshape(B, C, H, W)


class TransformerLayer(nn.Module):
    """LayerNorm-free ViT layer on tokens."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.q = Linear(c, c, bias=False)
        self.k = Linear(c, c, bias=False)
        self.v = Linear(c, c, bias=False)
        self.ma = MultiheadAttention(c, num_heads)
        self.fc1 = Linear(c, c, bias=False)
        self.fc2 = Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Optional 1x1 Conv to c2, a learned position term, then a stack of TransformerLayers over the pixels.

    Children are registered in the JAX package's draw order: linear, tr, conv.
    """

    def __init__(self, c1, c2, num_heads, num_layers):
        super().__init__()
        self.c2 = c2
        self.linear = Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(num_layers)))
        self.conv = Conv(c1, c2) if c1 != c2 else None

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        B, C, H, W = x.shape
        p = x.flatten(2).permute(0, 2, 1)
        p = self.tr(p + self.linear(p))
        return p.permute(0, 2, 1).reshape(B, C, H, W)


class MLPBlock(nn.Module):
    """Linear, GELU, Linear."""

    def __init__(self, embedding_dim, mlp_dim):
        super().__init__()
        self.lin1 = Linear(embedding_dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, embedding_dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class MLP(nn.Module):
    """num_layers Linears with ReLU between them, and an optional sigmoid at the end."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers, sigmoid=False):
        super().__init__()
        h = [hidden_dim] * (num_layers - 1)
        self.num_layers = num_layers
        self.sigmoid = sigmoid
        self.layers = nn.ModuleList(Linear(n, k) for n, k in zip([input_dim] + h, h + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x.sigmoid() if self.sigmoid else x


class C3TR(C3):
    """C3 whose inner stack is a TransformerBlock of n layers with 4 heads."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n)

