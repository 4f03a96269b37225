"""Deformable-DETR decoder stack as torch modules: port of yololite_tpu/models/deformable.py.

The RT-DETR tail of the zoo: multiscale deformable attention (MSDeformAttn),
the decoder layer (self-attention, deformable cross-attention, FFN) and the
iterative box-refinement decoder. Tokens are (B, N, C); the value tokens of
each level are in pixel order (y * W + x). Built on models/transformer.py's
Linear, LayerNorm and MultiheadAttention, with the upstream parameter names,
and each module draws its initial weights as the JAX module does.

The bilinear sampling is F.grid_sample (bilinear, zeros padding,
align_corners=False), the op the JAX package's gather reproduces.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yololite_tpu_torch.models.modules import init_weights_
from yololite_tpu_torch.models.transformer import LayerNorm, Linear, MultiheadAttention


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """F.grid_sample(mode=bilinear, padding=zeros, align_corners=False) in the JAX package's layout.

    img: (N, H, W, C); grid: (N, Q, P, 2) xy in [-1, 1]. Returns (N, Q, P, C).
    """
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def multi_scale_deformable_attn(
    value: torch.Tensor,  # (B, len_v, heads, c_head)
    value_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Q, heads, levels, points, 2) in [0, 1]
    attention_weights: torch.Tensor,  # (B, Q, heads, levels, points)
) -> torch.Tensor:
    """Each head samples its points on every level bilinearly and sums them by weight -> (B, Q, heads * c_head)."""
    B, _, heads, c_head = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    grids = 2 * sampling_locations - 1
    start = 0
    sampled = []
    for lvl, (H, W) in enumerate(value_shapes):
        v = value[:, start:start + H * W]  # (B, HW, heads, c)
        start += H * W
        v = v.permute(0, 2, 1, 3).reshape(B * heads, H, W, c_head)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * heads, Q, P, 2)
        sampled.append(grid_sample_bilinear(v, g))  # (B*heads, Q, P, c)
    s = torch.stack(sampled, dim=2)  # (B*heads, Q, L, P, c)
    w = attention_weights.permute(0, 2, 1, 3, 4).reshape(B * heads, Q, L, P, 1)
    out = (s * w).sum(dim=(2, 3))  # (B*heads, Q, c)
    return out.reshape(B, heads, Q, c_head).permute(0, 2, 1, 3).reshape(B, Q, heads * c_head)


class MSDeformAttn(nn.Module):
    """Multiscale deformable attention: each query samples n_points offsets around its reference on every level."""

    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} must be divisible by n_heads {n_heads}")
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        # registered in the JAX module's draw order
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    @torch.no_grad()
    def init_weights(self, rng: np.random.Generator) -> None:
        """Draw every Linear, then zero the offset and weight projections and set the offsets' grid prior."""
        for child in self.children():
            child.init_weights(rng)
        thetas = np.arange(self.n_heads, dtype=np.float32) * np.float32(2 * math.pi / self.n_heads)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid[:, None, None, :], (1, self.n_levels, self.n_points, 1))
        for i in range(self.n_points):
            grid[:, :, i, :] *= i + 1
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(grid.reshape(-1).astype(np.float32)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, refer_bbox, value, value_shapes, value_mask: Optional[torch.Tensor] = None):
        """query (B, Q, C); refer_bbox (B, Q, levels, 2 or 4) normalized; value (B, len_v, C)."""
        B, Q = query.shape[:2]
        len_v = value.shape[1]
        value = self.value_proj(value)
        if value_mask is not None:
            value = torch.where(value_mask[..., None], value, torch.zeros((), dtype=value.dtype, device=value.device))
        value = value.reshape(B, len_v, self.n_heads, self.d_model // self.n_heads)
        off = self.sampling_offsets(query).reshape(B, Q, self.n_heads, self.n_levels, self.n_points, 2)
        aw = self.attention_weights(query).reshape(B, Q, self.n_heads, self.n_levels * self.n_points)
        aw = aw.softmax(-1).reshape(B, Q, self.n_heads, self.n_levels, self.n_points)
        num_points = refer_bbox.shape[-1]
        if num_points == 2:
            norm = torch.tensor([[w, h] for (h, w) in value_shapes], dtype=torch.float32, device=query.device)
            loc = refer_bbox[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        elif num_points == 4:
            add = off / self.n_points * refer_bbox[:, :, None, :, None, 2:] * 0.5
            loc = refer_bbox[:, :, None, :, None, :2] + add
        else:
            raise ValueError(f"refer_bbox last dim must be 2 or 4, got {num_points}")
        return self.output_proj(multi_scale_deformable_attn(value, value_shapes, loc, aw))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each followed by a residual LayerNorm."""

    def __init__(self, d_model=256, n_heads=8, d_ffn=1024, dropout=0.0, n_levels=4, n_points=4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, embed, refer_bbox, feats, shapes, padding_mask=None, query_pos=None):
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed))
        qc = embed if query_pos is None else embed + query_pos
        embed = self.norm2(embed + self.cross_attn(qc, refer_bbox[:, :, None], feats, shapes, padding_mask))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


class DeformableTransformerDecoder(nn.Module):
    """Iterative box refinement: each layer refines the reference boxes through its bbox head."""

    def __init__(self, hidden_dim: int, decoder_layer_fn: Callable[[], nn.Module], num_layers: int,
                 eval_idx: int = -1):
        super().__init__()
        self.layers = nn.ModuleList([decoder_layer_fn() for _ in range(num_layers)])
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.eval_idx = eval_idx if eval_idx >= 0 else num_layers + eval_idx

    def init(self, seed: int = 0) -> "DeformableTransformerDecoder":
        """Draw the weights as the JAX decoder's init(KeyGen(seed)) does."""
        init_weights_(self, np.random.default_rng(seed))
        return self

    def forward(self, embed, refer_bbox, feats, shapes, bbox_heads=None, score_heads=None, pos_mlp=None,
                train: bool = False):
        """Returns the stacked (layers, B, Q, 4) boxes and (layers, B, Q, nc) logits: every layer's in train,
        the eval layer's alone otherwise."""
        refer_bbox = torch.sigmoid(refer_bbox)
        dec_bboxes, dec_cls = [], []
        last_refined = None
        out = embed
        for i, layer in enumerate(self.layers):
            qp = pos_mlp(refer_bbox) if pos_mlp is not None else None
            out = layer(out, refer_bbox, feats, shapes, None, qp)
            bbox = bbox_heads[i](out)
            refined = torch.sigmoid(bbox + inverse_sigmoid(refer_bbox))
            if train:
                dec_cls.append(score_heads[i](out))
                dec_bboxes.append(refined if i == 0 else torch.sigmoid(bbox + inverse_sigmoid(last_refined)))
            elif i == self.eval_idx:
                dec_cls.append(score_heads[i](out))
                dec_bboxes.append(refined)
                break
            last_refined = refined
            refer_bbox = refined.detach() if train else refined
        return torch.stack(dec_bboxes), torch.stack(dec_cls)
