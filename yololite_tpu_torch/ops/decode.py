"""Decode: raw Detect maps -> (boxes, scores) (port of yololite_tpu/ops/decode.py).

Public functions take the per-level maps in the JAX package's layout,
(B, H, W, 4*reg_max + nc), so tests compare like with like. The DFL
expectation carries the JAX package's hand-written backward (K5) for train;
its plain body `_dfl_mm_parts` lives beside the kernel in ops/loss_kernels.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from yololite_tpu_torch.ops import loss_kernels
from yololite_tpu_torch.ops.boxes import dist2bbox, make_anchors


def flatten_levels(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B,H,W,C)...] -> (B, sum(H*W), C) preserving level order."""
    return torch.cat([f.reshape(f.shape[0], -1, f.shape[-1]) for f in feats], 1)


def dfl_expectation_mm(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4*reg_max) -> (..., 4) fp32: the expected bin under each side's softmax.

    Each side is shifted by its own max before exp, so a side far below
    another side's logits cannot underflow to 0/0. K5: ops/loss_kernels.py
    `dfl_expectation` (csrc/dfl.cu on the card, with or without a gradient to
    take), differentiable with the closed-form backward dE/dx_j = softmax_j *
    (j - E) per side, returned in the logits' dtype (bf16 under amp).
    """
    return loss_kernels.dfl_expectation(box_logits, reg_max)


def decode_detections(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    xywh: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode per-level (B, H, W, no) maps -> boxes (B, A, 4) fp32 pixels, scores (B, A, nc) sigmoid."""
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchors, stride_t = make_anchors(shapes, strides, 0.5, device=feats[0].device)
    x = flatten_levels(feats)
    box_logits, cls_logits = x[..., : 4 * reg_max], x[..., 4 * reg_max :]
    dist = dfl_expectation_mm(box_logits, reg_max)
    boxes = dist2bbox(dist, anchors[None], xywh=xywh) * stride_t[None]
    return boxes, torch.sigmoid(cls_logits)


def postprocess_end2end(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    max_det: int = 300,
    conf_thres: float = 0.0,
) -> torch.Tensor:
    """NMS-free top-k select over one2one maps -> (B, max_det, 6) [x1, y1, x2, y2, conf, cls].

    (1) keep the max_det anchors with the highest per-anchor max class score,
    (2) flat top-k over their (anchor x class) scores. Rows at or under
    conf_thres are zeroed. Ties go to the lower index, as lax.top_k.
    """
    from yololite_tpu_torch.ops.nms import topk_stable

    boxes, scores = decode_detections(feats, strides, nc, reg_max, xywh=False)
    scores = scores.float()
    k = min(max_det, scores.shape[1])
    _, idx = topk_stable(scores.amax(-1), k)  # (B, k)
    sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    sel_scores = torch.gather(scores, 1, idx[..., None].expand(-1, -1, nc))
    conf, fidx = topk_stable(sel_scores.flatten(1), k)
    cls = (fidx % nc).float()
    out_boxes = torch.gather(sel_boxes, 1, (fidx // nc)[..., None].expand(-1, -1, 4))
    rows = torch.cat([out_boxes, conf[..., None], cls[..., None]], -1)
    return torch.where((conf > conf_thres)[..., None], rows, torch.zeros_like(rows))
