"""Decode: raw Detect maps -> (boxes, scores) (port of yololite_tpu/ops/decode.py).

Public functions take the per-level maps in the JAX package's layout,
(B, H, W, 4*reg_max + nc), so tests compare like with like. The DFL
expectation carries the JAX package's hand-written backward (K5) for train.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from yololite_tpu_torch.ops.boxes import dist2bbox, make_anchors


def flatten_levels(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B,H,W,C)...] -> (B, sum(H*W), C) preserving level order."""
    return torch.cat([f.reshape(f.shape[0], -1, f.shape[-1]) for f in feats], 1)


def _dfl_mm_parts(box_logits: torch.Tensor, reg_max: int):
    """Forward body: the expectation E (..., 4) and each side's max m and sum of exp z."""
    x = box_logits.float().unflatten(-1, (4, reg_max))
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    z = e.sum(-1)
    return (e * proj).sum(-1) / z, m, z


class DFLExpectation(torch.autograd.Function):
    """K5: the DFL expectation with its closed-form backward (port of the JAX custom vjp).

    dE/dx_j = softmax_j * (proj_j - E) per side, one elementwise pass over the
    (..., 4*reg_max) logits, returned in the logits' dtype (bf16 under amp).
    """

    calls = 0  # forward calls with a gradient to take, since the last reset

    @staticmethod
    def forward(ctx, box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
        out, m, z = _dfl_mm_parts(box_logits, reg_max)
        ctx.save_for_backward(box_logits, m, z, out)
        ctx.reg_max = reg_max
        DFLExpectation.calls += 1
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, m, z, out = ctx.saved_tensors
        r = ctx.reg_max
        xs = x.float().unflatten(-1, (4, r))
        sm = torch.exp(xs - m) / z[..., None]
        proj = torch.arange(r, dtype=torch.float32, device=x.device)
        dx = sm * (proj - out[..., None]) * g.float()[..., None]
        return dx.flatten(-2).to(x.dtype), None


def dfl_expectation_mm(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4*reg_max) -> (..., 4) fp32: the expected bin under each side's softmax.

    Each side is shifted by its own max before exp, so a side far below
    another side's logits keeps exp(0) = 1 in its denominator and cannot
    underflow to 0/0. With a gradient to take, it runs as `DFLExpectation`
    (same forward bits, closed-form backward).
    """
    if box_logits.requires_grad and torch.is_grad_enabled():
        return DFLExpectation.apply(box_logits, reg_max)
    return _dfl_mm_parts(box_logits, reg_max)[0]


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
