"""Oriented bounding box (OBB) math on xywhr boxes: port of yololite_tpu/ops/rotated.py.

probiou (the Bhattacharyya-distance IoU of the boxes' Gaussians), corner
conversion, rotated fast-NMS, the rotated distance decode and the rotated
task-aligned assigner. The math follows the JAX package's operation order.

`nms_rotated` is a fast-NMS (each box is dropped when any higher-scored box
overlaps it past the threshold, suppressed or not), not a greedy keep, so it
does not go through the greedy-keep kernel.
"""

from __future__ import annotations

import math

import torch

from yololite_tpu_torch.ops.nms import topk_stable
from yololite_tpu_torch.utils.tal import TaskAlignedAssigner


def _covariance(boxes: torch.Tensor):
    """Gaussian covariance terms (a, b, c) of xywhr boxes."""
    w2 = boxes[..., 2] ** 2 / 12
    h2 = boxes[..., 3] ** 2 / 12
    r = boxes[..., 4]
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos**2, sin**2
    return w2 * cos2 + h2 * sin2, w2 * sin2 + h2 * cos2, (w2 - h2) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU of broadcastable xywhr boxes (with CIoU, less the aspect term)."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _covariance(obb1)
    a2, b2, c2 = _covariance(obb2)

    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    t3 = torch.log(
        ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
        / (4 * torch.sqrt((a1 * b1 - c1**2).clamp(min=0) * (a2 * b2 - c2**2).clamp(min=0)) + eps)
        + eps
    ) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    iou = 1 - hd
    if CIoU:
        w1, h1 = obb1[..., 2], obb1[..., 3]
        w2, h2 = obb2[..., 2], obb2[..., 3]
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou


def batch_probiou(obb1, obb2, eps: float = 1e-7) -> torch.Tensor:
    """(N, 5) x (M, 5) xywhr -> (N, M) probabilistic IoU matrix."""
    obb1, obb2 = torch.as_tensor(obb1), torch.as_tensor(obb2)
    return probiou(obb1[:, None, :], obb2[None, :, :], eps=eps)


def xywhr2xyxyxyxy(x: torch.Tensor) -> torch.Tensor:
    """xywhr -> the 4 corner points (..., 4, 2)."""
    ctr = x[..., :2]
    w, h, angle = x[..., 2:3], x[..., 3:4], x[..., 4:5]
    cos, sin = torch.cos(angle), torch.sin(angle)
    vec1 = torch.cat([w / 2 * cos, w / 2 * sin], -1)
    vec2 = torch.cat([-h / 2 * sin, h / 2 * cos], -1)
    return torch.stack([ctr + vec1 + vec2, ctr + vec1 - vec2, ctr - vec1 - vec2, ctr - vec1 + vec2], dim=-2)


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, threshold: float = 0.45, max_det: int = 300):
    """Fast-NMS over (N, 5) xywhr boxes and (N,) scores, fixed-shape.

    Returns (keep_idx (min(max_det, N),), valid (min(max_det, N),)): the kept
    boxes by descending score (ties to the lower index, as the JAX package's
    stable argsort and lax.top_k order them), then the dropped ones, invalid.
    """
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    ious = probiou(b[:, None, :], b[None, :, :])
    idx = torch.arange(n, device=boxes.device)
    triu = idx[:, None] < idx[None, :]
    max_iou = torch.where(triu, ious, torch.zeros((), dtype=ious.dtype, device=ious.device)).amax(0)
    keep = max_iou < threshold
    ranked = torch.where(keep, scores[order], torch.full((), -1.0, dtype=scores.dtype, device=scores.device))
    vals, pick = topk_stable(ranked, min(max_det, n))
    return order[pick], vals > 0


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """Decode rotated boxes (xywh with the angle kept apart) from ltrb distances, an angle and the anchors."""
    lt, rb = pred_dist[..., :2], pred_dist[..., 2:4]
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf = (rb - lt)[..., 0:1] / 2
    yf = (rb - lt)[..., 1:2] / 2
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


class RotatedTaskAlignedAssigner(TaskAlignedAssigner):
    """TAL on xywhr GTs: probiou overlaps and the corner-projection candidate test."""

    def _get_box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, mask):
        labels = gt_labels.squeeze(-1).long().clamp(min=0)  # (B, M)
        bbox_scores = torch.gather(pd_scores.float().transpose(1, 2), 1,
                                   labels[..., None].expand(-1, -1, pd_scores.shape[1])) * mask
        iou = probiou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
        overlaps = torch.where(mask > 0, iou.clamp(min=0), torch.zeros((), device=iou.device))
        return bbox_scores**self.alpha * overlaps**self.beta, overlaps

    def _get_pos_mask(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, anc_points, mask_gt):
        mask_in_gts = select_candidates_in_rotated_gts(anc_points, gt_bboxes).to(pd_scores.dtype)
        valid = mask_in_gts * mask_gt
        align_metric, overlaps = self._get_box_metrics(pd_scores, pd_bboxes, gt_labels, gt_bboxes, valid)
        mask_topk = self._select_topk_candidates(align_metric, mask_gt)
        return mask_topk * mask_in_gts * mask_gt, align_metric, overlaps

    def _get_targets(self, gt_labels, gt_bboxes, target_gt_idx, fg_mask):
        labels = gt_labels.squeeze(-1).long().clamp(min=0)
        target_labels = torch.gather(labels, 1, target_gt_idx)
        target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1]))
        one_hot = torch.nn.functional.one_hot(target_labels, self.num_classes).to(gt_bboxes.dtype)
        target_scores = torch.where((fg_mask > 0)[..., None], one_hot, torch.zeros((), dtype=gt_bboxes.dtype,
                                                                                    device=gt_bboxes.device))
        return target_labels, target_bboxes, target_scores


def select_candidates_in_rotated_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9):
    """(A, 2) points x (B, M, 5) xywhr GTs -> (B, M, A) bool: the point lies in the rotated box (edges included)."""
    corners = xywhr2xyxyxyxy(gt_bboxes)  # (B, M, 4, 2)
    a = corners[..., 0, :][..., None, :]  # (B, M, 1, 2)
    b = corners[..., 1, :][..., None, :]
    d = corners[..., 3, :][..., None, :]
    ab = b - a
    ad = d - a
    ap = xy_centers[None, None] - a  # (B, M, A, 2)
    norm_ab = (ab * ab).sum(-1)
    norm_ad = (ad * ad).sum(-1)
    ap_dot_ab = (ap * ab).sum(-1)
    ap_dot_ad = (ap * ad).sum(-1)
    return (ap_dot_ab >= 0) & (ap_dot_ab <= norm_ab) & (ap_dot_ad >= 0) & (ap_dot_ad <= norm_ad)
