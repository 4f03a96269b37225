"""Task-aligned assigner on fixed-shape tensors (port of yololite_tpu/utils/tal.py).

GT boxes arrive padded to a static M with a mask_gt flag:
  - candidate anchors: centre strictly inside the GT box;
  - align metric score[gt class]^alpha * CIoU^beta on the (B, M, A) grid, masked;
  - top-k anchors per GT (K7), value descending with ties to the lowest index;
  - anchors claimed by several GTs keep the GT of highest CIoU;
  - target scores normalized by each GT's peak metric, scaled to its peak CIoU.

The JAX package's blocked top-k forms and one-hot matmul gathers exist only
to avoid slow sorts and row gathers on the TPU; here the top-k is K7
(ops/loss_kernels.py `topk_rows`: csrc/topk_rows.cu on the card, a stable
sort on the CPU) and the gathers are direct, with the same values and
indices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yololite_tpu_torch.ops.boxes import bbox_iou
from yololite_tpu_torch.ops.loss_kernels import topk_rows


def _pow_const(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p for the assigner's static exponents, as the JAX package computes it.

    0.5 is a sqrt and an integer power up to 8 a square-and-multiply chain,
    in the same order, so the metric has the same bits.
    """
    if p == 1.0:
        return x
    if p == 0.5:
        return torch.sqrt(x)
    if float(p).is_integer() and 1 < p <= 8:
        n, out, base = int(p), None, x
        while n:
            if n & 1:
                out = base if out is None else out * base
            n >>= 1
            if n:
                base = base * base
        return out
    return x**p


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) centres x (B, M, 4) xyxy -> (B, M, A) bool: centre strictly inside the box."""
    lt = gt_bboxes[..., None, :2]  # (B, M, 1, 2)
    rb = gt_bboxes[..., None, 2:4]
    deltas = torch.cat([xy_centers[None, None] - lt, rb - xy_centers[None, None]], -1)
    return deltas.amin(-1) > eps


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor, n_max_boxes: int):
    """Resolve anchors claimed by several GTs by keeping the GT of highest overlap.

    mask_pos, overlaps: (B, M, A). Returns target_gt_idx (B, A), fg_mask (B, A) and mask_pos.
    """
    fg_mask = mask_pos.sum(-2)  # (B, A)
    mask_multi = fg_mask[:, None, :] > 1  # (B, 1, A)
    max_overlaps_idx = overlaps.argmax(1)  # (B, A), first maximum
    is_max = torch.nn.functional.one_hot(max_overlaps_idx, n_max_boxes).permute(0, 2, 1).to(mask_pos.dtype)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    target_gt_idx = mask_pos.argmax(-2)  # (B, A), first maximum: GT 0 where none
    return target_gt_idx, fg_mask, mask_pos


class TaskAlignedAssigner:
    """Functional TAL assigner over padded GTs: `assigner(...)` returns the per-anchor targets."""

    def __init__(self, topk: int = 13, num_classes: int = 80, alpha: float = 1.0, beta: float = 6.0,
                 eps: float = 1e-9):
        self.topk = topk
        self.num_classes = num_classes
        self.bg_idx = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    @torch.no_grad()
    def __call__(
        self,
        pd_scores: torch.Tensor,  # (B, A, nc) sigmoid scores
        pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy, image pixels
        anc_points: torch.Tensor,  # (A, 2)
        gt_labels: torch.Tensor,  # (B, M, 1) int
        gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy
        mask_gt: torch.Tensor,  # (B, M, 1) 0/1
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns target_labels (B, A), target_bboxes (B, A, 4), target_scores (B, A, nc),
        fg_mask (B, A) bool and target_gt_idx (B, A)."""
        B, A, nc = pd_scores.shape
        M = gt_bboxes.shape[1]
        if M == 0:
            dev = pd_scores.device
            return (torch.full((B, A), self.bg_idx, dtype=torch.int64, device=dev), torch.zeros_like(pd_bboxes),
                    torch.zeros_like(pd_scores), torch.zeros((B, A), dtype=torch.bool, device=dev),
                    torch.zeros((B, A), dtype=torch.int64, device=dev))

        mask_pos, align_metric, overlaps = self._get_pos_mask(pd_scores, pd_bboxes, gt_labels, gt_bboxes, anc_points,
                                                              mask_gt)
        target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, M)
        target_labels, target_bboxes, target_scores = self._get_targets(gt_labels, gt_bboxes, target_gt_idx, fg_mask)

        # normalize target scores by each GT's peak metric, scaled to its peak overlap
        align_metric = align_metric * mask_pos
        pos_align_metrics = align_metric.amax(-1, keepdim=True)  # (B, M, 1)
        pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)  # (B, M, 1)
        norm_align_metric = (align_metric * pos_overlaps / (pos_align_metrics + self.eps)).amax(-2)[..., None]
        target_scores = target_scores * norm_align_metric
        return target_labels, target_bboxes, target_scores, fg_mask > 0, target_gt_idx

    def _get_pos_mask(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, anc_points, mask_gt):
        mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes).float()  # (B, M, A)
        valid = mask_in_gts * mask_gt.float()
        align_metric, overlaps = self._get_box_metrics(pd_scores, pd_bboxes, gt_labels, gt_bboxes, valid)
        mask_topk = self._select_topk_candidates(align_metric, mask_gt)
        mask_pos = mask_topk * mask_in_gts * mask_gt
        return mask_pos, align_metric, overlaps

    def _get_box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, mask):
        """align = score[gt class]^alpha * CIoU^beta, zero outside the mask; all fp32."""
        labels = gt_labels.squeeze(-1).long().clamp(min=0)  # (B, M)
        # score of each GT's class at every anchor: (B, A, nc) gathered to (B, M, A)
        bbox_scores = torch.gather(pd_scores.float().transpose(1, 2), 1,
                                   labels[..., None].expand(-1, -1, pd_scores.shape[1]))
        bbox_scores = bbox_scores * mask
        iou = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :].float(), xywh=False, CIoU=True)
        overlaps = torch.where(mask > 0, iou.clamp(min=0), torch.zeros((), device=iou.device))
        align_metric = _pow_const(bbox_scores, self.alpha) * _pow_const(overlaps, self.beta)
        return align_metric, overlaps

    def _select_topk_candidates(self, metrics: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
        """Top-k anchors per GT as a (B, M, A) 0/1 mask, with the JAX package's count rule.

        Masked GT rows point all k picks at anchor 0; the count of picks per
        anchor is then k there, and a count above 1 is dropped to 0.
        """
        _, topk_idxs = topk_rows(metrics, self.topk)  # (B, M, k): K7
        topk_idxs = torch.where(mask_gt > 0, topk_idxs, 0)
        count = torch.zeros_like(metrics, dtype=torch.int32).scatter_add_(
            -1, topk_idxs, torch.ones_like(topk_idxs, dtype=torch.int32))
        count = torch.where(count > 1, 0, count)
        return count.to(metrics.dtype)

    def _get_targets(self, gt_labels, gt_bboxes, target_gt_idx, fg_mask):
        """Per-anchor GT lookup: label, box and one-hot class score of the assigned GT."""
        labels = gt_labels.squeeze(-1).long().clamp(min=0)  # (B, M)
        target_labels = torch.gather(labels, 1, target_gt_idx)  # (B, A)
        target_bboxes = torch.gather(gt_bboxes.float(), 1, target_gt_idx[..., None].expand(-1, -1, 4))
        target_scores = torch.nn.functional.one_hot(target_labels, self.num_classes).float()
        target_scores = torch.where((fg_mask > 0)[..., None], target_scores, 0.0)
        return target_labels, target_bboxes, target_scores
