"""v8 detection loss: BCE classes + CIoU boxes + DFL (port of yololite_tpu/utils/loss.py).

Targets arrive padded to a static (B, M) block (`build_targets`, on the host).
The loss reads the Detect maps in the JAX package's layout, NHWC flattened to
(B, A, no), and runs its math in fp32 whatever the maps' dtype; on the amp
path the (B, A, nc) target scores stay bf16, as in the JAX package, and the
two hand-written backwards (K6a `dfl_ce_mean`, K6b `bce_sum`: kernels beside
their plain versions in ops/loss_kernels.py) return their gradients in the
logits' dtype.

The box and DFL terms take the JAX package's default, the compact form
(`COMPACT_BOX_LOSS`), wherever it does (topk * M < A): K9 (`compact_rows`)
gathers the at most topk * M foreground rows of the DFL logits, foreground
rows first, and decode (K5), CIoU, bbox2dist and the DFL cross-entropy (K6a)
run on those (B, K) rows; the dense decode then only feeds the assigner and
takes no gradient. Elsewhere, and with COMPACT_BOX_LOSS False, they run in
the dense form over all A anchors with the non-foreground rows weighted 0.
The two forms give the same terms and gradients; only the order of the
loss's sums differs (tests/test_torch_compact_loss.py).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yololite_tpu_torch.ops.boxes import bbox2dist, bbox_iou, dist2bbox, make_anchors, xywh2xyxy
from yololite_tpu_torch.ops.decode import dfl_expectation_mm, flatten_levels
from yololite_tpu_torch.ops.loss_kernels import bce_sum, compact_rows, dfl_ce_mean
from yololite_tpu_torch.utils import LOGGER
from yololite_tpu_torch.utils.tal import TaskAlignedAssigner


_TRUNC_WARNED = False  # warn once per process on GT truncation

# The box and DFL terms' form, as the JAX package's constant of the same name: True takes the compact form wherever
# topk * M < A (every dropped row has weight 0: the assigner's dedup keeps the foreground within topk * M rows),
# False the dense form everywhere
COMPACT_BOX_LOSS = True


def build_targets(batch: Dict, batch_size: int, imgsz: Tuple[int, int], max_gt: int) -> Dict[str, np.ndarray]:
    """Host side: ragged (batch_idx, cls, normalized xywh) -> padded arrays.

    Returns gt_labels (B, M, 1) int32, gt_bboxes (B, M, 4) xyxy pixels and
    mask_gt (B, M, 1) float32. Boxes past max_gt in one image are dropped
    (warned once per process).
    """
    bi = np.asarray(batch["batch_idx"]).reshape(-1).astype(int)
    cls = np.asarray(batch["cls"]).reshape(-1)
    boxes = np.asarray(batch["bboxes"]).reshape(-1, 4)
    h, w = imgsz
    gt_labels = np.zeros((batch_size, max_gt, 1), np.int32)
    gt_bboxes = np.zeros((batch_size, max_gt, 4), np.float32)
    mask_gt = np.zeros((batch_size, max_gt, 1), np.float32)
    counts = np.bincount(bi, minlength=batch_size) if len(bi) else np.zeros(batch_size, int)
    global _TRUNC_WARNED
    if counts.max(initial=0) > max_gt and not _TRUNC_WARNED:
        _TRUNC_WARNED = True
        LOGGER.warning(f"build_targets: an image carries {int(counts.max())} GT boxes, more than max_gt={max_gt}; "
                       "the boxes past it are dropped for this batch")
    for b in range(batch_size):
        sel = np.nonzero(bi == b)[0][:max_gt]
        n = len(sel)
        if n:
            gt_labels[b, :n, 0] = cls[sel]
            xyxy = xywh2xyxy(boxes[sel] * np.array([w, h, w, h], np.float32))
            gt_bboxes[b, :n] = xyxy
            mask_gt[b, :n, 0] = (xyxy.sum(-1) > 0).astype(np.float32)
    return {"gt_labels": gt_labels, "gt_bboxes": gt_bboxes, "mask_gt": mask_gt}


class v8DetectionLoss:
    """`loss(feats, targets)` -> (total, loss_items): total = loss_items.sum() * batch size, the value backward takes."""

    def __init__(self, nc: int, strides: Sequence[int], reg_max: int = 16, hyp=None, tal_topk: int = 10):
        self.nc = nc
        self.strides = list(strides)
        self.reg_max = reg_max
        self.no = nc + reg_max * 4
        self.use_dfl = reg_max > 1
        self.hyp_box = float(getattr(hyp, "box", 7.5))
        self.hyp_cls = float(getattr(hyp, "cls", 0.5))
        self.hyp_dfl = float(getattr(hyp, "dfl", 1.5))
        self.assigner = TaskAlignedAssigner(topk=tal_topk, num_classes=nc, alpha=0.5, beta=6.0)

    def compact_k(self, m: int, a: int) -> Optional[int]:
        """K = topk * M, the rows the compact box/DFL form keeps at M padded GTs and A anchors, or None where the loss
        runs the dense form (COMPACT_BOX_LOSS False, or topk * M >= A): yololite_tpu/utils/loss.py:162's rule."""
        k = self.assigner.topk * m
        return k if COMPACT_BOX_LOSS and k < a else None

    def bbox_decode(self, anchor_points: torch.Tensor, pred_dist: torch.Tensor) -> torch.Tensor:
        """DFL expectation (K5) -> xyxy boxes in anchor (stride) units, fp32."""
        dist = dfl_expectation_mm(pred_dist, self.reg_max) if self.use_dfl else pred_dist.float()
        return dist2bbox(dist, anchor_points, xywh=False)

    def __call__(self, feats: List[torch.Tensor], targets: Dict[str, torch.Tensor]):
        """feats: per-level (B, H, W, no) NHWC maps; targets: the padded tensors of `build_targets`."""
        total, items, _ = self.forward(feats, targets)
        return total, items

    def forward(self, feats: List[torch.Tensor], targets: Dict[str, torch.Tensor], group=None):
        """Like __call__, plus the assigner's fg_mask (B, A).

        With a process group, feats and targets are this rank's equal slice of
        the global batch: the loss divides by the global target_scores_sum (a
        detached all_reduce) and scales by the global batch size, so the
        ranks' totals, and their gradients, sum to the one-device ones.
        """
        shapes = [(f.shape[1], f.shape[2]) for f in feats]
        x = flatten_levels(feats)  # (B, A, no)
        pred_distri, pred_scores = x[..., : self.reg_max * 4], x[..., self.reg_max * 4:]
        amp = pred_scores.dtype == torch.bfloat16
        batch_size = pred_scores.shape[0]
        anchor_points, stride_tensor = make_anchors(shapes, self.strides, 0.5, device=x.device)
        gt_labels, gt_bboxes, mask_gt = targets["gt_labels"], targets["gt_bboxes"], targets["mask_gt"]

        M, A = gt_labels.shape[1], pred_distri.shape[1]
        K = self.compact_k(M, A)
        compact = K is not None
        with torch.no_grad() if compact else contextlib.nullcontext():  # compact: the dense decode feeds the assigner
            pred_bboxes = self.bbox_decode(anchor_points, pred_distri)  # (B, A, 4) anchor units, fp32
        _, target_bboxes, target_scores, fg_mask, _ = self.assigner(
            torch.sigmoid(pred_scores.detach()),
            (pred_bboxes.detach() * stride_tensor).to(gt_bboxes.dtype),
            anchor_points * stride_tensor,
            gt_labels,
            gt_bboxes,
            mask_gt,
        )
        # under amp the (B, A, nc) targets are held in bf16; every sum below is fp32
        target_scores = target_scores.to(torch.bfloat16 if amp else torch.float32)
        target_scores_sum = target_scores.float().sum()
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(target_scores_sum, group=group)
            batch_size *= dist.get_world_size(group)
        target_scores_sum = torch.clamp(target_scores_sum, min=1)

        loss_cls = bce_sum(pred_scores, target_scores) / target_scores_sum

        fg = fg_mask.float()  # (B, A)
        target_bboxes = target_bboxes.float() / stride_tensor
        weight = target_scores.float().sum(-1) * fg  # (B, A)
        if compact:  # K9: the (B, K) rows, foreground first; the rows left out weigh 0
            pred_distri, idx = compact_rows(pred_distri, fg_mask, K)
            anchor_points = anchor_points[idx]  # (B, K, 2)
            target_bboxes = torch.gather(target_bboxes, 1, idx[..., None].expand(-1, -1, 4))
            weight = torch.gather(weight, 1, idx)
            pred_bboxes = self.bbox_decode(anchor_points, pred_distri)
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)
        loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
        if self.use_dfl:
            target_ltrb = bbox2dist(anchor_points, target_bboxes, self.reg_max - 1)
            df = dfl_ce_mean(pred_distri, target_ltrb).squeeze(-1)
            loss_dfl = (df * weight).sum() / target_scores_sum
        else:
            loss_dfl = torch.zeros((), device=x.device)

        loss_items = torch.stack([loss_box * self.hyp_box, loss_cls * self.hyp_cls, loss_dfl * self.hyp_dfl])
        return loss_items.sum() * batch_size, loss_items.detach(), fg_mask


class E2EDetectLoss:
    """One-to-many (top-10) plus one-to-one (top-1) loss pair for end2end heads.

    Takes the {"one2many": [maps], "one2one": [maps]} dict of Detect(end2end=True)
    and sums the two branches' totals and items.
    """

    def __init__(self, nc: int, strides: Sequence[int], reg_max: int = 16, hyp=None):
        self.one2many = v8DetectionLoss(nc, strides, reg_max, hyp=hyp, tal_topk=10)
        self.one2one = v8DetectionLoss(nc, strides, reg_max, hyp=hyp, tal_topk=1)

    def __call__(self, preds, targets: Dict[str, torch.Tensor]):
        total, items, _ = self.forward(preds, targets)
        return total, items

    def forward(self, preds, targets: Dict[str, torch.Tensor], group=None):
        total_m, items_m, fg = self.one2many.forward(preds["one2many"], targets, group)
        total_o, items_o, _ = self.one2one.forward(preds["one2one"], targets, group)
        return total_m + total_o, items_m + items_o, fg
