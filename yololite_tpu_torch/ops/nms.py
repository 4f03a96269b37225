"""Batched non-max suppression on the device (port of yololite_tpu/ops/nms.py).

Fixed-shape output: a padded (B, max_det, 6) tensor [x1, y1, x2, y2, conf, cls]
with conf == 0 marking empty rows. Greedy order matches torchvision
(score-descending, suppress IoU > threshold, class-offset trick).

Exact keeps with K <= 1024 go through `ops.kernels.greedy_nms_keep`, boxes in
and keep mask out: the CUDA kernel K1 for tensors on the card (it computes
the IoU itself), its plain version on the CPU; `_finalize` then compacts the
kept rows. Exact NMS with K > 1024 goes through
`ops.kernels.blocked_nms_finalize`, keep and compaction in one: on the card
the kernel K4 (one launch, no host sync), on the CPU its plain version, the
score-ordered blocks of 1024 of `_blocked_keep` and then `_finalize`.
Selection follows lax.top_k's rule, lowest index first among equal scores
(`topk_stable`). `nms_from_feats`'s steps 1-4 (select and decode over the
raw Detect maps) are one `ops.kernels.select_decode` call: the kernel K3 on
the card, its plain version on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from yololite_tpu_torch.ops.boxes import box_iou
from yololite_tpu_torch.ops.kernels import (MAX_WH, blocked_nms_finalize, greedy_nms_keep, greedy_nms_keep_plain,
                                           select_decode, topk_stable)

KERNEL_MAX_K = 1024  # largest K one greedy_nms_keep call takes; exact NMS above it runs blocked_nms_finalize


def _fixpoint_keep(shifted: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain exact greedy keep over (B, K, 4) class-offset boxes, on any device."""
    return greedy_nms_keep_plain(shifted, valid, iou_thres)


def _exact_keep(shifted: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Exact greedy keep over (B, K <= 1024, 4) class-offset boxes: the kernel on CUDA, plain on CPU.

    The kernel computes the IoU itself, so no (B, K, K) tensor is made here.
    """
    return greedy_nms_keep(shifted.float().contiguous(), valid.contiguous(), iou_thres)


def _fast_keep(shifted: torch.Tensor, valid: torch.Tensor, iou_thres: float, chunk: int = 1024) -> torch.Tensor:
    """One-shot matrix NMS (Fast-NMS): suppressed boxes still suppress others.

    Column max of the upper-triangular IoU over valid rows, taken in row
    chunks so a large K never materializes the whole (K, K) matrix.
    """
    b, k = valid.shape
    s = shifted.float()
    idx = torch.arange(k, device=s.device)
    max_iou = torch.zeros((b, k), dtype=torch.float32, device=s.device)
    for base in range(0, k, chunk):
        rows = box_iou(s[:, base:base + chunk], s)  # (B, chunk, K)
        tri = (idx[base:base + chunk, None] < idx[None, :])[None] & valid[:, base:base + chunk, None]
        max_iou = torch.maximum(max_iou, torch.where(tri, rows, 0.0).amax(1))
    return valid & (max_iou <= iou_thres)


def _blocked_keep(shifted: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                  block: int = KERNEL_MAX_K) -> torch.Tensor:
    """Exact greedy keep for large K via score-ordered blocks.

    Candidates arrive score-sorted, so greedy decomposes exactly: resolve one
    block with the exact keep (given the incoming alive mask), then drop every
    later candidate that a kept item of this block suppresses with one dense
    (block, K_rest) IoU pass, and move on. Blocks with nothing alive are skipped.

    A K that is not a multiple of the block is padded up to one with invalid
    zero boxes, which are never kept and never suppress, and the keep is cut
    back to K: ceil(K / block) blocks, where the JAX package halves the block
    until it divides K (105 blocks of 64 at K = 6720). Same keep, bit for bit.
    Each alive block costs one host sync (the skip test), one exact keep and
    one cross pass. The plain path of K4 (`blocked_nms_finalize`): the CPU
    runs it, the card never does.
    """
    b, k = valid.shape
    block = min(block, k)
    pad = -k % block
    s = shifted.float()
    if pad:
        s = torch.cat([s, s.new_zeros((b, pad, 4))], 1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], 1)
    keep = torch.zeros_like(valid)
    alive = valid.clone()
    for lo in range(0, k + pad, block):
        hi = lo + block
        alive_seg = alive[:, lo:hi]
        if not bool(alive_seg.any()):
            continue
        kb = _exact_keep(s[:, lo:hi], alive_seg, iou_thres)
        keep[:, lo:hi] = kb
        if hi < k:  # the padding rows past K need no suppressing
            cross = box_iou(s[:, lo:hi], s[:, hi:k])  # (B, block, K_rest)
            alive[:, hi:k] &= ~(kb[:, :, None] & (cross > iou_thres)).any(1)
    return keep[:, :k]


def _keep(shifted: torch.Tensor, valid: torch.Tensor, iou_thres: float, mode: str) -> torch.Tensor:
    """Keep mask by mode: 'greedy' and 'pallas' are exact greedy, 'fast' is Fast-NMS."""
    if mode == "fast":
        return _fast_keep(shifted, valid, iou_thres)
    if mode not in ("greedy", "pallas"):
        raise ValueError(f"unknown NMS mode {mode!r}; use 'greedy', 'pallas' or 'fast'")
    if shifted.shape[1] <= KERNEL_MAX_K:
        return _exact_keep(shifted, valid, iou_thres)
    return _blocked_keep(shifted, valid, iou_thres)


def _suppress(cand_boxes, vals, cls, shifted, valid, iou_thres: float, max_det: int, mode: str) -> torch.Tensor:
    """Keep and compaction -> (B, max_det, 6): exact NMS over K > 1024 as one `blocked_nms_finalize` (K4 on the
    card), every other case as the keep mask of `_keep` and then `_finalize`."""
    if mode in ("greedy", "pallas") and shifted.shape[1] > KERNEL_MAX_K:
        return blocked_nms_finalize(shifted.float().contiguous(), cand_boxes.float().contiguous(),
                                    vals.float().contiguous(), cls.float().contiguous(), valid.contiguous(),
                                    iou_thres, max_det)
    return _finalize(cand_boxes, vals, cls, _keep(shifted, valid, iou_thres, mode), max_det)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, C), idx (B, K) -> (B, K, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _select_candidates(boxes, scores, conf_thres, max_cand, multi_label, class_mask):
    """Gate + top-K candidate selection -> (vals, boxes_k, cls, valid), all (B, K[, 4])."""
    b, a, nc = scores.shape
    if class_mask is not None:
        scores = torch.where(class_mask, scores, 0.0)
    if multi_label and nc > 1:
        k = min(max_cand, a * nc)
        flat = scores.reshape(b, -1)
        vals, fidx = topk_stable(torch.where(flat > conf_thres, flat, -1.0), k)
        bidx = fidx // nc
        cls = (fidx % nc).float()
    else:
        k = min(max_cand, a)
        conf = scores.amax(-1)
        vals, bidx = topk_stable(torch.where(conf > conf_thres, conf, -1.0), k)
        cls = torch.gather(scores.argmax(-1), 1, bidx).float()
    valid = vals > max(conf_thres, 0.0)
    return vals, _gather_rows(boxes, bidx), cls, valid


def _finalize(cand_boxes, vals, cls, keep, max_det):
    """Emit the kept candidates, in order, as a padded (B, max_det, 6) block.

    Candidates arrive score-descending and suppression never reorders, so each
    kept row goes to rank cumsum(keep) - 1; rows past max_det are dropped.
    """
    b = keep.shape[0]
    keep = keep & (vals > 0)
    pos = keep.long().cumsum(-1) - 1
    pos = torch.where(keep & (pos < max_det), pos, max_det)  # overflow -> the dropped row
    rows = torch.cat([cand_boxes.float(), vals.float()[..., None], cls.float()[..., None]], -1)
    out = torch.zeros((b, max_det + 1, 6), dtype=torch.float32, device=rows.device)
    out.scatter_(1, pos[..., None].expand(-1, -1, 6), rows)
    return out[:, :max_det]


def non_max_suppression(
    boxes: torch.Tensor,  # (B, A, 4) xyxy, input-image pixels
    scores: torch.Tensor,  # (B, A, nc) sigmoid probabilities
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_cand: int = 1024,
    multi_label: bool = False,
    agnostic: bool = False,
    class_mask: Optional[torch.Tensor] = None,
    mode: str = "greedy",
) -> torch.Tensor:
    """Batched class-aware NMS -> (B, max_det, 6) padded detections.

    mode: 'greedy' (exact torchvision semantics), 'pallas' (the same exact keep;
    the name of the JAX package's kernel mode), 'fast' (one-shot matrix NMS,
    slightly over-suppresses).
    """
    vals, cand_boxes, cls, valid = _select_candidates(boxes, scores, conf_thres, max_cand, multi_label, class_mask)
    offset = torch.zeros_like(cls) if agnostic else cls * MAX_WH
    return _suppress(cand_boxes, vals, cls, cand_boxes + offset[..., None], valid, iou_thres, max_det, mode)


def select_from_feats(feats: Sequence[torch.Tensor], nc: int, reg_max: int, conf_thres: float, max_cand: int,
                      class_mask: Optional[torch.Tensor] = None, half: bool = False, multi_label: bool = False):
    """Steps 1-2 of nms_from_feats: gate and select the top-K candidates (through `select_decode`).

    Scores are the sigmoid of the class logits (max/argmax over the sigmoid,
    not the logits). Returns vals (B, K) in the scores' dtype, the anchor
    index bidx (B, K) and the class cls (B, K) float32, in lax.top_k's order
    over the anchors of all levels (or over anchor x class with multi_label).
    """
    strides = [1] * len(feats)  # any: they scale only the boxes, which are not returned
    vals, bidx, cls = select_decode(feats, strides, nc, reg_max, conf_thres, max_cand, class_mask, half,
                                    multi_label)[:3]
    score_type = functools.reduce(torch.promote_types, [f.dtype for f in feats]) if half else torch.float32
    return vals.to(score_type), bidx, cls


def nms_from_feats(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_cand: int = 512,
    agnostic: bool = False,
    class_mask: Optional[torch.Tensor] = None,
    mode: str = "greedy",
    half: bool = False,
    multi_label: bool = False,
) -> torch.Tensor:
    """Select-first NMS over raw per-level Detect maps (B, H, W, no) -> padded (B, max_det, 6).

    1-2. per-anchor sigmoid max/argmax (or flat anchor x class with
         multi_label), conf gate, top-K in lax.top_k order;
    3.   the K candidates' box logits gathered and put through the DFL expectation;
    4.   anchor centres and strides rebuilt arithmetically from the anchor index;
    5.   exact greedy keep on class-offset boxes and compaction (`_suppress`).
    Steps 1-4 are one `select_decode` call (K3 on the card); the maps may be
    in any layout and dtype (bf16 maps with half=False are scored in fp32, as
    their fp32 copy would be).
    """
    vals, _, cls_k, cand_boxes, shifted, valid = select_decode(feats, strides, nc, reg_max, conf_thres, max_cand,
                                                               class_mask, half, multi_label, agnostic)
    return _suppress(cand_boxes, vals, cls_k, shifted, valid, iou_thres, max_det, mode)
