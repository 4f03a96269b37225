"""Box algebra: format conversion, IoU, anchor geometry (port of yololite_tpu/ops/boxes.py).

Torch versions work on tensors on any device; the `*_np` helpers serve the
host-side Results path and the validator's matching. `box_iou` keeps the JAX operation order and eps, so
the two give the same bits on the same boxes. `bbox_iou` (CIoU for the loss
and the assigner), `bbox2dist` and the numpy `bbox_ioa` (CopyPaste) serve train.
`topk_stable` is the top-k in lax.top_k's order that the candidate selects,
the NMS and the assigner share (the plain version of K3's select and of K7).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


# ---- format conversion (torch tensors or numpy arrays) ----


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return cat([xy - half, xy + half], -1)


def xyxy2xywh(x):
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    p1, p2 = x[..., :2], x[..., 2:4]
    return cat([(p1 + p2) / 2, p2 - p1], -1)


def xywhn2xyxy(x, w=640, h=640, padw=0, padh=0):
    """Normalized (cx, cy, w, h) -> pixel (x1, y1, x2, y2) with optional pad offset (numpy)."""
    y = np.empty_like(x)
    xc, yc, bw, bh = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    y[..., 0] = w * (xc - bw / 2) + padw
    y[..., 1] = h * (yc - bh / 2) + padh
    y[..., 2] = w * (xc + bw / 2) + padw
    y[..., 3] = h * (yc + bh / 2) + padh
    return y


def xyxy2xywhn(x, w=640, h=640, clip=False, eps=0.0):
    """Pixel (x1, y1, x2, y2) -> normalized (cx, cy, w, h) (numpy)."""
    if clip:
        x = clip_boxes_np(x.copy(), (h - eps, w - eps))
    y = np.empty_like(x)
    y[..., 0] = ((x[..., 0] + x[..., 2]) / 2) / w
    y[..., 1] = ((x[..., 1] + x[..., 3]) / 2) / h
    y[..., 2] = (x[..., 2] - x[..., 0]) / w
    y[..., 3] = (x[..., 3] - x[..., 1]) / h
    return y


def xywh2ltwh(x):
    """(cx, cy, w, h) -> (x1, y1, w, h)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return cat([x[..., :2] - x[..., 2:4] / 2, x[..., 2:4]], -1)


def xyxy2ltwh(x):
    """(x1, y1, x2, y2) -> (x1, y1, w, h)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return cat([x[..., :2], x[..., 2:4] - x[..., :2]], -1)


def ltwh2xywh(x):
    """(x1, y1, w, h) -> (cx, cy, w, h)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return cat([x[..., :2] + x[..., 2:4] / 2, x[..., 2:4]], -1)


def ltwh2xyxy(x):
    """(x1, y1, w, h) -> (x1, y1, x2, y2)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return cat([x[..., :2], x[..., :2] + x[..., 2:4]], -1)


# ---- clipping / rescaling (host path) ----


def clip_boxes_np(boxes: np.ndarray, shape) -> np.ndarray:
    """Clip xyxy boxes to image shape (h, w) in place."""
    boxes[..., 0] = boxes[..., 0].clip(0, shape[1])
    boxes[..., 1] = boxes[..., 1].clip(0, shape[0])
    boxes[..., 2] = boxes[..., 2].clip(0, shape[1])
    boxes[..., 3] = boxes[..., 3].clip(0, shape[0])
    return boxes


def scale_image_np(masks: np.ndarray, im0_shape, ratio_pad=None) -> np.ndarray:
    """Un-letterbox an image or mask array, (H, W[, C]) in letterboxed space -> (h0, w0, C) (cv2 resize)."""
    import cv2

    im1_shape = masks.shape
    if im1_shape[:2] == tuple(im0_shape[:2]):
        return masks
    if ratio_pad is None:
        gain = min(im1_shape[0] / im0_shape[0], im1_shape[1] / im0_shape[1])
        pad = (im1_shape[1] - im0_shape[1] * gain) / 2, (im1_shape[0] - im0_shape[0] * gain) / 2
    else:
        pad = ratio_pad[1]
    top, left = int(pad[1]), int(pad[0])
    bottom, right = int(im1_shape[0] - pad[1]), int(im1_shape[1] - pad[0])
    masks = cv2.resize(masks[top:bottom, left:right], (im0_shape[1], im0_shape[0]))
    return masks[:, :, None] if masks.ndim == 2 else masks


def clip_coords(coords, shape):
    """Clip (..., 2+) point coordinates to an image's (h, w), in place (numpy array or tensor)."""
    coords[..., 0] = coords[..., 0].clip(0, shape[1])
    coords[..., 1] = coords[..., 1].clip(0, shape[0])
    return coords


def convert_batch2numpy(batch) -> list:
    """Normalized NHWC float batch -> list of BGR uint8 images for Results."""
    arr = np.asarray(batch, np.float32)
    return [np.ascontiguousarray((np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)[..., ::-1]) for a in arr]


def scale_boxes_np(img1_shape, boxes, img0_shape, ratio_pad=None, padding=True, xywh=False):
    """Rescale boxes from letterboxed img1_shape back to original img0_shape (round(pad - 0.1) split)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (
            round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
            round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1),
        )
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    boxes = np.array(boxes, dtype=np.float64 if boxes.dtype == np.float64 else np.float32)
    if padding:
        boxes[..., 0] -= pad[0]
        boxes[..., 1] -= pad[1]
        if not xywh:
            boxes[..., 2] -= pad[0]
            boxes[..., 3] -= pad[1]
    boxes[..., :4] /= gain
    return clip_boxes_np(boxes, img0_shape)


# ---- IoU ----


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]  # (..., N, 1, 2)
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]  # (..., 1, M, 2)
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU of xyxy numpy boxes, (N, 4) x (M, 4) -> (N, M), in the inputs' dtype.

    The validator's TP matching runs here on the host, with `box_iou`'s
    operation order, so matches at each IoU threshold flip on the same pairs
    as in the JAX package.
    """
    a1, a2 = box1[..., None, :2], box1[..., None, 2:4]  # (N, 1, 2)
    b1, b2 = box2[None, :, :2], box2[None, :, 2:4]  # (1, M, 2)
    inter = (np.minimum(a2, b2) - np.maximum(a1, b1)).clip(0).prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2's area, xyxy numpy (N, 4) x (M, 4) -> (N, M)."""
    a1, a2 = box1[..., None, :2], box1[..., None, 2:4]  # (N, 1, 2)
    b1, b2 = box2[None, :, :2], box2[None, :, 2:4]  # (1, M, 2)
    inter = (np.minimum(a2, b2) - np.maximum(a1, b1)).clip(0).prod(-1)
    return inter / ((b2 - b1).prod(-1) + eps)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, CIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU or CIoU of broadcastable (..., 4) boxes, in the JAX package's operation order.

    The CIoU aspect term's alpha is taken without gradient, as upstream torch does.
    """
    if xywh:
        (x1, y1, w1, h1), (x2, y2, w2, h2) = box1.unbind(-1), box2.unbind(-1)
        b1_x1, b1_x2 = x1 - w1 / 2, x1 + w1 / 2
        b1_y1, b1_y2 = y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2 = x2 - w2 / 2, x2 + w2 / 2
        b2_y1, b2_y2 = y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not CIoU:
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


# ---- anchors / distance-box conversion ----


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int], offset: float = 0.5,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor grid for given (h, w) per level -> (anchors (A, 2), strides (A, 1))."""
    pts, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strs.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(strs)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """ltrb distances -> boxes around anchor points."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from the anchor points, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:4]
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, descending, ties to the lower index (lax.top_k's rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
