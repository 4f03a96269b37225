"""Hand-written kernels and device-side preprocessing (counterpart of yololite_tpu/ops/pallas_kernels.py).

1. `greedy_nms_keep`: exact greedy NMS keep mask from score-sorted boxes.
   On a CUDA tensor it launches the CUDA kernel csrc/greedy_nms_keep.cu,
   which replaces the Pallas kernel `greedy_nms_keep_pallas` and the
   `box_iou` before it; on a CPU tensor it runs the plain version beside it,
   `greedy_nms_keep_plain`.
2. `device_letterbox`: batched letterbox on the device for same-shape uint8
   batches: bilinear resize as two fp32 matmuls, pad with 114, divide by 255.
   Plain torch for now (ROADMAP.md, Queue 2 K2).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from yololite_tpu_torch.ops.boxes import box_iou

# ---------------- greedy NMS keep ----------------


def greedy_nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain torch greedy keep: (B, K, 4) score-sorted xyxy boxes, (B, K) valid -> (B, K) bool.

    `box_iou` in fp32, then the batched fixpoint of yololite_tpu/ops/nms.py
    `_fixpoint_keep`: iterate keep[j] = valid[j] & no kept i < j has
    iou[i, j] > thr until it stops changing; the greedy recurrence has one
    solution, and each sweep makes at least one more prefix entry final, so
    this is exactly sequential greedy.
    """
    b = boxes.float()
    iou = box_iou(b, b)
    k = iou.shape[-1]
    tri = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)  # i suppresses j only if i < j
    sup = (iou > iou_thres) & tri
    valid = valid.bool()
    keep = valid
    while True:
        new = valid & ~(sup & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            return keep
        keep = new


def greedy_nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Exact greedy keep mask: (B, K, 4) float32 xyxy boxes (score-sorted), (B, K) bool valid -> (B, K) bool.

    A CUDA tensor goes through the CUDA kernel (K <= 1024), which computes the
    IoU itself; a CPU tensor goes through `greedy_nms_keep_plain`; any other
    input raises.
    """
    if boxes.device.type == "cpu":
        return greedy_nms_keep_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_nms_keep: unsupported device {boxes.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"greedy_nms_keep wants float32 boxes and bool valid, got {boxes.dtype} and {valid.dtype}")
    if boxes.ndim != 3 or boxes.shape[2] != 4 or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"greedy_nms_keep wants boxes (B, K, 4) and valid (B, K), got {tuple(boxes.shape)} "
                         f"and {tuple(valid.shape)}")
    if valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device} but valid on {valid.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_nms_keep wants contiguous boxes and valid")
    b, k = valid.shape
    if k > 1024:
        raise ValueError(f"greedy_nms_keep takes K <= 1024, got {k}; run larger K in blocks (ops.nms._blocked_keep)")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _nms_lib().greedy_nms_keep(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, float(iou_thres),
                                    boxes.device.index, stream)
    if rc != 0:
        msg = _nms_lib().greedy_nms_keep_error_string(rc).decode()
        raise RuntimeError(f"greedy_nms_keep kernel launch failed: {msg}")
    greedy_nms_keep.launches += 1
    return keep


greedy_nms_keep.launches = 0  # kernel launches since the last reset


def _nms_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("greedy_nms_keep")
    if lib.greedy_nms_keep.argtypes is None:  # declare the C signatures once per process
        lib.greedy_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.greedy_nms_keep.restype = ctypes.c_int
        lib.greedy_nms_keep_error_string.argtypes = [ctypes.c_int]
        lib.greedy_nms_keep_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- device letterbox (matmul bilinear resize) ----------------


def _interp_matrix(dst: int, src: int) -> np.ndarray:
    """cv2.INTER_LINEAR (half-pixel centers) row-interp matrix (dst, src)."""
    m = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        c = (i + 0.5) * scale - 0.5
        lo = int(np.floor(c))
        w_hi = c - lo
        lo_c = min(max(lo, 0), src - 1)
        hi_c = min(max(lo + 1, 0), src - 1)
        m[i, lo_c] += 1.0 - w_hi
        m[i, hi_c] += w_hi
    return m


@functools.lru_cache(maxsize=32)
def _interp_on(dst: int, src: int, device: torch.device) -> torch.Tensor:
    """`_interp_matrix` as a tensor on `device`, built and copied there once per shape."""
    return torch.from_numpy(_interp_matrix(dst, src)).to(device)


def device_letterbox(images: torch.Tensor, imgsz: int = 640, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched letterbox on the images' device for same-shape inputs.

    images: (B, H0, W0, 3) uint8 RGB. Returns (B, imgsz, imgsz, 3) in [0, 1]
    with the reference geometry: r = min(S/H0, S/W0), round() new size,
    centred round(d-0.1)/round(d+0.1) padding, 114-gray fill.
    """
    b, h0, w0, c = images.shape
    r = min(imgsz / h0, imgsz / w0)
    new_w, new_h = int(round(w0 * r)), int(round(h0 * r))
    dw, dh = (imgsz - new_w) / 2, (imgsz - new_h) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    bottom, right = imgsz - new_h - top, imgsz - new_w - left

    x = images.float()
    if (new_h, new_w) != (h0, w0):
        ry = _interp_on(new_h, h0, images.device)  # (new_h, h0)
        rx = _interp_on(new_w, w0, images.device)  # (new_w, w0)
        x = torch.einsum("yh,bhwc->bywc", ry, x)
        x = torch.einsum("xw,bywc->byxc", rx, x)
    x = F.pad(x, (0, 0, left, right, top, bottom), value=114.0)
    return (x * (1.0 / 255.0)).to(out_dtype)  # as XLA lowers the JAX package's x / 255: the pad's bits match
