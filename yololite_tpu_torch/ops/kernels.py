"""Hand-written kernels and device-side preprocessing (counterpart of yololite_tpu/ops/pallas_kernels.py).

1. `greedy_nms_keep`: exact greedy NMS keep mask from score-sorted boxes (K1).
   On a CUDA tensor it launches the CUDA kernel csrc/greedy_nms_keep.cu,
   which replaces the Pallas kernel `greedy_nms_keep_pallas` and the
   `box_iou` before it; on a CPU tensor it runs the plain version beside it,
   `greedy_nms_keep_plain`.
2. `blocked_nms_finalize`: exact greedy NMS over K > 1024 score-sorted
   candidates and the compaction of the kept rows into the padded
   (B, max_det, 6) detections (K4). On a CUDA tensor it launches
   csrc/blocked_nms.cu, which replaces the XLA ops `_blocked_keep` and
   `_finalize` of yololite_tpu/ops/nms.py:164,281; on a CPU tensor it runs
   `blocked_nms_finalize_plain`, which is those two functions of ops/nms.py.
3. `int8_conv`: the int8 serving convolution with its epilogue (K8), and the
   quantize of a bf16 or fp32 input before it. On a CUDA tensor it launches
   csrc/int8_conv.cu, which replaces the int32 accumulated XLA convolution of
   yololite_tpu/models/modules.py:176-185; on a CPU tensor it runs
   `int8_conv_plain`.
4. `device_letterbox`: batched letterbox on the device for same-shape uint8
   batches: bilinear resize as two fp32 matmuls, pad with 114, divide by 255.
   Plain torch for now (ROADMAP.md, Queue 2 K2).

K1, K4 and K8 are `torch.library` custom ops (`torch.ops.yololite_tpu_torch.*`):
the CUDA implementation launches the kernel or raises, the CPU one is the
plain version, and a fake implementation gives the output's shape, so
`torch.export` records each as one op. The public wrappers check their
inputs, call the op, and count the kernel's launches (`.launches`); a CUDA
tensor never reaches a plain version. `COUNTED` lists those wrappers: a
replayed CUDA graph adds the launches its capture recorded to them
(engine/graphs.py). Every kernel launches on PyTorch's current stream, which
under a capture is the capture stream.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

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
    IoU itself; a CPU tensor goes through `greedy_nms_keep_plain`; both as the
    op `torch.ops.yololite_tpu_torch.greedy_nms_keep`. Any other input raises.
    """
    if boxes.device.type == "cuda":
        if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
            raise TypeError(f"greedy_nms_keep wants float32 boxes and bool valid, got {boxes.dtype} and {valid.dtype}")
        if boxes.ndim != 3 or boxes.shape[2] != 4 or tuple(valid.shape) != tuple(boxes.shape[:2]):
            raise ValueError(f"greedy_nms_keep wants boxes (B, K, 4) and valid (B, K), got {tuple(boxes.shape)} "
                             f"and {tuple(valid.shape)}")
        if valid.device != boxes.device:
            raise ValueError(f"boxes on {boxes.device} but valid on {valid.device}")
        if not (boxes.is_contiguous() and valid.is_contiguous()):
            raise ValueError("greedy_nms_keep wants contiguous boxes and valid")
        if valid.shape[1] > 1024:
            raise ValueError(f"greedy_nms_keep takes K <= 1024, got {valid.shape[1]}; larger K goes through "
                             "blocked_nms_finalize")
    elif boxes.device.type != "cpu":
        raise ValueError(f"greedy_nms_keep: unsupported device {boxes.device}")
    return torch.ops.yololite_tpu_torch.greedy_nms_keep(boxes, valid, float(iou_thres))


greedy_nms_keep.launches = 0  # kernel launches since the last reset


@torch.library.custom_op("yololite_tpu_torch::greedy_nms_keep", mutates_args=(), device_types="cpu")
def _greedy_nms_keep_op(boxes: Tensor, valid: Tensor, iou_thres: float) -> Tensor:
    return greedy_nms_keep_plain(boxes, valid, iou_thres).clone()  # the plain fixpoint may return `valid` itself


@_greedy_nms_keep_op.register_kernel("cuda")
def _greedy_nms_keep_cuda(boxes: Tensor, valid: Tensor, iou_thres: float) -> Tensor:
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _nms_lib().greedy_nms_keep(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, float(iou_thres),
                                    boxes.device.index, stream)
    if rc != 0:
        msg = _nms_lib().greedy_nms_keep_error_string(rc).decode()
        raise RuntimeError(f"greedy_nms_keep kernel launch failed: {msg}")
    greedy_nms_keep.launches += 1
    return keep


@_greedy_nms_keep_op.register_fake
def _greedy_nms_keep_fake(boxes: Tensor, valid: Tensor, iou_thres: float) -> Tensor:
    return torch.empty(tuple(valid.shape), dtype=torch.bool, device=boxes.device)


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


# ---------------- blocked greedy NMS + compaction (K4) ----------------


def blocked_nms_finalize_plain(shifted: torch.Tensor, boxes: torch.Tensor, vals: torch.Tensor, cls: torch.Tensor,
                               valid: torch.Tensor, iou_thres: float, max_det: int) -> torch.Tensor:
    """Plain torch K4: `_finalize(boxes, vals, cls, _blocked_keep(shifted, valid, iou_thres), max_det)` of ops/nms.py,
    the blocked keep syncing with the host once per block to skip a dead one."""
    from yololite_tpu_torch.ops import nms  # ops.nms imports this module

    return nms._finalize(boxes, vals, cls, nms._blocked_keep(shifted, valid, iou_thres), max_det)


def blocked_nms_finalize(shifted: torch.Tensor, boxes: torch.Tensor, vals: torch.Tensor, cls: torch.Tensor,
                         valid: torch.Tensor, iou_thres: float, max_det: int) -> torch.Tensor:
    """Exact greedy NMS and compaction: score-sorted class-offset boxes `shifted` (B, K, 4), their unshifted `boxes`
    (B, K, 4), scores `vals` and classes `cls` (B, K), all float32, and bool `valid` (B, K) -> (B, max_det, 6) float32
    rows [x1, y1, x2, y2, score, class] of the kept candidates with score > 0, in order, then zeros.

    A CUDA tensor goes through csrc/blocked_nms.cu (any K, one launch, no host
    sync), a CPU tensor through `blocked_nms_finalize_plain`; both as the op
    `torch.ops.yololite_tpu_torch.blocked_nms_finalize`. Any other input raises.
    """
    if shifted.device.type == "cuda":
        tensors = (shifted, boxes, vals, cls, valid)
        if any(t.dtype != torch.float32 for t in tensors[:4]) or valid.dtype != torch.bool:
            raise TypeError("blocked_nms_finalize wants float32 shifted, boxes, vals and cls and bool valid, got "
                            f"{[t.dtype for t in tensors]}")
        b, k = valid.shape if valid.ndim == 2 else (-1, -1)
        if tuple(shifted.shape) != (b, k, 4) or tuple(boxes.shape) != (b, k, 4) or tuple(vals.shape) != (b, k) or \
                tuple(cls.shape) != (b, k):
            raise ValueError("blocked_nms_finalize wants shifted and boxes (B, K, 4), vals, cls and valid (B, K), got "
                             f"{[tuple(t.shape) for t in tensors]}")
        if any(t.device != shifted.device for t in tensors):
            raise ValueError(f"blocked_nms_finalize: tensors on {[str(t.device) for t in tensors]}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("blocked_nms_finalize wants contiguous tensors")
        if max_det < 0:
            raise ValueError(f"blocked_nms_finalize: max_det {max_det}")
    elif shifted.device.type != "cpu":
        raise ValueError(f"blocked_nms_finalize: unsupported device {shifted.device}")
    return torch.ops.yololite_tpu_torch.blocked_nms_finalize(shifted, boxes, vals, cls, valid, float(iou_thres),
                                                             int(max_det))


blocked_nms_finalize.launches = 0  # kernel launches since the last reset


@torch.library.custom_op("yololite_tpu_torch::blocked_nms_finalize", mutates_args=(), device_types="cpu")
def _blocked_nms_finalize_op(shifted: Tensor, boxes: Tensor, vals: Tensor, cls: Tensor, valid: Tensor,
                             iou_thres: float, max_det: int) -> Tensor:
    return blocked_nms_finalize_plain(shifted, boxes, vals, cls, valid, iou_thres, max_det).clone()  # not a view


def _aligned16(t: Tensor) -> Tensor:
    """t itself when its data starts on 16 bytes (the kernel loads boxes as float4), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@_blocked_nms_finalize_op.register_kernel("cuda")
def _blocked_nms_finalize_cuda(shifted: Tensor, boxes: Tensor, vals: Tensor, cls: Tensor, valid: Tensor,
                               iou_thres: float, max_det: int) -> Tensor:
    b, k = valid.shape
    shifted, boxes = _aligned16(shifted), _aligned16(boxes)
    out = torch.empty((b, max_det, 6), dtype=torch.float32, device=shifted.device)
    workspace = torch.empty((b, k, 4), dtype=torch.float32, device=shifted.device)  # the kept boxes, in order
    stream = torch.cuda.current_stream(shifted.device).cuda_stream
    lib = _blocked_lib()
    rc = lib.blocked_nms_finalize(shifted.data_ptr(), boxes.data_ptr(), vals.data_ptr(), cls.data_ptr(),
                                  valid.data_ptr(), out.data_ptr(), workspace.data_ptr(), b, k, float(iou_thres),
                                  max_det, shifted.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"blocked_nms_finalize kernel launch failed: {lib.blocked_nms_error_string(rc).decode()}")
    blocked_nms_finalize.launches += 1
    return out


@_blocked_nms_finalize_op.register_fake
def _blocked_nms_finalize_fake(shifted: Tensor, boxes: Tensor, vals: Tensor, cls: Tensor, valid: Tensor,
                               iou_thres: float, max_det: int) -> Tensor:
    return torch.empty((valid.shape[0], max_det, 6), dtype=torch.float32, device=shifted.device)


def blocked_nms_plan(b: int, k: int, device: Optional[torch.device] = None, cluster: int = 0) -> dict:
    """What csrc/blocked_nms.cu's launch for a (B, K) batch uses on the card (cluster 0: the size it picks for B):
    {"cluster": C CTAs an image, "step": S candidates a step, "smem": a CTA's dynamic shared memory in bytes,
    "share_cap": kept boxes a CTA holds in shared memory, "max_active_clusters": cudaOccupancyMaxActiveClusters,
    "threads": a CTA's}."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    plan = (ctypes.c_int * 6)()
    lib = _blocked_lib()
    rc = lib.blocked_nms_plan(b, k, cluster, device.index or 0, plan)
    if rc != 0:
        raise RuntimeError(f"blocked_nms_plan failed: {lib.blocked_nms_error_string(rc).decode()}")
    return dict(zip(("cluster", "step", "smem", "share_cap", "max_active_clusters", "threads"), plan))


def _blocked_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("blocked_nms")
    if lib.blocked_nms_finalize.argtypes is None:  # declare the C signatures once per process
        lib.blocked_nms_finalize.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.blocked_nms_finalize.restype = ctypes.c_int
        lib.blocked_nms_finalize_ex.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.blocked_nms_finalize_ex.restype = ctypes.c_int
        lib.blocked_nms_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.blocked_nms_plan.restype = ctypes.c_int
        lib.blocked_nms_error_string.argtypes = [ctypes.c_int]
        lib.blocked_nms_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- int8 convolution (K8) ----------------

ACTS = {"none": 0, "silu": 1, "relu": 2}  # the epilogue's activation codes


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float activations -> int8 at `scale` (a 0-d fp32 tensor on x's device): round half to even, clip to +-127.

    The divisor is a tensor on the device so that the division is IEEE on the
    card too (a Python scalar divisor makes torch multiply by its reciprocal).
    """
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def dequantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """int8 activations -> bf16 at `scale`."""
    return (x.float() * scale).to(torch.bfloat16)


def _conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, stride: int,
                    padding: int, groups: int, act: int, sout: float, sin: float = 0.0) -> torch.Tensor:
    """Plain torch K8: a float x quantized at `sin` (`quantize_act`), the accumulator as a float64 convolution of
    the int8 values, then the same epilogue.

    float64 holds every sum exactly (|acc| <= 127^2 * taps * Cin < 2^53), and
    its conversion to fp32 rounds as the kernel's int -> float does. Then
    y = acc * scale + b in fp32 (two roundings), bf16, the activation on bf16,
    and with sout > 0 round(y / sout) clipped to +-127 as int8. Returns a
    channels-last (B, Cout, Ho, Wo) tensor, int8 or bf16.
    """
    if x.dtype != torch.int8:
        x = quantize_act(x, torch.full((), sin, dtype=torch.float32, device=x.device))
    acc = F.conv2d(x.double(), w.permute(0, 3, 1, 2).double(), None, stride, padding, 1, groups).float()
    y = acc * scale[None, :, None, None]
    y = (y + bias[None, :, None, None]).to(torch.bfloat16)
    if act == 1:
        y = F.silu(y)
    elif act == 2:
        y = F.relu(y)
    if sout > 0:
        y = quantize_act(y, torch.full((), sout, dtype=torch.float32, device=y.device))
    out = torch.empty(tuple(y.shape), dtype=y.dtype, device=y.device, memory_format=torch.channels_last)
    return out.copy_(y)


X_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}  # K8's input codes
ROUTES = ("gemm", "depthwise", "direct")  # csrc/int8_conv.cu's routes, by code


def int8_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, stride: int = 1,
              padding: int = 0, groups: int = 1, act: int = 1, sout: float = 0.0,
              sin: Optional[float] = None) -> torch.Tensor:
    """int8 convolution with its epilogue: x (B, Cin, H, W) int8, or bf16/fp32 quantized at `sin` first, w int8
    OHWI (Cout, KH, KW, Cin/groups), scale = sin * sw and bias fp32 (Cout) -> channels-last (B, Cout, Ho, Wo),
    int8 when sout > 0 else bf16.

    act: 0 none, 1 SiLU, 2 ReLU. A CUDA tensor goes through csrc/int8_conv.cu
    (a float x is quantized as the kernel loads it), a CPU tensor through
    `int8_conv_plain`, both as the op `torch.ops.yololite_tpu_torch.int8_conv`;
    x is made channels-last first (a no-op for the int8 edges the kernel
    writes).
    """
    if x.dtype not in X_TYPES or w.dtype != torch.int8:
        raise TypeError(f"int8_conv wants int8, bf16 or fp32 x and int8 w, got {x.dtype} and {w.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"int8_conv wants float32 scale and bias, got {scale.dtype} and {bias.dtype}")
    if x.dtype != torch.int8 and sin is None:
        raise TypeError(f"int8_conv takes a {x.dtype} x only with its quantize scale sin")
    cout, kh, kw, cin_g = w.shape
    if x.ndim != 4 or x.shape[1] != cin_g * groups or cout % groups or tuple(scale.shape) != (cout,) or tuple(
            bias.shape) != (cout,):
        raise ValueError(f"int8_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, groups {groups}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)} do not fit")
    if not (x.device == w.device == scale.device == bias.device):
        raise ValueError(f"int8_conv: tensors on {x.device}, {w.device}, {scale.device}, {bias.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    if act not in ACTS.values() or stride < 1 or padding < 0:
        raise ValueError(f"int8_conv: act {act}, stride {stride}, padding {padding}")
    x = x.contiguous(memory_format=torch.channels_last)
    return torch.ops.yololite_tpu_torch.int8_conv(x, w.contiguous(), scale.contiguous(), bias.contiguous(),
                                                  int(stride), int(padding), int(groups), int(act), float(sout),
                                                  float(sin or 0.0))


int8_conv.launches = 0  # kernel launches since the last reset

COUNTED = (greedy_nms_keep, blocked_nms_finalize, int8_conv)  # the wrappers that count their kernel's launches


@torch.library.custom_op("yololite_tpu_torch::int8_conv", mutates_args=(), device_types="cpu")
def _int8_conv_op(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, stride: int, padding: int, groups: int,
                  act: int, sout: float, sin: float = 0.0) -> Tensor:
    return int8_conv_plain(x, w, scale, bias, stride, padding, groups, act, sout, sin)


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, stride: int, padding: int, groups: int,
                    act: int, sout: float, sin: float = 0.0) -> Tensor:
    b, cin, h, wd = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = _conv_out_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty((b, cout, ho, wo), dtype=torch.int8 if sout > 0 else torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)  # PyTorch's current stream, as an int
    lib = _int8_lib()
    table = _requant_table(x.device, act, sout).data_ptr() if sout > 0 else None
    rc = lib.int8_conv(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd, cin,
                       ho, wo, cout, kh, kw, stride, padding, groups, act, X_TYPES[x.dtype], float(sout), float(sin),
                       table, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: {lib.int8_conv_error_string(rc).decode()}")
    int8_conv.launches += 1
    return out


@_int8_conv_op.register_fake
def _int8_conv_fake(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, stride: int, padding: int, groups: int,
                    act: int, sout: float, sin: float = 0.0) -> Tensor:
    ho, wo = _conv_out_hw(x.shape[2], x.shape[3], w.shape[1], w.shape[2], stride, padding)
    return torch.empty((x.shape[0], w.shape[0], ho, wo), dtype=torch.int8 if sout > 0 else torch.bfloat16,
                       device=x.device, memory_format=torch.channels_last)


_requant_tables = {}  # (device, act, sout) -> K8's activation + requant table on that device


def _requant_table(device: torch.device, act: int, sout: float) -> torch.Tensor:
    """K8's table of the epilogue's tail (activation, then requant at sout) over every bf16 y, built on the
    card at first use by csrc/int8_conv.cu's table kernel and kept: every int8-out conv at one (act, sout),
    yolo11's 66 at the global activation scale, shares one. Build it outside a CUDA graph capture."""
    device = torch.device("cuda", torch.cuda.current_device() if device.index is None else device.index)
    key = (device.index, int(act), float(np.float32(sout)))
    if key not in _requant_tables:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("int8_conv: run each (act, sout) once before capturing it in a CUDA graph")
        lib = _int8_lib()
        table = torch.zeros(lib.int8_conv_table_bytes(), dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.int8_conv_table(table.data_ptr(), act, sout, device.index, stream)
        if rc != 0:
            raise RuntimeError(f"int8_conv table kernel launch failed: {lib.int8_conv_error_string(rc).decode()}")
        _requant_tables[key] = table
    return _requant_tables[key]


def int8_conv_plan(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, groups: int) -> dict:
    """The route csrc/int8_conv.cu takes for these CUDA tensors (x channels-last NCHW, w OHWI, out its output):
    {"route": "gemm" | "depthwise" | "direct", "n_tile", "m_tile", "granule" (those three for gemm), "smem"
    (the launch's dynamic shared memory, bytes)}."""
    b, cin = x.shape[:2]
    cout, kh, kw, _ = w.shape
    plan = (ctypes.c_int * 5)()
    _int8_lib().int8_conv_plan(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, cin, out.shape[2], out.shape[3], cout,
                               kh, kw, groups, plan)
    return {"route": ROUTES[plan[0]], "n_tile": plan[1], "m_tile": 64 * plan[2], "granule": plan[3], "smem": plan[4]}


def _int8_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("int8_conv")
    if lib.int8_conv.argtypes is None:  # declare the C signatures once per process
        lib.int8_conv.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_float, ctypes.c_float,
                                                                                 ctypes.c_void_p, ctypes.c_int,
                                                                                 ctypes.c_void_p]
        lib.int8_conv.restype = ctypes.c_int
        lib.int8_conv_table.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.int8_conv_table.restype = ctypes.c_int
        lib.int8_conv_table_bytes.argtypes = []
        lib.int8_conv_table_bytes.restype = ctypes.c_int
        lib.int8_conv_plan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
        lib.int8_conv_plan.restype = ctypes.c_int
        lib.int8_conv_error_string.argtypes = [ctypes.c_int]
        lib.int8_conv_error_string.restype = ctypes.c_char_p
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
