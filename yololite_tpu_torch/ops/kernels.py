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
4. `select_decode`: steps 1-4 of ops/nms.py nms_from_feats (K3): per-level
   sigmoid scores from the raw Detect maps, the conf gate, the top K in
   lax.top_k's order, the candidates' DFL decode and their anchors. On a
   CUDA tensor it launches csrc/select_decode.cu, which replaces those XLA
   ops of yololite_tpu/ops/nms.py:357 (steps 1-4, :409-494); on a CPU tensor
   it runs `select_decode_plain`.
5. `device_letterbox`: batched letterbox of a same-shape uint8 batch (K2):
   bilinear resize, pad with 114, times 1/255, optionally with the channels
   reversed (BGR in). On a CUDA tensor it launches csrc/letterbox.cu, which
   replaces yololite_tpu/ops/pallas_kernels.py:89 `device_letterbox`; on a
   CPU tensor it runs `device_letterbox_plain` (two fp32 matmuls, a pad, a
   scale).

The train step's loss-tail kernels (K5, K6a, K6b, K7, K9) are in
ops/loss_kernels.py, its apply (K10) in ops/optim_kernels.py; their
wrappers join `COUNTED` below.

All five here are `torch.library` custom ops (`torch.ops.yololite_tpu_torch.*`):
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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from yololite_tpu_torch.ops.boxes import box_iou, topk_stable
from yololite_tpu_torch.ops import loss_kernels, optim_kernels
from yololite_tpu_torch.ops.loss_kernels import dfl_expectation_plain

MAX_WH = 7680  # class-offset magnitude of the NMS's class-aware boxes

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
ROUTES = ("gemm", "depthwise", "direct", "gemm1x1")  # csrc/int8_conv.cu's routes, by code
PICKS = {"plan": 0, "gemm": 1, "gemm1x1": 2}  # the route int8_conv_pick takes: the plan's, or the one named


def x_pitch(x: torch.Tensor) -> Optional[int]:
    """The pixel pitch (elements from one pixel to the next) of a (B, C, H, W) x that K8 reads in place: channels
    innermost and dense, pixels `pitch` >= C elements apart, rows and images dense in pixels (a channels-last tensor,
    pitch C, or a channel slice of one, such as a `split` half, pitch the whole tensor's C); else None."""
    b, c, h, w = x.shape
    sn, sc, sh, sw = x.stride()
    pitch = sw if w > 1 else sh if h > 1 else sn if b > 1 else c  # a size-1 dimension's stride says nothing
    if (c > 1 and sc != 1) or pitch < c or (w > 1 and sw != pitch) or (h > 1 and sh != w * pitch) or (
            b > 1 and sn != h * w * pitch):
        return None
    return pitch


def int8_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, stride: int = 1,
              padding: int = 0, groups: int = 1, act: int = 1, sout: float = 0.0,
              sin: Optional[float] = None) -> torch.Tensor:
    """int8 convolution with its epilogue: x (B, Cin, H, W) int8, or bf16/fp32 quantized at `sin` first, w int8
    OHWI (Cout, KH, KW, Cin/groups), scale = sin * sw and bias fp32 (Cout) -> channels-last (B, Cout, Ho, Wo),
    int8 when sout > 0 else bf16.

    act: 0 none, 1 SiLU, 2 ReLU. A CUDA tensor goes through csrc/int8_conv.cu
    (a float x is quantized as the kernel loads it), a CPU tensor through
    `int8_conv_plain`, both as the op `torch.ops.yololite_tpu_torch.int8_conv`.
    The kernel reads x where it lies when `x_pitch` finds its pixel pitch (a
    channels-last x, or a channel-split view of one, as C3k2's halves are);
    any other layout of a CUDA x is copied to channels-last first, and counted
    in `int8_conv.copies`. A CPU x goes to the plain version as it is.
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
    if x.device.type == "cuda" and x_pitch(x) is None:
        x = x.contiguous(memory_format=torch.channels_last)
        int8_conv.copies += 1
    return torch.ops.yololite_tpu_torch.int8_conv(x, w.contiguous(), scale.contiguous(), bias.contiguous(),
                                                  int(stride), int(padding), int(groups), int(act), float(sout),
                                                  float(sin or 0.0))


int8_conv.launches = 0  # kernel launches since the last reset
int8_conv.copies = 0  # CUDA inputs copied to channels-last before the kernel since the last reset


@torch.library.custom_op("yololite_tpu_torch::int8_conv", mutates_args=(), device_types="cpu")
def _int8_conv_op(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, stride: int, padding: int, groups: int,
                  act: int, sout: float, sin: float = 0.0) -> Tensor:
    return int8_conv_plain(x, w, scale, bias, stride, padding, groups, act, sout, sin)


def _int8_conv_launch(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, stride: int, padding: int, groups: int,
                      act: int, sout: float, sin: float = 0.0, pick: str = "plan") -> Tensor:
    """One launch of csrc/int8_conv.cu into a fresh output, on the route its plan picks, or (`pick` "gemm" for
    route 1, or "gemm1x1") through its entry point int8_conv_pick, which chip_smoke.py times the routes of a conv
    with. x is read in place at its pixel pitch (`x_pitch`); any other layout raises."""
    pitch = x_pitch(x)
    if pitch is None:
        raise ValueError(f"int8_conv: the kernel reads a channels-last x or a channel slice of one, not strides "
                         f"{x.stride()} of shape {tuple(x.shape)}")
    b, cin, h, wd = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = _conv_out_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty((b, cout, ho, wo), dtype=torch.int8 if sout > 0 else torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)  # PyTorch's current stream, as an int
    lib = _int8_lib()
    table = _requant_table(x.device, act, sout).data_ptr() if sout > 0 else None
    args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd, cin, pitch, ho,
            wo, cout, kh, kw, stride, padding, groups, act, X_TYPES[x.dtype], float(sout), float(sin), table,
            x.device.index, stream)
    rc = lib.int8_conv(*args) if pick == "plan" else lib.int8_conv_pick(*args, PICKS[pick])
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed ({pick} route): {lib.int8_conv_error_string(rc).decode()}")
    return out


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, stride: int, padding: int, groups: int,
                    act: int, sout: float, sin: float = 0.0) -> Tensor:
    out = _int8_conv_launch(x, w, scale, bias, stride, padding, groups, act, sout, sin)
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


def int8_conv_plan(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, groups: int, stride: int = 1,
                   padding: Optional[int] = None, pick: str = "plan") -> dict:
    """The route csrc/int8_conv.cu takes for these CUDA tensors (x channels-last NCHW or a channel slice of one, w
    OHWI, out its output, int8 or bf16; the padding defaults to the model's k // 2): {"route": "gemm1x1" | "gemm" |
    "depthwise" | "direct", "n_tile", "m_tile" (the M tile of the GEMM routes), "granule" (route 1's copy granule),
    "smem" (the launch's dynamic shared memory, bytes), "a_sets", "n_groups", "blocks_per_sm", "whole_table"
    (gemm1x1's sets of A slots, groups of N tiles, blocks an SM, and whether it reads the requant table
    uncompressed), "pitch" (x's pixel pitch)}. `pick` as `_int8_conv_launch`'s: where the route named cannot run, the
    route is None."""
    pitch = x_pitch(x)
    if pitch is None:
        raise ValueError(f"int8_conv_plan: x of strides {x.stride()} is not a layout the kernel reads")
    b, cin, h, wd = x.shape
    cout, kh, kw, _ = w.shape
    plan = (ctypes.c_int * 10)()
    rc = _int8_lib().int8_conv_plan(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, cin, pitch, out.shape[2],
                                    out.shape[3], cout, kh, kw, stride, kh // 2 if padding is None else padding,
                                    groups, X_TYPES[x.dtype], 1.0 if out.dtype == torch.int8 else 0.0, PICKS[pick],
                                    x.device.index, plan)
    if rc != 0:
        raise RuntimeError(f"int8_conv_plan failed: {_int8_lib().int8_conv_error_string(rc).decode()}")
    return {"route": ROUTES[plan[0]] if plan[0] >= 0 else None, "n_tile": plan[1], "m_tile": plan[9],
            "granule": plan[3], "smem": plan[4], "a_sets": plan[5], "n_groups": plan[6], "blocks_per_sm": plan[7],
            "whole_table": bool(plan[8]), "pitch": pitch}


def _int8_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("int8_conv")
    if lib.int8_conv.argtypes is None:  # declare the C signatures once per process
        lib.int8_conv.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_float, ctypes.c_float,
                                                                                 ctypes.c_void_p, ctypes.c_int,
                                                                                 ctypes.c_void_p]
        lib.int8_conv.restype = ctypes.c_int
        lib.int8_conv_pick.argtypes = lib.int8_conv.argtypes + [ctypes.c_int]
        lib.int8_conv_pick.restype = ctypes.c_int
        lib.int8_conv_table.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.int8_conv_table.restype = ctypes.c_int
        lib.int8_conv_table_bytes.argtypes = []
        lib.int8_conv_table_bytes.restype = ctypes.c_int
        lib.int8_conv_plan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_float, ctypes.c_int,
                                                                                 ctypes.c_int,
                                                                                 ctypes.POINTER(ctypes.c_int)]
        lib.int8_conv_plan.restype = ctypes.c_int
        lib.int8_conv_error_string.argtypes = [ctypes.c_int]
        lib.int8_conv_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- candidate select + DFL decode (K3) ----------------


def select_decode_plain(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int,
                        conf_thres: float, max_cand: int, class_mask: Optional[torch.Tensor] = None,
                        half: bool = False, multi_label: bool = False, agnostic: bool = False):
    """Plain torch K3, steps 1-4 of ops/nms.py nms_from_feats over per-level (B, H, W, 4*reg_max + nc) maps.

    1-2. the sigmoid of the class logits (in the maps' dtype with half, else
         fp32), `class_mask` (masked scores are 0), the per-anchor max and
         argmax over the sigmoid (or the flat anchor x class row with
         multi_label and nc > 1), the gate where(s > conf, s, -1) and the
         top K = min(max_cand, N) in lax.top_k's order;
    3.   the K candidates' box logits through the DFL expectation (fp32);
    4.   anchor centres and strides rebuilt from the anchor index.
    Returns vals (B, K) float32 (the scores' values, exact), the anchor index
    bidx (B, K) int64, the class cls (B, K) float32, the boxes (B, K, 4)
    float32 xyxy pixels, the class-offset boxes `shifted` (B, K, 4) (cls *
    MAX_WH added, nothing with agnostic) and valid = vals > max(conf, 0)
    (B, K) bool, compared in the scores' dtype.
    """
    B = feats[0].shape[0]
    ml = multi_label and nc > 1
    scores, clss = [], []
    for f in feats:
        cl = f[..., 4 * reg_max:]
        s_full = torch.sigmoid(cl if half else cl.float())
        if class_mask is not None:
            s_full = torch.where(class_mask, s_full, 0.0)
        if ml:  # flat (anchor x class) index = anchor * nc + class
            scores.append(s_full.reshape(B, -1))
        else:
            scores.append(s_full.amax(-1).reshape(B, -1))
            clss.append(s_full.argmax(-1).reshape(B, -1))
    s = torch.cat(scores, 1)
    vals, sel = topk_stable(torch.where(s > conf_thres, s, -1.0), min(max_cand, s.shape[1]))
    if ml:
        bidx, cls = sel // nc, (sel % nc).float()
    else:
        bidx, cls = sel, torch.gather(torch.cat(clss, 1), 1, sel).float()

    # 3: candidate box logits -> DFL expectation (fp32)
    box_logits = torch.cat([f[..., : 4 * reg_max].reshape(B, -1, 4 * reg_max) for f in feats], 1)
    rows = torch.gather(box_logits, 1, bidx[..., None].expand(-1, -1, box_logits.shape[-1]))
    dist = dfl_expectation_plain(rows, reg_max)  # (B, K, 4): K5's plain version, as K3's is plain

    # 4: arithmetic anchors (grid x/y + 0.5, per-level stride) from bidx
    offs, Ws, Ss, o = [], [], [], 0
    for f, s_ in zip(feats, strides):
        offs.append(o)
        Ws.append(f.shape[2])
        Ss.append(int(s_))
        o += f.shape[1] * f.shape[2]
    lvl = torch.zeros_like(bidx)
    for i in range(1, len(offs)):
        lvl = torch.where(bidx >= offs[i], i, lvl)
    # per-level constants picked with where() rather than indexing a host list: no copy to the device
    off_l = sum(torch.where(lvl == i, offs[i], 0) for i in range(len(offs)))
    W_l = sum(torch.where(lvl == i, Ws[i], 0) for i in range(len(offs)))
    S_l = sum(torch.where(lvl == i, Ss[i], 0) for i in range(len(offs))).float()
    local = bidx - off_l
    ax = (local % W_l).float() + 0.5
    ay = (local // W_l).float() + 0.5
    boxes = torch.stack(
        [(ax - dist[..., 0]) * S_l, (ay - dist[..., 1]) * S_l, (ax + dist[..., 2]) * S_l, (ay + dist[..., 3]) * S_l],
        -1,
    )
    valid = vals > max(conf_thres, 0.0)
    offset = torch.zeros_like(cls) if agnostic else cls * MAX_WH
    return vals.float(), bidx, cls, boxes, boxes + offset[..., None], valid


SCORE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # K3's map and score type codes
SELECT_MAX_LEVELS = 16  # level descriptors csrc/select_decode.cu carries in its launch parameters
SELECT_ROUTES = ("passes", "finish", "cluster")  # csrc/select_decode.cu's routes, by code
SELECT_SCORES = ("anchor", "anchor_vec", "plane", "entry", "entry_vec")  # its score-pass kernels, by code


def _gate_threshold(conf: float, score_type: torch.dtype) -> float:
    """The threshold as torch compares a tensor of score_type with the Python float conf: the float rounded to
    fp32, then to score_type (returned as the float of that value)."""
    return torch.tensor(float(conf), dtype=torch.float32).to(score_type).item()


def _n_entries(feats: Sequence[torch.Tensor], nc: int, multi_label: bool) -> int:
    """Entries of one image's score row: anchors, times nc with multi_label and nc > 1."""
    return sum(int(f.shape[1]) * int(f.shape[2]) for f in feats) * (nc if multi_label and nc > 1 else 1)


def select_decode(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int, conf_thres: float,
                  max_cand: int, class_mask: Optional[torch.Tensor] = None, half: bool = False,
                  multi_label: bool = False, agnostic: bool = False):
    """Candidate select + DFL decode of per-level (B, H, W, 4*reg_max + nc) maps -> (vals, bidx, cls, boxes, shifted,
    valid), as `select_decode_plain` returns them.

    The maps may be any strided views (the predictor's are NHWC views of the
    net's NCHW outputs); on the card they are read where they lie. A CUDA
    tensor goes through csrc/select_decode.cu (maps fp32, bf16 or fp16, all
    of one dtype, one launch, no host sync), a CPU tensor through
    `select_decode_plain`; both as the op
    `torch.ops.yololite_tpu_torch.select_decode`. Any other input raises.
    Card calls are counted in `.launches` and, by the route the kernel took,
    in `.by_route` (`SELECT_ROUTES`).
    """
    if max_cand < 0 or not len(feats) or len(strides) != len(feats):
        raise ValueError(f"select_decode: max_cand {max_cand}, {len(feats)} levels, {len(strides)} strides")
    dev = feats[0].device
    if any(f.device != dev for f in feats) or (class_mask is not None and class_mask.device != dev):
        raise ValueError(f"select_decode: maps on {[str(f.device) for f in feats]}, class_mask on "
                         f"{None if class_mask is None else class_mask.device}")
    if dev.type == "cuda":
        if len(feats) > SELECT_MAX_LEVELS:
            raise ValueError(f"select_decode takes at most {SELECT_MAX_LEVELS} levels on the card, got {len(feats)}")
        if feats[0].dtype not in SCORE_TYPES or any(f.dtype != feats[0].dtype for f in feats):
            raise TypeError(f"select_decode wants maps of one dtype out of fp32, bf16, fp16, got "
                            f"{[f.dtype for f in feats]}")
        b = feats[0].shape[0]
        if any(f.ndim != 4 or f.shape[0] != b or f.shape[3] != 4 * reg_max + nc for f in feats) or nc < 1 or \
                reg_max < 1:
            raise ValueError(f"select_decode wants (B, H, W, 4*{reg_max} + {nc}) maps, got "
                             f"{[tuple(f.shape) for f in feats]}")
        if class_mask is not None and (class_mask.dtype != torch.bool or tuple(class_mask.shape) != (nc,)):
            raise ValueError(f"select_decode wants a bool (nc,) class_mask, got {class_mask.dtype} "
                             f"{tuple(class_mask.shape)}")
    elif dev.type != "cpu":
        raise ValueError(f"select_decode: unsupported device {dev}")
    return torch.ops.yololite_tpu_torch.select_decode(list(feats), [int(s) for s in strides], int(nc), int(reg_max),
                                                      float(conf_thres), int(max_cand), class_mask, bool(half),
                                                      bool(multi_label), bool(agnostic))


class _RouteCounts:
    """K3's launches by the route csrc/select_decode.cu took: one counter a route of `SELECT_ROUTES`."""

    def __init__(self):
        self.passes = self.finish = self.cluster = 0

    def as_dict(self) -> dict:
        return {r: getattr(self, r) for r in SELECT_ROUTES}

    def reset(self):
        self.passes = self.finish = self.cluster = 0


select_decode.launches = 0  # kernel launches since the last reset
select_decode.by_route = _RouteCounts()  # the same launches by route (engine/graphs.py advances both on a replay)


@torch.library.custom_op("yololite_tpu_torch::select_decode", mutates_args=(), device_types="cpu")
def _select_decode_op(feats: List[Tensor], strides: List[int], nc: int, reg_max: int, conf_thres: float,
                      max_cand: int, class_mask: Optional[Tensor], half: bool, multi_label: bool,
                      agnostic: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    out = select_decode_plain(feats, strides, nc, reg_max, conf_thres, max_cand, class_mask, half, multi_label,
                              agnostic)
    return tuple(t.clone(memory_format=torch.contiguous_format) for t in out)  # fresh and contiguous, as the fake


def _select_decode_empty(feats, nc: int, max_cand: int, multi_label: bool):
    b, dev = feats[0].shape[0], feats[0].device
    k = min(max_cand, _n_entries(feats, nc, multi_label))
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((b, k), **f32), torch.empty((b, k), dtype=torch.int64, device=dev), torch.empty((b, k), **f32),
            torch.empty((b, k, 4), **f32), torch.empty((b, k, 4), **f32),
            torch.empty((b, k), dtype=torch.bool, device=dev))


def _level_args(feats: Sequence[Tensor], strides: Optional[Sequence[int]] = None):
    """The levels as csrc/select_decode.cu takes them: pointers, element strides, (H, W) and strides in pixels."""
    n = len(feats)
    ptrs = (ctypes.c_uint64 * n)(*[f.data_ptr() for f in feats])
    strd = (ctypes.c_longlong * (4 * n))(*[s for f in feats for s in f.stride()])
    hw = (ctypes.c_int * (2 * n))(*[d for f in feats for d in (f.shape[1], f.shape[2])])
    px = None if strides is None else (ctypes.c_float * n)(*[float(s) for s in strides])
    return ptrs, strd, hw, px


def _select_decode_launch(feats: List[Tensor], strides: List[int], nc: int, reg_max: int, conf_thres: float,
                          max_cand: int, class_mask: Optional[Tensor], half: bool, multi_label: bool,
                          agnostic: bool, score_only: bool = False, route: str = "plan"):
    """One launch sequence of csrc/select_decode.cu into fresh outputs, down `route` ("plan": the one the shapes
    pick; else a name of `SELECT_ROUTES`, which raises where that route cannot take these shapes: for timing the
    routes on the same inputs). `score_only`: the memset and the score pass alone, into the workspace, for timing
    them. Returns the outputs and the route taken (None where nothing was launched)."""
    out = _select_decode_empty(feats, nc, max_cand, multi_label)
    vals, bidx, cls, boxes, shifted, valid = out
    b, k = vals.shape
    if b == 0 or k == 0:
        return out, None
    dev = feats[0].device
    ml = multi_label and nc > 1
    score_type = feats[0].dtype if half else torch.float32  # what the plain version's sigmoid computes in
    thr, valid_thr = _gate_threshold(conf_thres, score_type), _gate_threshold(max(conf_thres, 0.0), score_type)
    a = sum(int(f.shape[1]) * int(f.shape[2]) for f in feats)
    lib = _select_lib()
    ptrs, strd, hw, px = _level_args(feats, strides)
    nbytes = lib.select_decode_workspace_bytes(len(feats), b, a, nc, int(ml), k)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)  # PyTorch's current stream, as an int
    mask = None if class_mask is None else class_mask.contiguous().data_ptr()
    taken = ctypes.c_int(-1)
    args = (len(feats), ptrs, strd, hw, px, SCORE_TYPES[feats[0].dtype], b, nc, reg_max, int(ml), k, thr, valid_thr,
            SCORE_TYPES[score_type], mask, int(agnostic), workspace.data_ptr(), nbytes, vals.data_ptr(),
            bidx.data_ptr(), cls.data_ptr(), boxes.data_ptr(), shifted.data_ptr(), valid.data_ptr(), dev.index, stream)
    if score_only:
        rc = lib.select_decode_score(*args, _route_code(route), ctypes.byref(taken))
    elif route == "plan":
        rc = lib.select_decode(*args, ctypes.byref(taken))
    else:
        rc = lib.select_decode_pick(*args, _route_code(route), ctypes.byref(taken))
    if rc != 0:
        raise RuntimeError(f"select_decode kernel launch failed (route {route}): "
                           f"{lib.select_decode_error_string(rc).decode()}")
    return out, SELECT_ROUTES[taken.value]


def _route_code(route: str) -> int:
    if route != "plan" and route not in SELECT_ROUTES:
        raise ValueError(f"select_decode: route {route!r} is none of plan, {', '.join(SELECT_ROUTES)}")
    return -1 if route == "plan" else SELECT_ROUTES.index(route)


@_select_decode_op.register_kernel("cuda")
def _select_decode_cuda(feats: List[Tensor], strides: List[int], nc: int, reg_max: int, conf_thres: float,
                        max_cand: int, class_mask: Optional[Tensor], half: bool, multi_label: bool,
                        agnostic: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    out, route = _select_decode_launch(feats, strides, nc, reg_max, conf_thres, max_cand, class_mask, half,
                                       multi_label, agnostic)
    if route is not None:
        select_decode.launches += 1
        setattr(select_decode.by_route, route, getattr(select_decode.by_route, route) + 1)
    return out


def sigmoid_monotone(device: torch.device) -> bool:
    """Whether K3's score function (torch's CUDA sigmoid, bit for bit) is monotone non-decreasing over every non-NaN
    fp32 on this card, checked exhaustively by csrc/select_decode.cu's check kernel. The single-label score pass
    relies on it: it takes the largest logits and computes the sigmoid of those alone. The card tests and
    chip_smoke.py run it; the path does not."""
    lib = _select_lib()
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    rc = lib.select_decode_sigmoid_check(bad.data_ptr(), bad.device.index,
                                         torch._C._cuda_getCurrentRawStream(bad.device.index))
    if rc != 0:
        raise RuntimeError(f"select_decode check kernel launch failed: {lib.select_decode_error_string(rc).decode()}")
    return int(bad.item()) == 0


def select_decode_plan(feats: Sequence[torch.Tensor], nc: int, reg_max: int, max_cand: int,
                       multi_label: bool = False, route: str = "plan") -> dict:
    """The route csrc/select_decode.cu takes for these CUDA maps: {"route": "finish" | "cluster" | "passes" (None
    where a named `route` cannot take these shapes), "score" (the score pass's kernel), "launches" (kernels a
    call launches), "reps" (finishing CTAs an image), "smem" (a finishing or cluster CTA's dynamic shared memory,
    bytes), "cluster" (the cluster's CTAs an image), "max_active_clusters" (cudaOccupancyMaxActiveClusters at
    that size), "tie_cap" and "slack" (a cluster CTA's tie list and the candidates past K its order may take, in
    entries)}. The rule lives in the kernel's `plan`, from the shapes and strides alone (and the card's
    occupancy, for the cluster size); `route` names one to report on, as `_select_decode_launch` takes it."""
    b = int(feats[0].shape[0])
    k = min(max_cand, _n_entries(feats, nc, multi_label))
    ptrs, strd, hw, _ = _level_args(feats)
    plan = (ctypes.c_int * 9)()
    lib = _select_lib()
    rc = lib.select_decode_plan(len(feats), ptrs, strd, hw, SCORE_TYPES[feats[0].dtype], b, nc, reg_max,
                                int(multi_label and nc > 1), k, feats[0].device.index or 0, _route_code(route), plan)
    if rc != 0:
        raise RuntimeError(f"select_decode_plan failed: {lib.select_decode_error_string(rc).decode()}")
    return {"route": SELECT_ROUTES[plan[0]] if plan[0] >= 0 else None, "score": SELECT_SCORES[plan[1]],
            "launches": plan[2], "reps": plan[3], "smem": plan[4], "cluster": plan[5], "max_active_clusters": plan[6],
            "tie_cap": plan[7], "slack": plan[8]}


@_select_decode_op.register_fake
def _select_decode_fake(feats: List[Tensor], strides: List[int], nc: int, reg_max: int, conf_thres: float,
                        max_cand: int, class_mask: Optional[Tensor], half: bool, multi_label: bool,
                        agnostic: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    return _select_decode_empty(feats, nc, max_cand, multi_label)


def _select_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("select_decode")
    if lib.select_decode.argtypes is None:  # declare the C signatures once per process
        levels = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_longlong),
                  ctypes.POINTER(ctypes.c_int)]
        call = levels + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong] + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
        lib.select_decode.argtypes = call + [ctypes.POINTER(ctypes.c_int)]
        lib.select_decode.restype = ctypes.c_int
        lib.select_decode_pick.argtypes = call + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.select_decode_pick.restype = ctypes.c_int
        lib.select_decode_score.argtypes = lib.select_decode_pick.argtypes
        lib.select_decode_score.restype = ctypes.c_int
        lib.select_decode_sigmoid_check.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.select_decode_sigmoid_check.restype = ctypes.c_int
        lib.select_decode_plan.argtypes = levels + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
        lib.select_decode_plan.restype = ctypes.c_int
        lib.select_decode_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int, ctypes.c_int]
        lib.select_decode_workspace_bytes.restype = ctypes.c_longlong
        lib.select_decode_error_string.argtypes = [ctypes.c_int]
        lib.select_decode_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- device letterbox (K2) ----------------


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


def letterbox_geometry(h0: int, w0: int, imgsz: int):
    """(new_h, new_w, top, left) of the reference letterbox: r = min(S/H0, S/W0), round() new size, centred
    round(d-0.1)/round(d+0.1) padding."""
    r = min(imgsz / h0, imgsz / w0)
    new_w, new_h = int(round(w0 * r)), int(round(h0 * r))
    dw, dh = (imgsz - new_w) / 2, (imgsz - new_h) / 2
    return new_h, new_w, int(round(dh - 0.1)), int(round(dw - 0.1))


def device_letterbox_plain(images: torch.Tensor, imgsz: int = 640, out_dtype: torch.dtype = torch.float32,
                           bgr: bool = False) -> torch.Tensor:
    """Plain torch K2: (B, H0, W0, 3) uint8 (RGB, or BGR with bgr) -> (B, imgsz, imgsz, 3) RGB in [0, 1], contiguous.

    The resize as two fp32 matmuls with `_interp_matrix` (rows, then
    columns), the pad with 114, then x * (1/255) and the cast to out_dtype.
    """
    b, h0, w0, c = images.shape
    new_h, new_w, top, left = letterbox_geometry(h0, w0, imgsz)
    bottom, right = imgsz - new_h - top, imgsz - new_w - left

    x = (images.flip(-1) if bgr else images).float()
    if (new_h, new_w) != (h0, w0):
        ry = _interp_on(new_h, h0, images.device)  # (new_h, h0)
        rx = _interp_on(new_w, w0, images.device)  # (new_w, w0)
        x = torch.einsum("yh,bhwc->bywc", ry, x)
        x = torch.einsum("xw,bywc->byxc", rx, x)
    x = F.pad(x, (0, 0, left, right, top, bottom), value=114.0)
    return (x * (1.0 / 255.0)).to(out_dtype)  # as XLA lowers the JAX package's x / 255: the pad's bits match


def device_letterbox(images: torch.Tensor, imgsz: int = 640, out_dtype: torch.dtype = torch.float32,
                     bgr: bool = False, channels_last: bool = True) -> torch.Tensor:
    """Batched letterbox on the images' device for same-shape inputs.

    images: (B, H0, W0, 3) uint8, RGB (or BGR with bgr: the channels are
    reversed as they are read). Returns (B, imgsz, imgsz, 3) RGB in [0, 1]
    in out_dtype, with the reference geometry (`letterbox_geometry`), 114-gray
    fill. With channels_last the result is contiguous; without, it is the
    NHWC view of an NCHW-contiguous tensor, so `permute(0, 3, 1, 2)` gives
    the net an NCHW-contiguous input without a copy. A CUDA tensor goes
    through csrc/letterbox.cu, a CPU tensor through `device_letterbox_plain`,
    both as the op `torch.ops.yololite_tpu_torch.device_letterbox`.
    """
    if images.dtype != torch.uint8 or images.ndim != 4 or images.shape[3] != 3:
        raise TypeError(f"device_letterbox wants a (B, H0, W0, 3) uint8 batch, got {images.dtype} "
                        f"{tuple(images.shape)}")
    if out_dtype not in SCORE_TYPES or imgsz < 1:
        raise ValueError(f"device_letterbox: out_dtype {out_dtype}, imgsz {imgsz}")
    if images.device.type not in ("cuda", "cpu"):
        raise ValueError(f"device_letterbox: unsupported device {images.device}")
    out = torch.ops.yololite_tpu_torch.device_letterbox(images.contiguous(), int(imgsz), out_dtype, bool(bgr),
                                                        bool(channels_last))
    return out if channels_last else out.permute(0, 2, 3, 1)


device_letterbox.launches = 0  # kernel launches since the last reset


@torch.library.custom_op("yololite_tpu_torch::device_letterbox", mutates_args=(), device_types="cpu")
def _device_letterbox_op(images: Tensor, imgsz: int, out_dtype: torch.dtype, bgr: bool,
                         channels_last: bool) -> Tensor:
    """The letterbox in its storage layout: (B, S, S, 3) contiguous with channels_last, else (B, 3, S, S)."""
    x = device_letterbox_plain(images, imgsz, out_dtype, bgr)  # a new contiguous tensor
    return x if channels_last else x.permute(0, 3, 1, 2).contiguous()


def _device_letterbox_empty(images: Tensor, imgsz: int, out_dtype: torch.dtype, channels_last: bool) -> Tensor:
    b = images.shape[0]
    shape = (b, imgsz, imgsz, 3) if channels_last else (b, 3, imgsz, imgsz)
    return torch.empty(shape, dtype=out_dtype, device=images.device)


@_device_letterbox_op.register_kernel("cuda")
def _device_letterbox_cuda(images: Tensor, imgsz: int, out_dtype: torch.dtype, bgr: bool,
                           channels_last: bool) -> Tensor:
    out = _device_letterbox_empty(images, imgsz, out_dtype, channels_last)
    b, h0, w0, _ = images.shape
    if out.numel() == 0:
        return out
    new_h, new_w, top, left = letterbox_geometry(h0, w0, imgsz)
    stream = torch._C._cuda_getCurrentRawStream(images.device.index)
    lib = _letterbox_lib()
    rc = lib.device_letterbox(images.data_ptr(), out.data_ptr(), b, h0, w0, imgsz, new_h, new_w, top, left,
                              SCORE_TYPES[out_dtype], int(bgr), int(channels_last), images.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"device_letterbox kernel launch failed: {lib.device_letterbox_error_string(rc).decode()}")
    device_letterbox.launches += 1
    return out


@_device_letterbox_op.register_fake
def _device_letterbox_fake(images: Tensor, imgsz: int, out_dtype: torch.dtype, bgr: bool,
                           channels_last: bool) -> Tensor:
    return _device_letterbox_empty(images, imgsz, out_dtype, channels_last)


def _letterbox_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("letterbox")
    if lib.device_letterbox.argtypes is None:  # declare the C signatures once per process
        lib.device_letterbox.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        lib.device_letterbox.restype = ctypes.c_int
        lib.device_letterbox_error_string.argtypes = [ctypes.c_int]
        lib.device_letterbox_error_string.restype = ctypes.c_char_p
    return lib


# the wrappers that count their kernel's launches, those of the loss tail (ops/loss_kernels.py) and the apply
# (ops/optim_kernels.py) included
COUNTED = (greedy_nms_keep, blocked_nms_finalize, int8_conv, select_decode, device_letterbox, *loss_kernels.COUNTED,
           *optim_kernels.COUNTED)
