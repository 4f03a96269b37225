"""The train step's loss-tail kernels and their plain versions (K5, K6a, K6b, K7, K9).

1. `dfl_expectation` (K5): the DFL expectation of each side's softmax over
   its reg_max bins, (..., 4R) logits -> (..., 4) fp32, with the closed-form
   backward `dfl_expectation_backward`. On a CUDA tensor both launch
   csrc/dfl.cu, which replaces yololite_tpu/ops/decode.py:75
   `dfl_expectation_mm` and its custom vjp (:100, :105); on a CPU tensor they
   run `dfl_expectation_plain` and `dfl_expectation_backward_plain`.
2. `dfl_ce_mean` (K6a): the two-hot DFL cross-entropy, the mean of the 4
   sides, (..., 4R) logits and (..., 4) targets -> (..., 1) fp32, with its
   backward `dfl_ce_backward`: csrc/dfl.cu, which replaces
   yololite_tpu/utils/loss.py:238 `dfl_ce_mean` (:197, :254, :259); plain
   `dfl_ce_plain` and `dfl_ce_backward_plain`.
3. `bce_sum` (K6b): the sum of BCE with logits in fp32, with its backward
   `bce_sum_backward` (sigmoid(x) - y in the logits' dtype): csrc/bce_sum.cu,
   which replaces yololite_tpu/utils/loss.py:284 `bce_sum` (:297, :301); plain
   `bce_sum_plain` and `bce_sum_backward_plain`.
4. `topk_rows` (K7): the top k <= 32 of every row, values descending, ties to
   the lower index (lax.top_k's order), no gradient: csrc/topk_rows.cu, which
   replaces yololite_tpu/utils/tal.py:61 `topk_blockmax_gather` and :97
   `topk_hierarchical`; plain `ops/boxes.py topk_stable` (a stable sort).
5. `compact_rows` (K9): the compact box/DFL form's foreground gather, the
   (B, K) indices of lax.top_k over the (B, A) foreground mask (foreground
   rows first, then the other rows, each in index order) and the (B, K, C)
   rows of the logits at them, with the backward `compact_rows_backward`
   (the rows' gradient put back into a dense (B, A, C) one): csrc/compact_rows.cu,
   which replaces yololite_tpu/utils/loss.py:162-172 (`lax.top_k` and the
   one-hot contraction); plain `compact_rows_plain` (`topk_stable`, then
   torch.gather) and `compact_rows_backward_plain`.

Each is a `torch.library` custom op (`torch.ops.yololite_tpu_torch.*`): the
CUDA implementation launches the kernel or raises, the CPU one is the plain
version, a fake gives the output's shape. K5, K6a, K6b and K9 have autograd
registered on the op, whose backward is the backward kernel's own op, so
`torch.export` records a decode as one op and a CUDA graph of the train step
captures both kernels. The public wrappers check their inputs, call the op,
and count the kernel's launches (`.launches`); a CUDA tensor never reaches a
plain version. The logits are read where they lie: the loss's box and class
logits are column slices of the (B, A, 4R + nc) Detect maps, taken as rows
with a row stride, never copied. The wrappers pick every kernel's route from
the layout (`dfl_plan` for K5 and K6a, `bce_sum_plan`, `topk_rows_plan`,
`compact_rows_plan`), and each C entry refuses a route the layout does not
allow.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from yololite_tpu_torch.ops.boxes import topk_stable  # K7's plain version

# the types each kernel takes on the card, by code: logits in the fp32 step, under amp and in the float64 reference
# step; labels fp32 or bf16 (the amp path's target scores); metrics fp32 (or fp64 in the reference step)
X_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
LABEL_TYPES = {torch.float32: 0, torch.bfloat16: 1}
METRIC_TYPES = {torch.float32: 0, torch.float64: 1}
MAX_REG = 64  # reg_max csrc/dfl.cu takes
MAX_K = 32  # k csrc/topk_rows.cu takes
# csrc/topk_rows.cu's block of TOPK_THREADS takes a row, each thread holding TOPK_ITEMS values in registers: the first
# that holds the row (A 2,100 at imgsz 320, 8,400 at 640); a longer row streams (items 0, loaded again in each pass)
TOPK_THREADS = 256
TOPK_ITEMS = (12, 36)
BCE_CHUNK = 256 * 4  # pieces a block of csrc/bce_sum.cu takes (256 threads, 4 pieces each): one partial of the sum

# ---------------- plain versions ----------------


def _dfl_mm_parts(box_logits: Tensor, reg_max: int):
    """K5's forward body: the expectation E (..., 4) and each side's max m (..., 4, 1) and sum of exp z (..., 4).

    Each side is shifted by its own max before exp, so a side far below
    another side's logits keeps exp(0) = 1 in its denominator and cannot
    underflow to 0/0.
    """
    x = box_logits.float().unflatten(-1, (4, reg_max))
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    z = e.sum(-1)
    return (e * proj).sum(-1) / z, m, z


def dfl_expectation_plain(box_logits: Tensor, reg_max: int = 16) -> Tensor:
    """Plain K5: (..., 4*reg_max) -> (..., 4) fp32, the expected bin under each side's softmax."""
    return _dfl_mm_parts(box_logits, reg_max)[0]


def dfl_expectation_backward_plain(box_logits: Tensor, g: Tensor, reg_max: int = 16) -> Tensor:
    """Plain K5 backward: dE/dx_j = softmax_j * (j - E) per side, times g (..., 4), in the logits' dtype."""
    out, m, z = _dfl_mm_parts(box_logits, reg_max)
    xs = box_logits.float().unflatten(-1, (4, reg_max))
    sm = torch.exp(xs - m) / z[..., None]
    proj = torch.arange(reg_max, dtype=torch.float32, device=xs.device)
    dx = sm * (proj - out[..., None]) * g.float()[..., None]
    return dx.flatten(-2).to(box_logits.dtype)


def _dfl_ce_parts(pred_dist: Tensor, target: Tensor):
    """K6a's forward body: (..., 4R) logits, (..., 4) continuous bins -> ce (..., 1), the mean of 4 sides, and the
    backward's residuals (m, z, tl, tr, wl, wr). Each side's logsumexp is shifted by that side's own max."""
    R = pred_dist.shape[-1] // 4
    x = pred_dist.float().unflatten(-1, (4, R))  # (..., 4, R)
    target = target.clamp(0, R - 1 - 0.01)
    tl = target.long()
    tr = tl + 1
    wl = tr.float() - target.float()
    wr = 1 - wl
    m = x.amax(-1)  # (..., 4)
    z = torch.exp(x - m[..., None]).sum(-1)
    lse = torch.log(z) + m
    x_l = torch.gather(x, -1, tl[..., None]).squeeze(-1)
    x_r = torch.gather(x, -1, tr.clamp(max=R - 1)[..., None]).squeeze(-1)
    ce = ((lse - x_l) * wl + (lse - x_r) * wr).mean(-1, keepdim=True)
    return ce, (m, z, tl, tr, wl, wr)


def dfl_ce_plain(pred_dist: Tensor, target: Tensor) -> Tensor:
    """Plain K6a: the DFL cross-entropy (..., 1) fp32."""
    return _dfl_ce_parts(pred_dist, target)[0]


def dfl_ce_backward_plain(pred_dist: Tensor, target: Tensor, g: Tensor) -> Tensor:
    """Plain K6a backward: d ce / d x_j = (softmax_j - y_j) / 4 per side, y the two-hot target (wl at tl, wr at
    tr), times g (..., 1), in the logits' dtype."""
    _, (m, z, tl, tr, wl, wr) = _dfl_ce_parts(pred_dist, target)
    R = pred_dist.shape[-1] // 4
    xs = pred_dist.float().unflatten(-1, (4, R))
    sm = torch.exp(xs - m[..., None]) / z[..., None]
    y = torch.zeros_like(sm).scatter_(-1, tl[..., None], wl[..., None])
    y = y.scatter_add_(-1, tr.clamp(max=R - 1)[..., None], wr[..., None])
    dx = (sm - y) * (g.float() * 0.25)[..., None]  # g (..., 1) broadcasts over the sides and bins
    return dx.flatten(-2).to(pred_dist.dtype)


def sigmoid_bce(logits: Tensor, labels: Tensor) -> Tensor:
    """Numerically stable BCE with logits, elementwise."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def bce_sum_plain(logits: Tensor, labels: Tensor) -> Tensor:
    """Plain K6b: the sum of BCE with logits, in fp32 whatever the inputs' dtypes."""
    return sigmoid_bce(logits.float(), labels.float()).sum()


def bce_sum_backward_plain(logits: Tensor, labels: Tensor, g: Tensor) -> Tensor:
    """Plain K6b backward: (sigmoid(x) - y) * g, computed in the logits' dtype (bf16 under amp)."""
    return (torch.sigmoid(logits) - labels.to(logits.dtype)) * g.to(logits.dtype)


# ---------------- layouts ----------------


def _rows_of(x: Tensor) -> Tuple[int, int]:
    """(rows, row stride in elements) of x read as a (rows, x.shape[-1]) matrix without a copy: the last dim
    contiguous and the leading dims one even step apart. Raises for any other layout."""
    if x.dim() == 0:
        raise ValueError("a kernel of ops/loss_kernels.py takes a tensor of at least one dim")
    n = x.shape[-1]
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    if n > 1 and x.stride(-1) != 1:
        raise ValueError(f"the last dim must be contiguous, got strides {x.stride()} for shape {tuple(x.shape)}")
    if rows == 0:
        return 0, n
    step, span = None, None
    for size, stride in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if size == 1:
            continue
        if step is None:
            step = stride
        elif stride != span:
            raise ValueError(f"rows of shape {tuple(x.shape)} with strides {x.stride()} are not evenly spaced")
        span = stride * size
    if step is None:
        return rows, n
    if rows > 1 and step < n:
        raise ValueError(f"rows of shape {tuple(x.shape)} with strides {x.stride()} overlap")
    return rows, step


def _check_types(name: str, t: Tensor, types: dict) -> None:
    if t.dtype not in types:
        raise TypeError(f"{name} takes {', '.join(str(d).split('.')[-1] for d in types)} on the card, got {t.dtype}")


def _check_device(name: str, *tensors: Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)  # PyTorch's current stream, as an int


def _vec16(x: Tensor, rs: int) -> bool:
    """x's rows can be read in 16-byte pieces: its pointer and its row stride in bytes are multiples of 16."""
    return x.data_ptr() % 16 == 0 and rs * x.element_size() % 16 == 0


# ---------------- K5 and K6a: the route csrc/dfl.cu takes ----------------


def dfl_plan(logits: Tensor) -> dict:
    """The route csrc/dfl.cu takes for K5 and K6a, forward and backward, on these (..., 4R) logits (as
    `dfl_expectation` and `dfl_ce_mean` take them): {"route": "lanes" (R 16: 8 lanes a row, 16-byte loads),
    "lanes-scalar" (R 16, a layout 16-byte loads cannot read: the same kernels, one element at a time) or "generic"
    (another R: a thread a side), "rows", "row_stride"}. The rule lives here; the kernel holds the wrapper to it."""
    rows, rs = _rows_of(logits)
    if logits.shape[-1] != 64:
        route = "generic"
    else:
        route = "lanes" if _vec16(logits, rs) else "lanes-scalar"
    return {"route": route, "rows": rows, "row_stride": rs}


# ---------------- K5: the DFL expectation ----------------


def dfl_expectation(box_logits: Tensor, reg_max: int = 16) -> Tensor:
    """(..., 4*reg_max) logits -> (..., 4) fp32, the expected bin under each side's softmax; differentiable, with
    `dfl_expectation_backward`. On the card the logits are fp32, bf16 or fp64, their last dim contiguous and their
    rows evenly spaced.

    A CUDA tensor goes through csrc/dfl.cu, a CPU tensor through
    `dfl_expectation_plain`; both as the op
    `torch.ops.yololite_tpu_torch.dfl_expectation`. Any other input raises.
    """
    if box_logits.dim() == 0 or box_logits.shape[-1] != 4 * reg_max or not 1 <= reg_max <= MAX_REG:
        raise ValueError(f"dfl_expectation wants (..., 4 * {reg_max}) logits, reg_max <= {MAX_REG}, got "
                         f"{tuple(box_logits.shape)}")
    if _check_device("dfl_expectation", box_logits) == "cuda":
        _check_types("dfl_expectation", box_logits, X_TYPES)
    return torch.ops.yololite_tpu_torch.dfl_expectation(box_logits, int(reg_max))


dfl_expectation.launches = 0  # kernel launches since the last reset


def dfl_expectation_backward(box_logits: Tensor, g: Tensor, reg_max: int = 16) -> Tensor:
    """K5's backward: the logits (as `dfl_expectation` took them) and the gradient of its output g (..., 4) -> dx
    (..., 4*reg_max) contiguous, in the logits' dtype. csrc/dfl.cu on the card, `dfl_expectation_backward_plain`
    on the CPU; the op `torch.ops.yololite_tpu_torch.dfl_expectation_backward`."""
    if tuple(g.shape) != (*box_logits.shape[:-1], 4):
        raise ValueError(f"dfl_expectation_backward: g {tuple(g.shape)} for logits {tuple(box_logits.shape)}")
    _check_device("dfl_expectation_backward", box_logits, g)
    return torch.ops.yololite_tpu_torch.dfl_expectation_backward(box_logits, g.float().contiguous(), int(reg_max))


dfl_expectation_backward.launches = 0


@torch.library.custom_op("yololite_tpu_torch::dfl_expectation", mutates_args=(), device_types="cpu")
def _dfl_expectation_op(box_logits: Tensor, reg_max: int) -> Tensor:
    return dfl_expectation_plain(box_logits, reg_max)


@_dfl_expectation_op.register_kernel("cuda")
def _dfl_expectation_cuda(box_logits: Tensor, reg_max: int) -> Tensor:
    plan = dfl_plan(box_logits)
    rows = plan["rows"]
    out = torch.empty((*box_logits.shape[:-1], 4), dtype=torch.float32, device=box_logits.device)
    if rows == 0:
        return out
    lib = _dfl_lib()
    rc = lib.dfl_expectation_forward(box_logits.data_ptr(), plan["row_stride"], rows, reg_max,
                                     X_TYPES[box_logits.dtype], int(plan["route"] == "lanes"), out.data_ptr(),
                                     box_logits.device.index, _stream(box_logits))
    if rc != 0:
        raise RuntimeError(f"dfl_expectation kernel launch failed: {lib.dfl_error_string(rc).decode()}")
    dfl_expectation.launches += 1
    return out


@_dfl_expectation_op.register_fake
def _dfl_expectation_fake(box_logits: Tensor, reg_max: int) -> Tensor:
    return box_logits.new_empty((*box_logits.shape[:-1], 4), dtype=torch.float32)


@torch.library.custom_op("yololite_tpu_torch::dfl_expectation_backward", mutates_args=(), device_types="cpu")
def _dfl_expectation_backward_op(box_logits: Tensor, g: Tensor, reg_max: int) -> Tensor:
    return dfl_expectation_backward_plain(box_logits, g, reg_max)


@_dfl_expectation_backward_op.register_kernel("cuda")
def _dfl_expectation_backward_cuda(box_logits: Tensor, g: Tensor, reg_max: int) -> Tensor:
    plan = dfl_plan(box_logits)
    rows = plan["rows"]
    dx = torch.empty(tuple(box_logits.shape), dtype=box_logits.dtype, device=box_logits.device)
    if rows == 0:
        return dx
    lib = _dfl_lib()
    rc = lib.dfl_expectation_backward(box_logits.data_ptr(), plan["row_stride"], rows, reg_max,
                                      X_TYPES[box_logits.dtype], int(plan["route"] == "lanes"),
                                      g.contiguous().data_ptr(), dx.data_ptr(), box_logits.device.index,
                                      _stream(box_logits))
    if rc != 0:
        raise RuntimeError(f"dfl_expectation_backward kernel launch failed: {lib.dfl_error_string(rc).decode()}")
    dfl_expectation_backward.launches += 1
    return dx


@_dfl_expectation_backward_op.register_fake
def _dfl_expectation_backward_fake(box_logits: Tensor, g: Tensor, reg_max: int) -> Tensor:
    return torch.empty_like(box_logits, memory_format=torch.contiguous_format)


def _dfl_expectation_setup(ctx, inputs, output):
    box_logits, reg_max = inputs
    ctx.save_for_backward(box_logits)
    ctx.reg_max = reg_max


def _dfl_expectation_grad(ctx, g):
    (box_logits,) = ctx.saved_tensors
    return dfl_expectation_backward(box_logits, g, ctx.reg_max), None


_dfl_expectation_op.register_autograd(_dfl_expectation_grad, setup_context=_dfl_expectation_setup)


# ---------------- K6a: the DFL cross-entropy ----------------


def dfl_ce_mean(pred_dist: Tensor, target: Tensor) -> Tensor:
    """DFL cross-entropy, the mean over the 4 sides: (..., 4R) logits (as `dfl_expectation` takes them) and (...,
    4) fp32 continuous bins (clamped to R - 1 - 0.01 inside) -> (..., 1) fp32; differentiable in the logits with
    `dfl_ce_backward` (the target gets no gradient: it comes from the assigner).

    A CUDA tensor goes through csrc/dfl.cu, a CPU tensor through
    `dfl_ce_plain`; both as the op `torch.ops.yololite_tpu_torch.dfl_ce_mean`.
    Any other input raises.
    """
    R = pred_dist.shape[-1] // 4 if pred_dist.dim() else 0
    if not 1 <= R <= MAX_REG or pred_dist.shape[-1] != 4 * R or tuple(target.shape) != (*pred_dist.shape[:-1], 4):
        raise ValueError(f"dfl_ce_mean wants (..., 4R) logits, R <= {MAX_REG}, and (..., 4) targets, got "
                         f"{tuple(pred_dist.shape)} and {tuple(target.shape)}")
    if _check_device("dfl_ce_mean", pred_dist, target) == "cuda":
        _check_types("dfl_ce_mean", pred_dist, X_TYPES)
        _check_types("dfl_ce_mean's target", target, {torch.float32: 0})
        target = target.contiguous()  # (..., 4): 16 bytes an anchor
    return torch.ops.yololite_tpu_torch.dfl_ce_mean(pred_dist, target)


dfl_ce_mean.launches = 0


def dfl_ce_backward(pred_dist: Tensor, target: Tensor, g: Tensor) -> Tensor:
    """K6a's backward: the logits and targets as `dfl_ce_mean` took them and the gradient g (..., 1) -> dx (...,
    4R) contiguous, in the logits' dtype. csrc/dfl.cu on the card, `dfl_ce_backward_plain` on the CPU; the op
    `torch.ops.yololite_tpu_torch.dfl_ce_backward`."""
    if tuple(g.shape) != (*pred_dist.shape[:-1], 1):
        raise ValueError(f"dfl_ce_backward: g {tuple(g.shape)} for logits {tuple(pred_dist.shape)}")
    _check_device("dfl_ce_backward", pred_dist, target, g)
    return torch.ops.yololite_tpu_torch.dfl_ce_backward(pred_dist, target.contiguous(), g.float().contiguous())


dfl_ce_backward.launches = 0


@torch.library.custom_op("yololite_tpu_torch::dfl_ce_mean", mutates_args=(), device_types="cpu")
def _dfl_ce_op(pred_dist: Tensor, target: Tensor) -> Tensor:
    return dfl_ce_plain(pred_dist, target)


@_dfl_ce_op.register_kernel("cuda")
def _dfl_ce_cuda(pred_dist: Tensor, target: Tensor) -> Tensor:
    plan = dfl_plan(pred_dist)
    rows = plan["rows"]
    out = torch.empty((*pred_dist.shape[:-1], 1), dtype=torch.float32, device=pred_dist.device)
    if rows == 0:
        return out
    lib = _dfl_lib()
    rc = lib.dfl_ce_forward(pred_dist.data_ptr(), plan["row_stride"], rows, pred_dist.shape[-1] // 4,
                            X_TYPES[pred_dist.dtype], int(plan["route"] == "lanes"), target.contiguous().data_ptr(),
                            out.data_ptr(), pred_dist.device.index, _stream(pred_dist))
    if rc != 0:
        raise RuntimeError(f"dfl_ce_mean kernel launch failed: {lib.dfl_error_string(rc).decode()}")
    dfl_ce_mean.launches += 1
    return out


@_dfl_ce_op.register_fake
def _dfl_ce_fake(pred_dist: Tensor, target: Tensor) -> Tensor:
    return pred_dist.new_empty((*pred_dist.shape[:-1], 1), dtype=torch.float32)


@torch.library.custom_op("yololite_tpu_torch::dfl_ce_backward", mutates_args=(), device_types="cpu")
def _dfl_ce_backward_op(pred_dist: Tensor, target: Tensor, g: Tensor) -> Tensor:
    return dfl_ce_backward_plain(pred_dist, target, g)


@_dfl_ce_backward_op.register_kernel("cuda")
def _dfl_ce_backward_cuda(pred_dist: Tensor, target: Tensor, g: Tensor) -> Tensor:
    plan = dfl_plan(pred_dist)
    rows = plan["rows"]
    dx = torch.empty(tuple(pred_dist.shape), dtype=pred_dist.dtype, device=pred_dist.device)
    if rows == 0:
        return dx
    lib = _dfl_lib()
    rc = lib.dfl_ce_backward(pred_dist.data_ptr(), plan["row_stride"], rows, pred_dist.shape[-1] // 4,
                             X_TYPES[pred_dist.dtype], int(plan["route"] == "lanes"), target.contiguous().data_ptr(),
                             g.contiguous().data_ptr(), dx.data_ptr(), pred_dist.device.index, _stream(pred_dist))
    if rc != 0:
        raise RuntimeError(f"dfl_ce_backward kernel launch failed: {lib.dfl_error_string(rc).decode()}")
    dfl_ce_backward.launches += 1
    return dx


@_dfl_ce_backward_op.register_fake
def _dfl_ce_backward_fake(pred_dist: Tensor, target: Tensor, g: Tensor) -> Tensor:
    return torch.empty_like(pred_dist, memory_format=torch.contiguous_format)


def _dfl_ce_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _dfl_ce_grad(ctx, g):
    pred_dist, target = ctx.saved_tensors
    return dfl_ce_backward(pred_dist, target, g), None


_dfl_ce_op.register_autograd(_dfl_ce_grad, setup_context=_dfl_ce_setup)


def _dfl_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("dfl")
    if lib.dfl_expectation_forward.argtypes is None:  # declare the C signatures once per process
        head = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        tail = [ctypes.c_int, ctypes.c_void_p]
        lib.dfl_expectation_forward.argtypes = head + [ctypes.c_int, ctypes.c_void_p] + tail
        lib.dfl_expectation_backward.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p] * 2 + tail
        lib.dfl_ce_forward.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p] * 2 + tail
        lib.dfl_ce_backward.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p] * 3 + tail
        for fn in (lib.dfl_expectation_forward, lib.dfl_expectation_backward, lib.dfl_ce_forward,
                   lib.dfl_ce_backward):
            fn.restype = ctypes.c_int
        lib.dfl_error_string.argtypes = [ctypes.c_int]
        lib.dfl_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- K6b: the BCE sum ----------------


def bce_sum(logits: Tensor, labels: Tensor) -> Tensor:
    """sum(BCE with logits) over every element -> a fp32 scalar, computed in fp32 whatever the inputs' dtypes;
    differentiable in the logits with `bce_sum_backward` (the labels get no gradient: assigner targets).

    logits and labels of one shape (on the card: logits fp32, bf16 or fp64,
    labels fp32 or bf16; the last dim contiguous, the rows evenly spaced). A
    CUDA tensor goes through
    csrc/bce_sum.cu (a deterministic sum: a partial per chunk of BCE_CHUNK
    16-byte pieces, then one block adds them; `bce_sum_plan`), a CPU tensor
    through `bce_sum_plain`; both as the op
    `torch.ops.yololite_tpu_torch.bce_sum`. Any other input raises.
    """
    if tuple(logits.shape) != tuple(labels.shape) or logits.dim() == 0:
        raise ValueError(f"bce_sum wants logits and labels of one shape, got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if _check_device("bce_sum", logits, labels) == "cuda":
        _check_types("bce_sum", logits, X_TYPES)
        _check_types("bce_sum's labels", labels, LABEL_TYPES)
    return torch.ops.yololite_tpu_torch.bce_sum(logits, labels)


bce_sum.launches = 0


def bce_sum_backward(logits: Tensor, labels: Tensor, g: Tensor) -> Tensor:
    """K6b's backward: (sigmoid(logits) - labels) * g in the logits' dtype, contiguous, for the fp32 scalar g.
    csrc/bce_sum.cu on the card, `bce_sum_backward_plain` on the CPU; the op
    `torch.ops.yololite_tpu_torch.bce_sum_backward`."""
    if g.numel() != 1:
        raise ValueError(f"bce_sum_backward takes a scalar gradient, got {tuple(g.shape)}")
    _check_device("bce_sum_backward", logits, labels, g)
    return torch.ops.yololite_tpu_torch.bce_sum_backward(logits, labels, g.float().reshape(()))


bce_sum_backward.launches = 0


@torch.library.custom_op("yololite_tpu_torch::bce_sum", mutates_args=(), device_types="cpu")
def _bce_sum_op(logits: Tensor, labels: Tensor) -> Tensor:
    return bce_sum_plain(logits, labels)


def bce_sum_plan(logits: Tensor, labels: Tensor) -> dict:
    """How csrc/bce_sum.cu takes these inputs (as `bce_sum` and `bce_sum_backward` take them): {"route": "vector"
    (16-byte pieces) or "scalar" (a layout they cannot read: the same pieces, one element at a time), "piece"
    (elements a piece: 16 bytes of logits), "pieces", "blocks" (chunks of BCE_CHUNK pieces: the forward's partials),
    "rows", "x_row_stride", "y_row_stride"}. The partition depends on the element count and the logits' type
    alone; the rule lives here and the kernel holds the wrapper to it."""
    rows, xrs = _rows_of(logits)
    _, yrs = _rows_of(labels)
    cols = logits.shape[-1]
    piece = 16 // logits.element_size()
    pieces = -(-rows * cols // piece)
    label_bytes = min(piece * labels.element_size(), 16)  # a piece's labels are read in loads of this size
    vec = (cols % piece == 0 and _vec16(logits, xrs) and labels.data_ptr() % label_bytes == 0 and yrs % piece == 0
           and pieces < 2 ** 31)
    return {"route": "vector" if vec else "scalar", "piece": piece, "pieces": pieces,
            "blocks": -(-pieces // BCE_CHUNK), "rows": rows, "x_row_stride": xrs, "y_row_stride": yrs}


@_bce_sum_op.register_kernel("cuda")
def _bce_sum_cuda(logits: Tensor, labels: Tensor) -> Tensor:
    plan = bce_sum_plan(logits, labels)
    lib = _bce_lib()
    out = torch.empty((), dtype=torch.float32, device=logits.device)
    partials = torch.empty(max(plan["blocks"], 1), dtype=torch.float32, device=logits.device)
    rc = lib.bce_sum_forward(logits.data_ptr(), plan["x_row_stride"], X_TYPES[logits.dtype], labels.data_ptr(),
                             plan["y_row_stride"], LABEL_TYPES[labels.dtype], plan["rows"], logits.shape[-1],
                             int(plan["route"] == "vector"), partials.data_ptr(), plan["blocks"], out.data_ptr(),
                             logits.device.index, _stream(logits))
    if rc != 0:
        raise RuntimeError(f"bce_sum kernel launch failed: {lib.bce_sum_error_string(rc).decode()}")
    bce_sum.launches += 1
    return out


@_bce_sum_op.register_fake
def _bce_sum_fake(logits: Tensor, labels: Tensor) -> Tensor:
    return logits.new_empty((), dtype=torch.float32)


@torch.library.custom_op("yololite_tpu_torch::bce_sum_backward", mutates_args=(), device_types="cpu")
def _bce_sum_backward_op(logits: Tensor, labels: Tensor, g: Tensor) -> Tensor:
    return bce_sum_backward_plain(logits, labels, g).contiguous()


@_bce_sum_backward_op.register_kernel("cuda")
def _bce_sum_backward_cuda(logits: Tensor, labels: Tensor, g: Tensor) -> Tensor:
    dx = torch.empty(tuple(logits.shape), dtype=logits.dtype, device=logits.device)
    if dx.numel() == 0:
        return dx
    plan = bce_sum_plan(logits, labels)
    lib = _bce_lib()
    rc = lib.bce_sum_backward(logits.data_ptr(), plan["x_row_stride"], X_TYPES[logits.dtype], labels.data_ptr(),
                              plan["y_row_stride"], LABEL_TYPES[labels.dtype], plan["rows"], logits.shape[-1],
                              int(plan["route"] == "vector"), g.contiguous().data_ptr(), dx.data_ptr(),
                              logits.device.index, _stream(logits))
    if rc != 0:
        raise RuntimeError(f"bce_sum_backward kernel launch failed: {lib.bce_sum_error_string(rc).decode()}")
    bce_sum_backward.launches += 1
    return dx


@_bce_sum_backward_op.register_fake
def _bce_sum_backward_fake(logits: Tensor, labels: Tensor, g: Tensor) -> Tensor:
    return torch.empty_like(logits, memory_format=torch.contiguous_format)


def _bce_sum_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _bce_sum_grad(ctx, g):
    logits, labels = ctx.saved_tensors
    return bce_sum_backward(logits, labels, g), None


_bce_sum_op.register_autograd(_bce_sum_grad, setup_context=_bce_sum_setup)


def _bce_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("bce_sum")
    if lib.bce_sum_forward.argtypes is None:  # declare the C signatures once per process
        head = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.bce_sum_forward.argtypes = head + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
        lib.bce_sum_forward.restype = ctypes.c_int
        lib.bce_sum_backward.argtypes = head + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        lib.bce_sum_backward.restype = ctypes.c_int
        lib.bce_sum_error_string.argtypes = [ctypes.c_int]
        lib.bce_sum_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- K7: the assigner's per-GT top-k ----------------


def topk_rows(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The top min(k, n) of each row of x (..., n): values (..., min(k, n)) in x's dtype, descending, and their
    int64 indices, ties to the lower index and NaN first (lax.top_k's order, and `topk_stable`'s); no gradient.

    A CUDA tensor (fp32 or fp64; the last dim contiguous, the rows evenly
    spaced; k <= 32) goes through csrc/topk_rows.cu, a CPU tensor
    through `topk_stable`; both as the op `torch.ops.yololite_tpu_torch.topk_rows`.
    Any other input raises.
    """
    if x.dim() == 0 or k < 0:
        raise ValueError(f"topk_rows wants a tensor of rows and k >= 0, got {tuple(x.shape)} and k {k}")
    if _check_device("topk_rows", x) == "cuda":
        _check_types("topk_rows", x, METRIC_TYPES)
        if k > MAX_K:
            raise ValueError(f"topk_rows takes k <= {MAX_K} on the card, got {k}")
    return torch.ops.yololite_tpu_torch.topk_rows(x.detach(), int(k))


topk_rows.launches = 0


def _topk_empty(x: Tensor, k: int):
    kk = min(k, x.shape[-1])
    return (x.new_empty((*x.shape[:-1], kk)), x.new_empty((*x.shape[:-1], kk), dtype=torch.int64))


@torch.library.custom_op("yololite_tpu_torch::topk_rows", mutates_args=(), device_types="cpu")
def _topk_rows_op(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    vals, idx = topk_stable(x, k)
    return vals.contiguous(), idx.contiguous()


def topk_rows_plan(x: Tensor, k: int) -> dict:
    """How csrc/topk_rows.cu takes x (..., n) and k (as `topk_rows` takes them): {"route": "vector" (16-byte loads:
    x and its row stride 16-byte aligned, n a multiple of the values a load carries) or "scalar", "items" (the
    values a thread holds: the first of TOPK_ITEMS with TOPK_THREADS * items >= n, else 0, the row streamed),
    "rows", "row_stride", "n", "k" (min(k, n), the output's width)}. The launch follows the shapes alone; the rule
    lives here and the kernel holds the wrapper to it."""
    rows, rs = _rows_of(x)
    n = x.shape[-1]
    vec = n % (16 // x.element_size()) == 0 and _vec16(x, rs)
    items = next((i for i in TOPK_ITEMS if TOPK_THREADS * i >= n), 0)
    return {"route": "vector" if vec else "scalar", "items": items, "rows": rows, "row_stride": rs, "n": n,
            "k": min(k, n)}


@_topk_rows_op.register_kernel("cuda")
def _topk_rows_cuda(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    vals, idx = _topk_empty(x, k)
    if vals.numel() == 0:
        return vals, idx
    plan = topk_rows_plan(x, k)
    lib = _topk_lib()
    rc = lib.topk_rows(x.data_ptr(), plan["row_stride"], plan["rows"], plan["n"], METRIC_TYPES[x.dtype], plan["k"],
                       int(plan["route"] == "vector"), plan["items"], vals.data_ptr(), idx.data_ptr(),
                       x.device.index, _stream(x))
    if rc != 0:
        raise RuntimeError(f"topk_rows kernel launch failed: {lib.topk_rows_error_string(rc).decode()}")
    topk_rows.launches += 1
    return vals, idx


@_topk_rows_op.register_fake
def _topk_rows_fake(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    return _topk_empty(x, k)


def _topk_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("topk_rows")
    if lib.topk_rows.argtypes is None:  # declare the C signatures once per process
        lib.topk_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.topk_rows.restype = ctypes.c_int
        lib.topk_rows_error_string.argtypes = [ctypes.c_int]
        lib.topk_rows_error_string.restype = ctypes.c_char_p
    return lib


# ---------------- K9: the compact box/DFL form's foreground gather ----------------


def compact_rows_plain(x: Tensor, fg: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K9: x (B, A, C), fg (B, A) bool -> rows (B, k, C) in x's dtype, idx (B, k) int64 and the inverse map
    pos (B, A) int32 (a row's position among the k, or -1). idx is lax.top_k(fg as floats, k)'s: the foreground rows
    first, then the others, each in index order."""
    _, idx = topk_stable(fg.float(), k)
    idx = idx.contiguous()
    rows = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    pos = torch.full(tuple(fg.shape), -1, dtype=torch.int32, device=fg.device)
    pos.scatter_(1, idx, torch.arange(k, dtype=torch.int32, device=fg.device).expand(idx.shape).contiguous())
    return rows, idx, pos


def compact_rows_backward_plain(g: Tensor, idx: Tensor, pos: Tensor) -> Tensor:
    """Plain K9 backward: zeros (B, A, C) in g's dtype with g's rows (B, k, C) put back at idx."""
    dx = torch.zeros((*pos.shape, g.shape[-1]), dtype=g.dtype, device=g.device)
    return dx.scatter_(1, idx[..., None].expand(-1, -1, g.shape[-1]), g)


def compact_rows_plan(x: Tensor) -> dict:
    """How csrc/compact_rows.cu reads x (..., C), the logits of the forward or the contiguous gradient of the
    backward: {"route": "vector" (16-byte pieces: x's pointer, its row stride in bytes and a row's C elements in
    bytes multiples of 16) or "scalar" (an element at a time), "rows", "row_stride"}. The rule lives here; the
    kernel holds the wrapper to it."""
    rows, rs = _rows_of(x)
    vec = x.shape[-1] * x.element_size() % 16 == 0 and _vec16(x, rs)
    return {"route": "vector" if vec else "scalar", "rows": rows, "row_stride": rs}


K9_BLOCKS = 132  # the forward's blocks in all, about: one an SM of an H100
K9_MIN_SHARE = 32  # the fewest of the K positions a forward block takes


def compact_rows_shares(b: int, k: int) -> int:
    """S, the forward's blocks an image in csrc/compact_rows.cu: about K9_BLOCKS blocks over the B images, each
    taking at least K9_MIN_SHARE of the K positions (ceil(K / S) each, the last fewer where S does not divide K),
    and at least one (it writes its slice of pos). Fixed by (B, K), so a CUDA graph replays the same grid."""
    return max(1, min(-(-k // K9_MIN_SHARE), K9_BLOCKS // max(b, 1), 65535))


def compact_rows(x: Tensor, fg: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k rows of x (B, A, C) that lax.top_k picks over the foreground mask fg (B, A) bool: rows (B, k, C) in
    x's dtype, an exact copy, and their indices idx (B, k) int64 (the foreground rows first, at most k of them, then
    the first others, each in index order); differentiable in x with `compact_rows_backward`. k <= A.

    A CUDA tensor (fp32, bf16 or fp64 logits; the last dim contiguous, the
    rows evenly spaced) goes through csrc/compact_rows.cu, a CPU tensor
    through `compact_rows_plain`; both as the op
    `torch.ops.yololite_tpu_torch.compact_rows`, which also returns the inverse
    map its backward reads. Any other input raises.
    """
    if x.dim() != 3 or tuple(fg.shape) != tuple(x.shape[:2]) or not 0 <= k <= x.shape[1]:
        raise ValueError(f"compact_rows wants x (B, A, C), fg (B, A) and 0 <= k <= A, got {tuple(x.shape)}, "
                         f"{tuple(fg.shape)} and k {k}")
    if fg.dtype != torch.bool:
        raise TypeError(f"compact_rows wants a bool foreground mask, got {fg.dtype}")
    if _check_device("compact_rows", x, fg) == "cuda":
        _check_types("compact_rows", x, X_TYPES)
    rows, idx, _ = torch.ops.yololite_tpu_torch.compact_rows(x, fg, int(k))
    return rows, idx


compact_rows.launches = 0


def compact_rows_backward(g: Tensor, idx: Tensor, pos: Tensor) -> Tensor:
    """K9's backward: the gradient g (B, k, C) of `compact_rows`' rows, with its idx (B, k) and inverse map pos
    (B, A) -> dx (B, A, C) contiguous in g's dtype, g's rows at idx and +0.0 elsewhere. csrc/compact_rows.cu on the
    card, `compact_rows_backward_plain` on the CPU; the op `torch.ops.yololite_tpu_torch.compact_rows_backward`."""
    if g.dim() != 3 or tuple(idx.shape) != tuple(g.shape[:2]) or pos.dim() != 2 or pos.shape[0] != g.shape[0]:
        raise ValueError(f"compact_rows_backward: g {tuple(g.shape)}, idx {tuple(idx.shape)}, pos {tuple(pos.shape)}")
    if _check_device("compact_rows_backward", g, idx, pos) == "cuda":
        _check_types("compact_rows_backward", g, X_TYPES)
    return torch.ops.yololite_tpu_torch.compact_rows_backward(g.contiguous(), idx, pos)


compact_rows_backward.launches = 0


def _compact_empty(x: Tensor, k: int):
    b, a, c = x.shape
    return (x.new_empty((b, k, c)), x.new_empty((b, k), dtype=torch.int64),
            x.new_empty((b, a), dtype=torch.int32))


@torch.library.custom_op("yololite_tpu_torch::compact_rows", mutates_args=(), device_types="cpu")
def _compact_rows_op(x: Tensor, fg: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    return compact_rows_plain(x, fg, k)


@_compact_rows_op.register_kernel("cuda")
def _compact_rows_cuda(x: Tensor, fg: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    rows, idx, pos = _compact_empty(x, k)
    if pos.numel() == 0:
        return rows, idx, pos
    plan = compact_rows_plan(x)
    lib = _compact_lib()
    b, a, c = x.shape
    rc = lib.compact_rows_forward(x.data_ptr(), plan["row_stride"], b, a, c, x.element_size(),
                                  int(plan["route"] == "vector"), fg.contiguous().data_ptr(), k,
                                  compact_rows_shares(b, k), rows.data_ptr(), idx.data_ptr(), pos.data_ptr(),
                                  x.device.index, _stream(x))
    if rc != 0:
        raise RuntimeError(f"compact_rows kernel launch failed: {lib.compact_rows_error_string(rc).decode()}")
    compact_rows.launches += 1
    return rows, idx, pos


@_compact_rows_op.register_fake
def _compact_rows_fake(x: Tensor, fg: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    return _compact_empty(x, k)


@torch.library.custom_op("yololite_tpu_torch::compact_rows_backward", mutates_args=(), device_types="cpu")
def _compact_rows_backward_op(g: Tensor, idx: Tensor, pos: Tensor) -> Tensor:
    return compact_rows_backward_plain(g, idx, pos)


@_compact_rows_backward_op.register_kernel("cuda")
def _compact_rows_backward_cuda(g: Tensor, idx: Tensor, pos: Tensor) -> Tensor:
    b, k, c = g.shape
    a = pos.shape[1]
    dx = torch.empty((b, a, c), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    plan = compact_rows_plan(g)
    lib = _compact_lib()
    rc = lib.compact_rows_backward(g.data_ptr(), b, k, a, c, g.element_size(), int(plan["route"] == "vector"),
                                   pos.contiguous().data_ptr(), dx.data_ptr(), g.device.index, _stream(g))
    if rc != 0:
        raise RuntimeError(f"compact_rows_backward kernel launch failed: {lib.compact_rows_error_string(rc).decode()}")
    compact_rows_backward.launches += 1
    return dx


@_compact_rows_backward_op.register_fake
def _compact_rows_backward_fake(g: Tensor, idx: Tensor, pos: Tensor) -> Tensor:
    return g.new_empty((g.shape[0], pos.shape[1], g.shape[2]))


def _compact_rows_setup(ctx, inputs, output):
    ctx.save_for_backward(output[1], output[2])


def _compact_rows_grad(ctx, g, g_idx, g_pos):
    idx, pos = ctx.saved_tensors
    return compact_rows_backward(g, idx, pos), None, None


_compact_rows_op.register_autograd(_compact_rows_grad, setup_context=_compact_rows_setup)


def _compact_lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("compact_rows")
    if lib.compact_rows_forward.argtypes is None:  # declare the C signatures once per process
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.compact_rows_forward.argtypes = [vp, ll, ll, ll, i, i, i, vp, ll, ll, vp, vp, vp, i, vp]
        lib.compact_rows_backward.argtypes = [vp, ll, ll, ll, i, i, i, vp, vp, i, vp]
        lib.compact_rows_empty.argtypes = [ll, ll, i, vp]
        lib.compact_rows_forward.restype = lib.compact_rows_backward.restype = ctypes.c_int
        lib.compact_rows_empty.restype = ctypes.c_int
        lib.compact_rows_error_string.argtypes = [ctypes.c_int]
        lib.compact_rows_error_string.restype = ctypes.c_char_p
    return lib


# the wrappers that count their kernel's launches
COUNTED = (dfl_expectation, dfl_expectation_backward, dfl_ce_mean, dfl_ce_backward, bce_sum, bce_sum_backward,
           topk_rows, compact_rows, compact_rows_backward)
