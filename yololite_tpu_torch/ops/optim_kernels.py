"""The train step's apply (K10) and its plain version: the gradient clip, the 7 update rules, the zeroing of the
gradients and the EMA, over every tensor of a model at once.

`optim_apply(table, rule, hyper, scalars, weight_decay, d, one_minus_d)`
applies the JAX package's `apply_step` (yololite_tpu/engine/trainer.py:342-350;
the rules of yololite_tpu/engine/optim.py:67-281, `clip_by_global_norm` :276,
`ema_update` of yololite_tpu/utils/ema.py:18-26) in place to the tensors
of an `ApplyTable`, and returns (total, scale), the gradients' norm and the
clip's factor, as a (2,) fp32 tensor. On the card it launches
csrc/optim_apply.cu (three launches: the norm's partial sums, its finish,
the update; no host sync, so a CUDA graph captures it); on the CPU it runs
`optim_apply_plain`. The per-step scalars it reads are device tensors:
`hyper` (the three groups' lr and the momentum, written before each apply)
and `scalars` (`step_scalars`, computed once by torch ops from the step
and the momentum): the kernel and the plain version read the same values.

The plain version takes every step as its own torch op in fp32, in the
JAX package's order of operations; the kernel rounds at the same places
(csrc/optim_apply.cu), so given the kernel's clip factor the two agree bit
for bit. The norm is summed in fp64 by both and rounded once.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

OPTIMIZERS = ("SGD", "Adam", "Adamax", "AdamW", "NAdam", "RAdam", "RMSProp")  # the kernel's rule index, in order
OPTIM_CHUNK = 4096  # elements an item of the table takes (csrc/optim_apply.cu kChunk)
TABLE_TYPES = {torch.float32: 0, torch.float64: 1}  # fp32 to train; fp64 for the float64 reference step
N_SCALARS = 8  # b1t, b2t, NAdam's c1 and c2, RAdam's rect, use_rect and sqrt(b2t), 1 - momentum


def _f32(x: float) -> float:
    return float(np.float32(x))


# the JAX package's constants as the float32 values its weakly typed Python floats become
BETA2 = _f32(0.999)
ONE_MINUS_BETA2 = _f32(1 - 0.999)  # Python's 1 - 0.999 rounded to fp32, not fp32(1) - fp32(0.999)
ALPHA = _f32(0.99)  # RMSProp
ONE_MINUS_ALPHA = _f32(1 - 0.99)
EPS = _f32(1e-8)
MAX_NORM = 10.0
NORM_EPS = _f32(1e-6)
NADAM_BASE, NADAM_DECAY = _f32(0.96), _f32(0.004)
RHO_INF = _f32(2.0 / (1 - 0.999) - 1.0)  # RAdam's, as Python computes it, then rounded
RHO_DEN = _f32((2.0 / (1 - 0.999) - 1.0 - 4) * (2.0 / (1 - 0.999) - 1.0 - 2))

# ---------------- plain versions ----------------


def step_scalars(rule: str, step: Tensor, b1: Tensor, extra: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
    """The rule's per-step scalars from the (already advanced) int32 step, the momentum b1 and NAdam's running
    mu_product `extra`, by torch ops on their device in fp32, as the JAX package computes them: a (N_SCALARS,) fp32
    tensor (b1t, b2t, c1, c2, rect, use_rect, sqrt(b2t), 1 - b1; 0 where the rule has none) and NAdam's new
    mu_product (None for the other rules). RAdam's use_rect is a device flag (1.0 or 0.0), never a host branch."""
    t = step.float()
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    b1t = b2t = c1 = c2 = rect = use = sqb2t = zero
    new_extra = None
    if rule in ("Adam", "AdamW", "Adamax", "RAdam"):
        b1t = 1.0 - b1 ** t
    if rule in ("Adam", "AdamW", "NAdam", "RAdam"):
        b2t = 1.0 - BETA2 ** t
    if rule == "NAdam":
        mu_t = b1 * (1.0 - 0.5 * NADAM_BASE ** (t * NADAM_DECAY))
        mu_next = b1 * (1.0 - 0.5 * NADAM_BASE ** ((t + 1.0) * NADAM_DECAY))
        new_extra = extra * mu_t
        c1 = torch.div(1.0 - mu_t, 1.0 - new_extra)
        c2 = torch.div(mu_next, 1.0 - new_extra * mu_next)
    if rule == "RAdam":
        rho_t = RHO_INF - torch.div(2.0 * t * BETA2 ** t, b2t)
        ratio = torch.div((rho_t - 4.0) * (rho_t - 2.0) * RHO_INF, RHO_DEN * rho_t)
        rect = torch.sqrt(torch.clamp_min(ratio, 0.0))
        use = (rho_t > 5.0).float()
        sqb2t = torch.sqrt(b2t)
    return torch.stack([b1t, b2t, c1, c2, rect, use, sqb2t, 1.0 - b1]), new_extra


def rule_update(rule: str, p: Tensor, g: Tensor, mu: Tensor, nu: Tensor, lr: Tensor, b1: Tensor, wd: float,
                decay: bool, s: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One tensor's update by the named rule, g already clipped: the new (p, mu, nu), each step its own fp32 op in
    the JAX package's order (yololite_tpu/engine/optim.py). lr and b1 are 0-d tensors, s the `step_scalars`; every
    divisor is a tensor, as torch divides by a Python scalar through its reciprocal."""
    if rule == "AdamW":
        if decay:
            p = p * (1.0 - lr * wd)
    elif decay:  # the other rules fold the decay into the gradient
        g = g + wd * p
    if rule == "SGD":
        m = b1 * mu + g
        return p - lr * (g + b1 * m), m, nu
    if rule == "RMSProp":
        v = ALPHA * nu + ONE_MINUS_ALPHA * g * g
        m = b1 * mu + torch.div(g, torch.sqrt(v) + EPS)
        return p - lr * m, m, v
    m = b1 * mu + s[7] * g
    if rule == "Adamax":
        v = torch.maximum(BETA2 * nu, torch.abs(g) + EPS)
        return p - torch.div(torch.div(lr, s[0]) * m, v), m, v
    v = BETA2 * nu + ONE_MINUS_BETA2 * g * g
    if rule in ("Adam", "AdamW"):
        step = torch.div(lr * torch.div(m, s[0]), torch.sqrt(torch.div(v, s[1])) + EPS)
    elif rule == "NAdam":
        step = torch.div(lr * (s[2] * g + s[3] * m), torch.sqrt(torch.div(v, s[1])) + EPS)
    elif rule == "RAdam":
        mhat = torch.div(m, s[0])
        adaptive = torch.div(s[4] * mhat * s[6], torch.sqrt(v) + EPS)
        step = lr * torch.where(s[5] != 0, adaptive, mhat)
    else:
        raise NotImplementedError(f"optimizer '{rule}' not supported; choose one of {OPTIMIZERS}")
    return p - step, m, v


def grad_norm_plain(grads: Sequence[Tensor]) -> Tensor:
    """The l2 norm of all the gradients: the squares summed in fp64, the root rounded to fp32 once."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([g.double().square().sum() for g in grads]).sum().sqrt().float()


def clip_scale(total: Tensor, max_norm: float = MAX_NORM) -> Tensor:
    """min(1, max_norm / (total + 1e-6)) in fp32, NaN where the norm is NaN (jnp.minimum)."""
    x = torch.div(torch.full_like(total, max_norm), total + NORM_EPS)
    return torch.minimum(torch.ones_like(x), x)


@torch.no_grad()
def ema_plain(floats: Sequence[Tuple[Tensor, Tensor]], ints: Sequence[Tuple[Tensor, Tensor]], d: Tensor,
              one_minus_d: Tensor) -> None:
    """The EMA's plain form, in place: ema = ema * d + (1 - d) * x for each floating (ema, x), ema = x for each
    integer one (yololite_tpu/utils/ema.py:18-26 ema_update; K10 computes the same in its pass)."""
    for ema, x in floats:
        ema.copy_(ema * d + one_minus_d * x)
    for ema, x in ints:
        ema.copy_(x)


@torch.no_grad()
def optim_apply_plain(table: "ApplyTable", rule: str, hyper: Tensor, scalars: Tensor, weight_decay: float, d: Tensor,
                      one_minus_d: Tensor, scale: Optional[Tensor] = None) -> Tensor:
    """Plain K10, in place on the table's tensors: the norm and the clip's factor (or the `scale` given: the
    kernel's, to hold the two to each other), each trainable tensor's update with the gradient zeroed and its EMA
    on the new weights, then the EMA of the other floating entries and the copy of the integer ones. Returns
    (total, scale) as a (2,) fp32 tensor."""
    total = grad_norm_plain(table.grads).to(hyper.device)
    if scale is None:
        scale = clip_scale(total)
    b1 = hyper[3]
    weight_decay = _f32(weight_decay)  # an fp32 value, as the kernel takes it (exact in an fp64 table's ops)
    for p, g, mu, nu, ema, gid in table.train:
        new_p, new_mu, new_nu = rule_update(rule, p, g * scale, mu, nu, hyper[gid], b1, weight_decay, gid == 1,
                                            scalars)
        p.copy_(new_p)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        g.zero_()
    ema_plain([(r[4], r[0]) for r in table.train] + table.floats, table.ints, d, one_minus_d)
    return torch.stack([total, scale.reshape(())])


# ---------------- K10: the table and the kernel ----------------


def _dense(t: Tensor) -> bool:
    return t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last)


def pointers(train: Sequence[tuple], rest: Sequence[Tuple[Tensor, Tensor]]) -> List[int]:
    """The addresses of an apply table's tensors, in its order (a table over other memory is stale)."""
    return [t.data_ptr() for r in train for t in r[:5]] + [t.data_ptr() for pair in rest for t in pair]


def _vec16(*tensors: Tensor) -> int:
    """1 where every tensor is fp32 and starts on 16 bytes (a row K10 reads and writes as float4s), else 0."""
    return int(all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0 for t in tensors))


class ApplyTable:
    """The tensors one apply walks, and on the card K10's pointer table over them, built once.

    `train`: (p, g, mu, nu, ema, group) per trainable parameter, of one
    shape and layout each, all of the table's `dtype` (fp32, or fp64 for the
    float64 reference step); `floats`: (ema, x) per other floating entry the EMA
    follows (BN statistics, frozen parameters); `ints`: (ema, x) per integer
    entry, copied. On the card the rows (8 int64 words each: the five
    pointers, the count, group and kind, the vector flag; csrc/optim_apply.cu
    `Row`) and the items ((row, chunk) int32 pairs, the trainable rows' first)
    are uploaded here, outside any capture, so that a graph replays on them.
    Where `pointers` of the tensors the table should walk now differ from
    its own (a tensor was replaced), build a new one.
    """

    def __init__(self, train: Sequence[tuple], rest: Sequence[Tuple[Tensor, Tensor]]):
        self.train = [tuple(r) for r in train]
        self.floats = [(e, x) for e, x in rest if e.is_floating_point()]
        self.ints = [(e, x) for e, x in rest if not e.is_floating_point()]
        self.grads = [r[1] for r in self.train]
        tensors = [t for r in self.train for t in r[:5]] + [t for pair in rest for t in pair]
        self.device = tensors[0].device if tensors else torch.device("cpu")
        floats = [r[0] for r in self.train] + [x for _, x in self.floats]
        self.dtype = floats[0].dtype if floats else torch.float32
        if self.dtype not in TABLE_TYPES:
            raise ValueError(f"apply table: fp32 or fp64 tensors, got {self.dtype}")
        for r in self.train:
            p = r[0]
            if any(t.dtype != self.dtype or t.shape != p.shape or t.stride() != p.stride() or
                   t.device != self.device for t in r[:5]) or not _dense(p) or r[5] not in (0, 1, 2):
                raise ValueError(f"apply table: a trainable row {tuple(p.shape)} wants p, g, mu, nu and ema of the "
                                 f"table's type ({self.dtype}), one shape, layout and device, dense, and a group in 0-2")
        for e, x in rest:
            if e.dtype != x.dtype or e.shape != x.shape or e.stride() != x.stride() or not _dense(e) or \
                    e.device != self.device or x.device != self.device:
                raise ValueError(f"apply table: an EMA entry {tuple(e.shape)} {e.dtype} and its source differ in "
                                 f"dtype, shape, layout or device, or are not dense")
            if e.is_floating_point() and e.dtype != self.dtype:
                raise ValueError(f"apply table: every floating tensor of a table has one type, got {e.dtype} and "
                                 f"{self.dtype}")
        self.pointers = pointers(train, rest)
        self.rows = self.items = None
        self.n_norm = self.n_items = 0
        if self.device.type == "cuda":
            self._upload()

    def _upload(self):
        words, items = [], []
        for i, (p, g, mu, nu, ema, gid) in enumerate(self.train):
            words.append([p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), ema.data_ptr(), p.numel(),
                          gid, _vec16(p, g, mu, nu, ema)])
            items += [(i, c) for c in range(-(-p.numel() // OPTIM_CHUNK))]
        self.n_norm = len(items)
        for ema, x in self.floats + self.ints:
            kind, n = (1, x.numel()) if x.is_floating_point() else (2, x.numel() * x.element_size())
            words.append([x.data_ptr(), 0, 0, 0, ema.data_ptr(), n, kind << 32, _vec16(x, ema) if kind == 1 else 0])
            items += [(len(words) - 1, c) for c in range(-(-n // OPTIM_CHUNK))]
        if len(items) >= 2 ** 31:
            raise ValueError(f"apply table: {len(items)} items, more than a grid takes")
        self.n_items = len(items)
        self.rows = torch.tensor(words or [[0] * 8], dtype=torch.int64).to(self.device)
        self.items = torch.tensor(items or [(0, 0)], dtype=torch.int32).to(self.device)

    def device_tensors(self) -> List[Tensor]:
        """The tensors the table keeps on the card (they must live outside any CUDA graph pool)."""
        return [t for t in (self.rows, self.items) if t is not None]


def optim_apply(table: ApplyTable, rule: str, hyper: Tensor, scalars: Tensor, weight_decay: float, d: Tensor,
                one_minus_d: Tensor) -> Tensor:
    """Clip every trainable gradient to a global norm of 10, update each parameter and its moments by the named
    rule, zero the gradients, and move the EMA of every floating state_dict entry (ema = d * ema + (1 - d) * x)
    and copy the integer ones, in place on the table's tensors. Returns (total, scale), a (2,) fp32 tensor.

    hyper: (4,) fp32 (lr of groups 0, 1, 2, momentum); scalars: (N_SCALARS,) fp32 (`step_scalars`); d and
    one_minus_d: 0-d fp32, the EMA's decay; all on the table's device. A CUDA table goes through
    csrc/optim_apply.cu, a CPU one through `optim_apply_plain`; any other input raises.
    """
    if rule not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer '{rule}' not supported; choose one of {OPTIMIZERS}")
    for name, t, n in (("hyper", hyper, 4), ("scalars", scalars, N_SCALARS), ("d", d, 1),
                       ("one_minus_d", one_minus_d, 1)):
        if t.dtype != torch.float32 or t.numel() != n or t.device != table.device or not t.is_contiguous():
            raise ValueError(f"optim_apply: {name} wants {n} contiguous fp32 values on {table.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if table.device.type != "cuda":
        return optim_apply_plain(table, rule, hyper, scalars, weight_decay, d, one_minus_d)
    lib = _lib()
    partials = torch.empty(max(table.n_norm, 1), dtype=torch.float64, device=table.device)
    clip = torch.empty(2, dtype=torch.float32, device=table.device)
    rc = lib.optim_apply(table.rows.data_ptr(), table.items.data_ptr(), table.n_norm, table.n_items,
                         OPTIMIZERS.index(rule), TABLE_TYPES[table.dtype], hyper.data_ptr(), scalars.data_ptr(), d.data_ptr(),
                         one_minus_d.data_ptr(), float(np.float32(weight_decay)), partials.data_ptr(),
                         clip.data_ptr(), OPTIM_CHUNK, table.device.index,
                         torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"optim_apply kernel launch failed: {lib.optim_apply_error_string(rc).decode()}")
    optim_apply.launches += 1
    return clip


optim_apply.launches = 0  # kernel calls (three launches each) since the last reset


def _lib() -> ctypes.CDLL:
    from yololite_tpu_torch.ops import cuda_build

    lib = cuda_build.load("optim_apply")
    if lib.optim_apply.argtypes is None:  # declare the C signature once per process
        lib.optim_apply.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 +
                                    [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.optim_apply.restype = ctypes.c_int
        lib.optim_apply_error_string.argtypes = [ctypes.c_int]
        lib.optim_apply_error_string.restype = ctypes.c_char_p
    return lib


# the wrappers that count their kernel's launches
COUNTED = (optim_apply,)
