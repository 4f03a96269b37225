"""Optimizers on torch.optim with the JAX package's three parameter groups (port of yololite_tpu/engine/optim.py).

Groups, in the order of the JAX package's lr vector: 0 biases (BN bias and
conv bias), 1 weights (conv weights, the only group with weight decay), 2 BN
weights. As there, the group follows the JAX leaf's name: a leaf 'bias' or
'b' is a bias, a leaf 'scale' (a BN's weight, or a zoo block's own gate
scale) is in group 2, everything else (Linear, LayerNorm and attention
weights, `in_proj_bias`, `logit_scale`) is a weight. The trainer writes
each group's lr and momentum (or betas[0]) every iteration. Frozen
parameters are left out of the optimizer: no update and no decay, as the
JAX package's trainable mask gives.

Each of the 7 names maps onto the torch.optim class whose update is the JAX
formula: SGD(nesterov), Adam and RAdam with L2 decay folded into the
gradient, AdamW with decoupled decay, Adamax, NAdam (mu_product kept per
parameter, as the JAX package keeps one scalar) and RMSprop(alpha 0.99) with a
momentum buffer.

On the card the optimizer is built to be captured in a CUDA graph (the
trainer's apply and fused steps, engine/graphs.py): each group's lr is a 0-d
float32 tensor on the device, which `set_lr_momentum` writes in place with
no host sync, and the optimizer state (the step counts too) lives on the
device. SGD takes its fused form (`fused=True`, the one that reads a tensor
lr without a sync); the others `capturable=True` on their foreach form. In
this torch the momentum (SGD's and RMSprop's `momentum`, the Adam family's
`betas[0]`) stays a Python float: foreach Adam's `_foreach_lerp_` takes its
weight as a Python number, so a device `betas[0]` syncs and fails a capture,
and its single-tensor form, which takes one, costs 6.6 ms of device time an
AdamW step of yolo11n against 0.93 foreach (tools/optim_graph_probe.py on an
NVIDIA H100 80GB HBM3, 700 W). So the trainer keys its apply graph by the
momentum, and the warmup ramp's applies run eagerly. On the CPU nothing is
captured: the lr and momentum are Python floats, as before.

They differ from the JAX formulas only in rounding: AdamW divides sqrt(v) by
sqrt(1 - beta2^t) where the JAX package takes sqrt(v / (1 - beta2^t)); off
the card torch computes the Adam family's bias corrections in float64 on the
host, while on the card (capturable) it computes them in float32 on the
device, as the JAX package does; SGD's fused kernel on the card evaluates the
same nesterov update as the foreach loop on the CPU, in one pass.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

GROUP_BIAS, GROUP_WEIGHT, GROUP_BN = 0, 1, 2  # indices into the lr vector and the param groups

OPTIMIZERS = ("SGD", "Adam", "Adamax", "AdamW", "NAdam", "RAdam", "RMSProp")
# optimizer state names that hold the JAX package's first (mu) and second (nu) moments
_MOMENTS = {
    "SGD": ("momentum_buffer", None),
    "Adam": ("exp_avg", "exp_avg_sq"),
    "AdamW": ("exp_avg", "exp_avg_sq"),
    "Adamax": ("exp_avg", "exp_inf"),
    "NAdam": ("exp_avg", "exp_avg_sq"),
    "RAdam": ("exp_avg", "exp_avg_sq"),
    "RMSProp": ("momentum_buffer", "square_avg"),
}


def group_params(model: nn.Module) -> Tuple[List[nn.Parameter], ...]:
    """(bias, weight, bn) lists of the trainable parameters, in module order."""
    groups: Tuple[list, list, list] = ([], [], [])
    for m in model.modules():
        for pname, p in m.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            if pname == "bias":  # BN bias and conv bias
                gid = GROUP_BIAS
            elif isinstance(m, nn.BatchNorm2d) or pname == "scale":  # BN weight, and a zoo block's own 'scale'
                gid = GROUP_BN
            else:  # conv kernels and any other weight
                gid = GROUP_WEIGHT
            groups[gid].append(p)
    return groups


def build_optimizer(name: str, model: nn.Module, lr: float, momentum: float, weight_decay: float):
    """The named torch.optim optimizer over the model's trainable parameters in the 3 groups; on the card, one that
    a CUDA graph can capture (each group's lr a device tensor)."""
    bias, weight, bn = group_params(model)
    groups = [{"params": bias, "weight_decay": 0.0}, {"params": weight, "weight_decay": weight_decay},
              {"params": bn, "weight_decay": 0.0}]
    device = next((p.device for g in groups for p in g["params"]), torch.device("cpu"))
    on_card = device.type == "cuda"
    if on_card:  # written in place each iteration; allocated here, outside any capture
        for g in groups:
            g["lr"] = torch.full((), float(np.float32(lr)), dtype=torch.float32, device=device)
    if name == "SGD":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum, nesterov=True, fused=on_card or None)
    if name == "RMSProp":
        return torch.optim.RMSprop(groups, lr=lr, alpha=0.99, eps=1e-8, momentum=momentum, capturable=on_card)
    cls = {"Adam": torch.optim.Adam, "AdamW": torch.optim.AdamW, "Adamax": torch.optim.Adamax,
           "NAdam": torch.optim.NAdam, "RAdam": torch.optim.RAdam}.get(name)
    if cls is None:
        raise NotImplementedError(f"optimizer '{name}' not supported; choose one of {OPTIMIZERS}")
    return cls(groups, lr=lr, betas=(momentum, 0.999), eps=1e-8, capturable=on_card)


def set_lr_momentum(optimizer: torch.optim.Optimizer, lr_vec, momentum: float) -> None:
    """Write this iteration's per-group lr and the momentum (betas[0] for the Adam family) into the groups; a
    device lr in place, with no host sync, so that a captured step reads it."""
    m = float(np.float32(momentum))  # the JAX step takes momentum as a float32 scalar
    for gid, g in enumerate(optimizer.param_groups):
        lr = float(np.float32(lr_vec[gid]))
        if isinstance(g["lr"], torch.Tensor):
            g["lr"].fill_(lr)
        else:
            g["lr"] = lr
        if "betas" in g:
            g["betas"] = (m, g["betas"][1])
        else:
            g["momentum"] = m


def nadam_mu_product(step: int, beta1: float, momentum_decay: float = 0.004) -> float:
    """NAdam's running mu_product after `step` updates at a constant beta1 (for resume)."""
    i = np.arange(1, int(step) + 1, dtype=np.float64)
    return float(np.prod(beta1 * (1 - 0.5 * 0.96 ** (i * momentum_decay)))) if step else 1.0


def moments(name: str, optimizer: torch.optim.Optimizer, named: Dict[str, nn.Parameter]):
    """The optimizer's first and second moments by parameter name (zeros where it keeps none)."""
    k_mu, k_nu = _MOMENTS[name]
    mu, nu = {}, {}
    for n, p in named.items():
        st = optimizer.state.get(p, {})
        mu[n] = st[k_mu] if k_mu in st else torch.zeros_like(p)
        nu[n] = st[k_nu] if k_nu and k_nu in st else torch.zeros_like(p)
    return mu, nu


def load_moments(name: str, optimizer: torch.optim.Optimizer, named: Dict[str, nn.Parameter], mu: Dict, nu: Dict,
                 step: int, beta1: float) -> None:
    """Restore the optimizer's per-parameter state from moments by name, as of `step` updates."""
    k_mu, k_nu = _MOMENTS[name]
    sdt = torch.get_default_dtype()  # torch keeps step counters in the default dtype: on the host, or on the
    on_device = optimizer.param_groups[0].get("capturable", False)  # parameter's device when capturable
    for n, p in named.items():
        where = p.device if on_device else None
        st = {k_mu: mu[n].to(p).clone()}
        if name != "SGD":
            st["step"] = torch.tensor(float(step), dtype=sdt, device=where)
            st[k_nu] = nu[n].to(p).clone()
        if name == "NAdam":
            st["mu_product"] = torch.tensor(nadam_mu_product(step, beta1), dtype=sdt, device=where)
        optimizer.state[p] = st
