"""Optimizers: the JAX package's 7 update rules with its three parameter groups, their state, lr and momentum on the
device (port of yololite_tpu/engine/optim.py).

Groups, in the order of the JAX package's lr vector: 0 biases (BN bias and
conv bias), 1 weights (conv weights, the only group with weight decay), 2 BN
weights. As there, the group follows the JAX leaf's name: a leaf 'bias' or
'b' is a bias, a leaf 'scale' (a BN's weight, or a zoo block's own gate
scale) is in group 2, everything else (Linear, LayerNorm and attention
weights, `in_proj_bias`, `logit_scale`) is a weight. Frozen parameters are
left out of the optimizer: no update and no decay, as the JAX package's
trainable mask gives.

`Optimizer` holds what the JAX package's `OptState` holds, allocated at
construction as zeros (`init_state`), outside any CUDA graph capture: the
per-parameter first and second moments `mu` and `nu`, the int32 `step`,
NAdam's running mu_product `extra`. Beside them, `hyper`: the three groups'
lr and the momentum (SGD's, RMSProp's, the Adam family's beta1) as fp32
device scalars, which `set_lr_momentum` writes in place with no host sync.
As the JAX package traces lr and momentum, so that the warmup's
interpolation costs no recompiles, the trainer's one apply graph (or fused
graph) per key serves every iteration, the warmup ramp included.

`apply` is JAX's `apply_step`: the step advances on the device, the rule's
scalars (bias corrections, NAdam's mu schedule, RAdam's rectification) are
computed once from it by torch ops (ops/optim_kernels.py `step_scalars`),
and one call of K10 (ops/optim_kernels.py `optim_apply`, csrc/optim_apply.cu
on the card, its plain version on the CPU) clips, updates every tensor,
zeroes the gradients and moves the EMA. Every step of each rule is in the
JAX package's order of operations in fp32, the bias corrections included,
so the port follows the JAX update functions to the last bits (their
difference is the fp64 norm of the clip, and XLA's own roundings).

`moments` and `load_moments` carry mu and nu by parameter name in the JAX
package's checkpoint layout, with the step and NAdam's mu_product from the
update count, so either package resumes the other's run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

from yololite_tpu_torch.ops import optim_kernels
from yololite_tpu_torch.ops.optim_kernels import OPTIMIZERS

GROUP_BIAS, GROUP_WEIGHT, GROUP_BN = 0, 1, 2  # indices into the lr vector


def group_of(module: nn.Module, pname: str) -> int:
    """The group of a module's own parameter `pname` (the JAX leaf rule)."""
    if pname == "bias":  # BN bias and conv bias
        return GROUP_BIAS
    if isinstance(module, nn.BatchNorm2d) or pname == "scale":  # BN weight, and a zoo block's own 'scale'
        return GROUP_BN
    return GROUP_WEIGHT  # conv kernels and any other weight


def _trainable(model: nn.Module):
    """(name, parameter, group) of each trainable parameter, in the order of model.named_parameters()."""
    out = []
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if p.requires_grad:
                out.append((f"{mname}.{pname}" if mname else pname, p, group_of(m, pname)))
    return out


class Optimizer:
    """One of the 7 rules over a model's trainable parameters, its state on their device (see the module's notes).

    `params` and `groups` list the trainable parameters in model order and
    their groups; `mu`, `nu` their moments; `step`, `extra`, `hyper` (with
    the views `lr`, three 0-d tensors, and `momentum`) the scalars. `track`
    builds K10's table over these, the gradients and an EMA; `apply` runs
    one step.
    """

    def __init__(self, name: str, model: nn.Module, lr: float, momentum: float, weight_decay: float):
        if name not in OPTIMIZERS:
            raise NotImplementedError(f"optimizer '{name}' not supported; choose one of {OPTIMIZERS}")
        self.name = name
        trainable = _trainable(model)
        self.params = [p for _, p, _ in trainable]
        self.groups = [gid for _, _, gid in trainable]
        device = self.params[0].device if self.params else next(model.parameters()).device
        self.mu = [torch.zeros_like(p, requires_grad=False) for p in self.params]
        self.nu = [torch.zeros_like(p, requires_grad=False) for p in self.params]
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.extra = torch.ones((), dtype=torch.float32, device=device)  # NAdam's mu_product
        self.hyper = torch.tensor([lr, lr, lr, momentum], dtype=torch.float32, device=device)
        self.lr = [self.hyper[i] for i in range(3)]
        self.momentum = self.hyper[3]
        self.weight_decay = float(np.float32(weight_decay))  # a Python float in the JAX step: fp32 there
        self.table = None

    def set_lr_momentum(self, lr_vec, momentum: float) -> None:
        """Write this iteration's per-group lr and the momentum, as fp32, in place (no host sync)."""
        for t, v in zip(self.lr, lr_vec):
            t.fill_(float(np.float32(v)))
        self.momentum.fill_(float(np.float32(momentum)))  # the JAX step takes momentum as a float32 scalar

    def _sources(self, model: nn.Module, ema):
        """(train, rest) of K10's table as the model and EMA hold them now: (p, g, mu, nu, ema, group) per trainable
        parameter, (ema, x) per other state_dict entry."""
        index = {id(p): i for i, p in enumerate(self.params)}
        ema_sd = ema.ema.state_dict()
        train = [None] * len(self.params)
        rest = []
        for k, x in model.state_dict(keep_vars=True).items():
            i = index.get(id(x))
            if i is None:
                rest.append((ema_sd[k], x.detach()))
            elif x.grad is None:
                raise ValueError(f"optimizer: {k} has no gradient to apply; allocate it first")
            else:
                train[i] = (x.detach(), x.grad, self.mu[i], self.nu[i], ema_sd[k], self.groups[i])
        if any(r is None for r in train):
            raise ValueError("optimizer: a trainable parameter is not in the model's state_dict")
        return train, rest

    def track(self, model: nn.Module, ema) -> None:
        """Build K10's table over the parameters, their gradients (allocated by then) and moments, and the EMA
        (utils/ema.py ModelEMA) of every state_dict entry of `model`."""
        self._tracked = (model, ema)
        self.table = optim_kernels.ApplyTable(*self._sources(model, ema))

    def stale(self) -> bool:
        """Whether the table is missing or a tensor it walks was replaced since (build it again with `track`)."""
        if self.table is None:
            return True
        try:
            return optim_kernels.pointers(*self._sources(*self._tracked)) != self.table.pointers
        except ValueError:  # a gradient dropped
            return True

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer that lives across steps (they must lie outside any CUDA graph pool)."""
        return [*self.mu, *self.nu, self.step, self.extra, self.hyper,
                *(self.table.device_tensors() if self.table is not None else [])]

    @torch.no_grad()
    def apply(self, d: torch.Tensor, one_minus_d: torch.Tensor) -> torch.Tensor:
        """One step at the lr and momentum written before, the EMA at decay d: the step advanced, the rule's scalars
        computed, then K10 (clip to norm 10, the update, the gradients zeroed, the EMA). Returns (norm, scale)."""
        self.step.add_(1)
        scalars, extra = optim_kernels.step_scalars(self.name, self.step, self.momentum, self.extra)
        if extra is not None:
            self.extra.copy_(extra)
        return optim_kernels.optim_apply(self.table, self.name, self.hyper, scalars, self.weight_decay, d,
                                         one_minus_d)


def build_optimizer(name: str, model: nn.Module, lr: float, momentum: float, weight_decay: float) -> Optimizer:
    """The named optimizer over the model's trainable parameters in the 3 groups, its state on their device."""
    return Optimizer(name, model, lr, momentum, weight_decay)


def nadam_mu_product(step: int, beta1: float, momentum_decay: float = 0.004) -> float:
    """NAdam's running mu_product after `step` updates at a constant beta1 (for resume)."""
    i = np.arange(1, int(step) + 1, dtype=np.float64)
    return float(np.prod(beta1 * (1 - 0.5 * 0.96 ** (i * momentum_decay)))) if step else 1.0


def moments(name: str, optimizer: Optimizer, named: Dict[str, nn.Parameter]):
    """The optimizer's first and second moments by parameter name (zeros for a parameter it does not hold)."""
    index = {id(p): i for i, p in enumerate(optimizer.params)}
    mu, nu = {}, {}
    for n, p in named.items():
        i = index.get(id(p))
        mu[n] = optimizer.mu[i] if i is not None else torch.zeros_like(p, requires_grad=False)
        nu[n] = optimizer.nu[i] if i is not None else torch.zeros_like(p, requires_grad=False)
    return mu, nu


@torch.no_grad()
def load_moments(name: str, optimizer: Optimizer, named: Dict[str, nn.Parameter], mu: Dict, nu: Dict,
                 step: int, beta1: float) -> None:
    """Restore the moments by name, in place, and the state of `step` updates: the step, and NAdam's mu_product at
    a constant beta1, as the JAX package's resume sets them."""
    index = {id(p): i for i, p in enumerate(optimizer.params)}
    for n, p in named.items():
        i = index.get(id(p))
        if i is None:
            continue
        optimizer.mu[i].copy_(mu[n])
        optimizer.nu[i].copy_(nu[n])
    optimizer.step.fill_(int(step))
    optimizer.extra.fill_(float(np.float32(nadam_mu_product(step, beta1))) if name == "NAdam" else 1.0)
