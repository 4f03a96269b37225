"""EMA of the model's weights and BN statistics (port of yololite_tpu/utils/ema.py)."""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

from yololite_tpu_torch.ops.optim_kernels import ema_plain


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """Ramped decay d(t) = decay * (1 - exp(-t / tau)), in float32 as the JAX package computes it."""
    d = np.float32(decay) * (np.float32(1) - np.exp(-np.float32(updates) / np.float32(tau)))
    return float(np.float32(d))


class ModelEMA:
    """An eval-mode copy of the model whose floating state_dict entries follow ema = d * ema + (1 - d) * model.

    That covers the parameters and the BN running mean and var; integer
    entries (the BN batch counters) are copied. An update is two parts:
    `advance` counts it on the host (`updates`, which checkpoints keep) and
    writes its decay d and 1 - d into two 0-d float32 tensors on the model's
    device. The trainer's apply moves the EMA inside K10
    (ops/optim_kernels.py `optim_apply`, reading d and 1 - d from these
    tensors, so a CUDA graph of it reads each update's decay); `apply` runs
    the same update by itself through K10's plain form (`ema_plain`). d and
    1 - d are float32 values, so the tensors give the bits that the Python
    floats gave.
    """

    def __init__(self, model: nn.Module, updates: int = 0):
        self.ema = copy.deepcopy(model).eval()
        for p in self.ema.parameters():
            p.requires_grad_(False)
        self.updates = updates
        device = next(self.ema.parameters()).device
        self.d = torch.zeros((), dtype=torch.float32, device=device)  # the decay of the next apply
        self.one_minus_d = torch.zeros((), dtype=torch.float32, device=device)

    def advance(self) -> None:
        """Count one update and write its decay into `d` and `one_minus_d` (in place, no host sync)."""
        self.updates += 1
        d = ema_decay(self.updates)
        self.d.fill_(d)
        self.one_minus_d.fill_(float(np.float32(1) - np.float32(d)))

    def apply(self, model: nn.Module) -> None:
        """ema = d * ema + (1 - d) * model at the decay `advance` wrote."""
        pairs = list(zip(self.ema.state_dict().values(), model.state_dict().values()))
        ema_plain([(e, m) for e, m in pairs if e.is_floating_point()],
                  [(e, m) for e, m in pairs if not e.is_floating_point()], self.d, self.one_minus_d)

    def update(self, model: nn.Module) -> None:
        self.advance()
        self.apply(model)
