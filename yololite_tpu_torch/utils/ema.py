"""EMA of the model's weights and BN statistics (port of yololite_tpu/utils/ema.py)."""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """Ramped decay d(t) = decay * (1 - exp(-t / tau)), in float32 as the JAX package computes it."""
    d = np.float32(decay) * (np.float32(1) - np.exp(-np.float32(updates) / np.float32(tau)))
    return float(np.float32(d))


class ModelEMA:
    """An eval-mode copy of the model whose floating state_dict entries follow ema = d * ema + (1 - d) * model.

    That covers the parameters and the BN running mean and var; integer
    entries (the BN batch counters) are copied.
    """

    def __init__(self, model: nn.Module, updates: int = 0):
        self.ema = copy.deepcopy(model).eval()
        for p in self.ema.parameters():
            p.requires_grad_(False)
        self.updates = updates

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.updates += 1
        d = ema_decay(self.updates)
        e_f, m_f = [], []
        for e, m in zip(self.ema.state_dict().values(), model.state_dict().values()):
            if e.is_floating_point():
                e_f.append(e)
                m_f.append(m.detach())
            else:
                e.copy_(m)
        torch._foreach_mul_(e_f, d)
        torch._foreach_add_(e_f, torch._foreach_mul(m_f, float(np.float32(1) - np.float32(d))))
