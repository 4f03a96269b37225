"""Weight bridge: the JAX package's parameter/state pytrees -> a torch state_dict.

Port of the mapping in yololite_tpu/models/checkpoint.py `pytree_to_state_dict`,
for the leaves the YOLO11 blocks hold. Input is the two nested dicts with
numpy (or array-like) leaves; nothing of JAX is imported. HWIO conv weights
become OIHW; BN {scale, bias} / {mean, var} become {weight, bias} /
{running_mean, running_var}. A fused tree ({'conv': {'w', 'b'}}) maps to
`conv.weight` / `conv.bias`, which loads into a fused model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_dict_from_jax(params: Dict, state: Dict, prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """Map (params, state) pytrees to upstream-named tensors that load with strict=True."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, v):
        out[name] = torch.from_numpy(np.array(v, copy=True, order="C"))

    def walk_params(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk_params(v, path + (k,))
                continue
            v = np.asarray(v)
            name = prefix + ".".join(path)
            if k == "w":
                put(f"{name}.weight", v.transpose(3, 2, 0, 1))
            elif k == "b":
                put(f"{name}.bias", v)
            elif k == "scale":  # bn scale lives under a 'bn' path component
                put(f"{name}.weight", v)
            elif k == "bias":
                put(f"{name}.bias", v)
            else:
                raise KeyError(f"unmapped param leaf '{k}' at {name}")

    def walk_state(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk_state(v, path + (k,))
                continue
            name = prefix + ".".join(path)
            if k == "mean":
                put(f"{name}.running_mean", np.asarray(v))
                out[f"{name}.num_batches_tracked"] = torch.tensor(0)
            elif k == "var":
                put(f"{name}.running_var", np.asarray(v))
            else:
                raise KeyError(f"unmapped state leaf '{k}' at {name}")

    walk_params(params, ())
    walk_state(state, ())
    return out
