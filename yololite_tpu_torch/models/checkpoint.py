"""Weights and checkpoints in the JAX package's native format (port of yololite_tpu/models/checkpoint.py).

The JAX package keeps a model's weights as two nested dicts, params and
state, keyed by row index and submodule name: a conv's {'w' (HWIO), 'b'},
a BN's {'scale', 'bias'} in params and {'mean', 'var'} in state. Here they map
onto the torch modules of the same names: OIHW conv weights, BN weight,
bias, running_mean and running_var. Nothing of JAX is imported; the trees
hold numpy arrays.

A native checkpoint is one .npz: `params.<path>` and `state.<path>` arrays
plus a `__meta__` JSON header, written atomically. A trainer's checkpoint
nests its state: `state.model_state` (the EMA's BN statistics beside the EMA
weights in params), `state.raw_params`, `state.raw_state` and the optimizer's
moments `state.opt.mu` / `state.opt.nu`, all in the params layout. Either
package resumes or predicts from the other's file.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from yololite_tpu_torch.utils import LOGGER


def state_dict_from_jax(params: Dict, state: Dict, prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """Map (params, state) trees to upstream-named tensors that load with strict=True.

    A fused tree ({'conv': {'w', 'b'}}) maps to `conv.weight` / `conv.bias`,
    which loads into a fused model.
    """
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


def leaf_paths(model: nn.Module, prefix: str = "model.") -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Torch state_dict name -> ('params' or 'state', path of the JAX leaf) for every conv and BN entry."""
    out = {}
    for mname, m in model.named_modules():
        if not mname.startswith(prefix):
            continue
        path = tuple(mname[len(prefix):].split("."))
        if isinstance(m, nn.Conv2d):
            out[f"{mname}.weight"] = ("params", path + ("w",))
            if m.bias is not None:
                out[f"{mname}.bias"] = ("params", path + ("b",))
        elif isinstance(m, nn.BatchNorm2d):
            out[f"{mname}.weight"] = ("params", path + ("scale",))
            out[f"{mname}.bias"] = ("params", path + ("bias",))
            out[f"{mname}.running_mean"] = ("state", path + ("mean",))
            out[f"{mname}.running_var"] = ("state", path + ("var",))
    return out


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    """A host copy of t, conv weights OIHW -> HWIO (the copy is taken now, so later in-place steps cannot reach it)."""
    a = t.detach().to("cpu", copy=True)
    return (a.permute(2, 3, 1, 0) if a.ndim == 4 else a).contiguous().numpy()


def _put(tree: Dict, path: Tuple[str, ...], v) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = v


def _get(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def jax_trees(model: nn.Module) -> Tuple[Dict, Dict]:
    """The model's (params, state) trees in the JAX package's names and layout, as host numpy copies."""
    params, state = {}, {}
    sd = model.state_dict()
    for name, (kind, path) in leaf_paths(model).items():
        _put(params if kind == "params" else state, path, _to_jax_layout(sd[name]))
    return params, state


def tree_of(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict:
    """Per-parameter tensors (by torch name) as a params-layout tree of host numpy copies (optimizer moments)."""
    tree = {}
    paths = leaf_paths(model)
    for name, t in tensors.items():
        _put(tree, paths[name][1], _to_jax_layout(t))
    return tree


def tensors_of(model: nn.Module, tree: Dict, names) -> Dict[str, torch.Tensor]:
    """The inverse of `tree_of` for the given parameter names: params-layout tree -> torch-layout tensors."""
    paths = leaf_paths(model)
    out = {}
    for name in names:
        v = torch.from_numpy(np.array(_get(tree, paths[name][1]), copy=True))
        out[name] = v.permute(3, 2, 0, 1).contiguous() if v.ndim == 4 else v
    return out


def load_jax_trees(model: nn.Module, params: Dict, state: Dict) -> nn.Module:
    """Copy (params, state) trees into the model in place (strict: every entry must be there)."""
    sd = state_dict_from_jax(params, state)
    for k, v in model.state_dict().items():  # keep the model's own BN batch counters
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


# ---- native checkpoint format (.npz + json header) ----


def _flatten(tree: Dict, prefix=()) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for name, v in flat.items():
        _put(tree, tuple(name.split(".")), v)
    return tree


def save_native(path, params: Dict, state: Dict, meta: Optional[Dict] = None) -> None:
    """Save (params, state) trees of numpy arrays and a JSON meta to one .npz.

    Atomic: written to a sibling .tmp file, then os.replace()d into place, so
    a crash mid-write never leaves a truncated checkpoint behind.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {f"params.{k}": v for k, v in _flatten(params).items()}
    flat.update({f"state.{k}": v for k, v in _flatten(state).items()})
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}, default=str).encode(), dtype=np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_native(path) -> Tuple[Dict, Dict, Dict]:
    """Load a native .npz checkpoint -> (params, state, meta), trees of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z.files else {}
        pflat = {k[len("params."):]: z[k] for k in z.files if k.startswith("params.")}
        sflat = {k[len("state."):]: z[k] for k in z.files if k.startswith("state.")}
    return _unflatten(pflat), _unflatten(sflat), meta


def strip_optimizer(path, out_path=None) -> Path:
    """Keep only the EMA weights and their BN statistics of a trainer checkpoint; returns the written path."""
    params, state, meta = load_native(path)
    slim_state = state.get("model_state", state)
    meta = dict(meta)
    meta.pop("ema_updates", None)
    meta["epoch"] = -1
    out = Path(out_path or path)
    save_native(out, params, slim_state, meta)
    LOGGER.info(f"Optimizer stripped from {path} -> {out}")
    return out


def attempt_load_one_weight(path, nc: Optional[int] = None):
    """Load one native checkpoint -> (DetectionModel with its (EMA) weights on the CPU, meta).

    `.pt` files are not ported yet.
    """
    path = str(path)
    if path.endswith(".pt"):
        raise NotImplementedError(f"loading the checkpoint '{path}' is not ported to yololite_tpu_torch yet "
                                  "(ROADMAP.md, Queue 1, 'The rest' (models/checkpoint.py))")
    from yololite_tpu_torch.models.model import DetectionModel

    params, state, meta = load_native(path)
    model = DetectionModel(meta.get("cfg", "yolo11n.yaml"), nc=nc or meta.get("nc"))
    if meta.get("names"):
        model.names = {int(k): v for k, v in meta["names"].items()}
    model.args = meta.get("args", {})
    load_jax_trees(model, params, state.get("model_state", state))
    return model, meta
