"""Weights and checkpoints in the JAX package's native format (port of yololite_tpu/models/checkpoint.py).

The JAX package keeps a model's weights as two nested dicts, params and
state, keyed by row index and submodule name: a conv's {'w' (HWIO), 'b'},
a transposed conv's 'wt' (spatially flipped HWIO; 5-dim (kh, kw, c_in/g, g,
c_out/g) for DWConvTranspose2d), a BN's {'scale', 'bias'} in params and
{'mean', 'var'} in state, and the leaves of Linear, LayerNorm and attention
under their torch names ('weight', 'bias', 'in_proj_weight', 'logit_scale',
...). Here they map onto the torch modules of the same names: OIHW conv
weights, (c_in, c_out/g, kh, kw) transposed-conv weights, BN weight, bias,
running_mean and running_var. Nothing of JAX is imported; the trees hold
numpy arrays.

A native checkpoint is one .npz: `params.<path>` and `state.<path>` arrays
plus a `__meta__` JSON header, written atomically. A trainer's checkpoint
nests its state: `state.model_state` (the EMA's BN statistics beside the EMA
weights in params), `state.raw_params`, `state.raw_state` and the optimizer's
moments `state.opt.mu` / `state.opt.nu`, all in the params layout. Either
package resumes or predicts from the other's file.

Upstream `.pt` checkpoints (a pickled dict holding a whole torch
DetectionModel under 'ema' or 'model') load without the upstream code: every
class outside a short list of safe roots unpickles into a stub, the port's own
classes included, tensors rebuild through torch's reducers, and the state_dict
is walked out of the stub tree. The port's modules carry the upstream names,
so the mapping is a state_dict load: strict, or the intersect transfer when
the class count differs. A pickled multi-member Ensemble loads as an
`EnsembleModel`.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from yololite_tpu_torch.utils import LOGGER


def _to_torch(v) -> torch.Tensor:
    """A host array as a tensor that owns a C-ordered copy."""
    return torch.from_numpy(np.array(v, copy=True, order="C"))


def from_jax_layout(layout: str, v: np.ndarray) -> np.ndarray:
    """A JAX leaf in torch's layout: 'conv' HWIO -> OIHW; 'convT' flipped HWIO -> (c_in, c_out, kh, kw);
    'convT5' flipped (kh, kw, c_in/g, g, c_out/g) -> (c_in, c_out/g, kh, kw); 'id' as it is."""
    if layout == "conv":
        return v.transpose(3, 2, 0, 1)
    if layout == "convT":
        return v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if layout == "convT5":
        kh, kw, cig, g, og = v.shape
        return v.transpose(3, 2, 4, 0, 1).reshape(g * cig, og, kh, kw)[:, :, ::-1, ::-1]
    return v


def to_jax_layout(layout: str, a: np.ndarray, groups: int = 1) -> np.ndarray:
    """The inverse of `from_jax_layout` (`groups` of a DWConvTranspose2d for 'convT5')."""
    if layout == "conv":
        return a.transpose(2, 3, 1, 0)
    if layout == "convT":
        return a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if layout == "convT5":
        c1, og, kh, kw = a.shape
        return a[:, :, ::-1, ::-1].reshape(groups, c1 // groups, og, kh, kw).transpose(3, 4, 1, 0, 2)
    return a


def _is_bn_node(node: Dict) -> bool:
    """A BN's params node holds exactly 'scale' and 'bias' (a block's own 'scale' sits beside other leaves)."""
    return set(node) == {"scale", "bias"}


def state_dict_from_jax(params: Dict, state: Dict, prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """Map (params, state) trees to upstream-named tensors that load with strict=True.

    A fused tree ({'conv': {'w', 'b'}}) maps to `conv.weight` / `conv.bias`,
    which loads into a fused model.
    """
    out: Dict[str, torch.Tensor] = {}

    def put(path, leaf, v):
        out[prefix + ".".join(path + (leaf,))] = _to_torch(v)

    def walk_params(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk_params(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "w":
                put(path, "weight", from_jax_layout("conv", v))
            elif k == "wt":
                put(path, "weight", from_jax_layout("convT5" if v.ndim == 5 else "convT", v))
            elif k == "b":
                put(path, "bias", v)
            elif k == "scale" and _is_bn_node(node):
                put(path, "weight", v)
            elif k in ("scale", "bias", "weight", "in_proj_weight", "in_proj_bias", "logit_scale"):
                put(path, k, v)
            else:
                raise KeyError(f"unmapped param leaf '{k}' at {prefix + '.'.join(path)}")

    def walk_state(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk_state(v, path + (k,))
                continue
            if k == "mean":
                put(path, "running_mean", np.asarray(v))
                out[prefix + ".".join(path + ("num_batches_tracked",))] = torch.tensor(0)
            elif k == "var":
                put(path, "running_var", np.asarray(v))
            else:
                raise KeyError(f"unmapped state leaf '{k}' at {prefix + '.'.join(path)}")

    walk_params(params, ())
    walk_state(state, ())
    return out


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"), "running_mean": ("state", "mean"),
              "running_var": ("state", "var")}


def leaf_paths(model: nn.Module, prefix: str = "model.") -> Dict[str, Tuple[str, Tuple[str, ...], str, int]]:
    """Torch state_dict name -> ('params' or 'state', path of the JAX leaf, layout, groups) for every parameter
    and BN statistic (`prefix` "" for a bare block)."""
    from yololite_tpu_torch.models.zoo import DWConvTranspose2d

    out = {}
    for mname, m in model.named_modules():
        if prefix and not mname.startswith(prefix):
            continue
        rel = mname[len(prefix):]
        path = tuple(rel.split(".")) if rel else ()
        key = f"{mname}." if mname else ""
        if isinstance(m, nn.BatchNorm2d):
            for pname, (kind, leaf) in _BN_LEAVES.items():
                out[key + pname] = (kind, path + (leaf,), "id", 1)
            continue
        for pname, _ in m.named_parameters(recurse=False):
            leaf, layout = pname, "id"
            if isinstance(m, nn.ConvTranspose2d) and pname == "weight":
                leaf, layout = "wt", "convT5" if isinstance(m, DWConvTranspose2d) else "convT"
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                leaf, layout = ("w", "conv") if pname == "weight" else ("b", "id")
            out[key + pname] = ("params", path + (leaf,), layout, getattr(m, "groups", 1))
    return out


def _to_jax_layout(t: torch.Tensor, layout: str, groups: int) -> np.ndarray:
    """A host copy of t in the JAX layout (the copy is taken now, so later in-place steps cannot reach it)."""
    return np.ascontiguousarray(to_jax_layout(layout, t.detach().to("cpu", copy=True).numpy(), groups))


def _put(tree: Dict, path: Tuple[str, ...], v) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = v


def _get(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def jax_trees(model: nn.Module, prefix: str = "model.") -> Tuple[Dict, Dict]:
    """The model's (params, state) trees in the JAX package's names and layout, as host numpy copies."""
    params, state = {}, {}
    sd = model.state_dict()
    for name, (kind, path, layout, groups) in leaf_paths(model, prefix).items():
        _put(params if kind == "params" else state, path, _to_jax_layout(sd[name], layout, groups))
    return params, state


def tree_of(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict:
    """Per-parameter tensors (by torch name) as a params-layout tree of host numpy copies (optimizer moments)."""
    tree = {}
    paths = leaf_paths(model)
    for name, t in tensors.items():
        _, path, layout, groups = paths[name]
        _put(tree, path, _to_jax_layout(t, layout, groups))
    return tree


def tensors_of(model: nn.Module, tree: Dict, names) -> Dict[str, torch.Tensor]:
    """The inverse of `tree_of` for the given parameter names: params-layout tree -> torch-layout tensors."""
    paths = leaf_paths(model)
    out = {}
    for name in names:
        _, path, layout, _ = paths[name]
        out[name] = _to_torch(from_jax_layout(layout, np.asarray(_get(tree, path))))
    return out


def load_jax_trees(model: nn.Module, params: Dict, state: Dict) -> nn.Module:
    """Copy (params, state) trees into the model in place (strict: every entry must be there).

    An EnsembleModel takes the JAX ensemble's trees, keyed "m0", "m1", ... per member.
    """
    from yololite_tpu_torch.models.model import EnsembleModel

    if isinstance(model, EnsembleModel):
        for i, m in enumerate(model.members):
            load_jax_trees(m, params[f"m{i}"], state.get(f"m{i}", {}))
        return model
    sd = state_dict_from_jax(params, state)
    for k, v in model.state_dict().items():  # keep the model's own BN batch counters
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


def _jax_node(tree: Dict, path: Tuple[str, ...]) -> Dict:
    node = tree
    for p in path:
        node = node.get(p, {}) if isinstance(node, dict) else {}
    return node


@torch.no_grad()
def quantized_from_jax(model: nn.Module, q_params: Dict) -> nn.Module:
    """The int8 serving net that a JAX quantized tree (`models/quant.py quantize_model`) describes.

    A fused, bf16 copy of `model`'s structure: each Conv whose node has `q`
    becomes a QConv from `q.w` (int8 HWIO), `sw`, `sin`, `sout` (if present)
    and the folded bias `conv.b`; every other conv takes the node's fused
    float `w`/`b` (and `deq_s`). Weights stay on the CPU.
    """
    from yololite_tpu_torch.models import modules as M
    from yololite_tpu_torch.models.quant import _float_modules_to_bf16

    net = copy.deepcopy(model).cpu().float().eval().fuse()
    for name, mod in list(net.named_modules()):
        if not name.startswith("model."):
            continue
        node = _jax_node(q_params, tuple(name[len("model."):].split(".")))
        if isinstance(mod, M.Conv):
            conv = mod.conv
            if "q" in node:
                q = node["q"]
                mod.conv = M.QConv(_to_torch(q["w"]).permute(3, 0, 1, 2), _to_torch(q["sw"]),
                                   _to_torch(node["conv"]["b"]), float(np.float32(q["sin"])),
                                   float(np.float32(q["sout"])) if "sout" in q else None, conv.stride[0],
                                   conv.padding[0], conv.groups)
            else:
                conv.weight.copy_(_to_torch(node["conv"]["w"]).permute(3, 2, 0, 1))
                conv.bias.copy_(_to_torch(node["conv"]["b"]))
                if "deq_s" in node:
                    mod.deq_s = float(np.float32(node["deq_s"]))
        elif isinstance(mod, nn.Conv2d) and not name.endswith(".conv"):  # a plain conv (Detect's logits)
            mod.weight.copy_(_to_torch(node["w"]).permute(3, 2, 0, 1))
            mod.bias.copy_(_to_torch(node["b"]))
            if "deq_s" in node:
                mod.deq_s = float(np.float32(node["deq_s"]))
    return _float_modules_to_bf16(net)


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


# ---- upstream .pt checkpoints ----


class _Stub:
    """Generic unpickle target for every class outside the safe roots."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, d):
        if isinstance(d, dict):
            self.__dict__.update(d)
        else:
            self.__dict__["_state"] = d


class _StubUnpickler(pickle.Unpickler):
    _SAFE_ROOTS = {"torch", "collections", "builtins", "numpy", "argparse", "pathlib", "types", "copyreg"}

    def find_class(self, module, name):
        if module.split(".")[0] in self._SAFE_ROOTS:
            try:
                return super().find_class(module, name)
            except (AttributeError, ModuleNotFoundError):
                pass
        return type(name, (_Stub,), {"__module__": module})


def _torch_load_stubbed(path):
    """torch.load with stubbed class resolution (weights land as real tensors on the CPU)."""
    stub_pickle = SimpleNamespace(__name__="stub_pickle", Unpickler=_StubUnpickler, load=pickle.load,
                                  loads=pickle.loads, dump=pickle.dump, dumps=pickle.dumps)
    return torch.load(path, map_location="cpu", pickle_module=stub_pickle, weights_only=False)


def _walk_module(obj, prefix="") -> Dict[str, torch.Tensor]:
    """A state_dict (fp32 CPU copies) out of a stubbed or real torch module tree."""
    out: Dict[str, torch.Tensor] = {}
    d = getattr(obj, "__dict__", {})
    for name, t in (d.get("_parameters") or {}).items():
        if t is not None:
            out[prefix + name] = t.detach().to("cpu").float().clone()
    for name, t in (d.get("_buffers") or {}).items():
        if isinstance(t, torch.Tensor):
            out[prefix + name] = t.detach().to("cpu").float().clone()
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(_walk_module(child, f"{prefix}{name}."))
    return out


def _ensemble_members(net, path):
    """The member list of a pickled Ensemble (an nn.ModuleList of models), or None for a plain model."""
    d = getattr(net, "__dict__", {})
    mods = d.get("_modules") or {}
    own_params = d.get("_parameters") or {}
    if mods and not own_params and all(str(k).isdigit() for k in mods):
        members = [m for m in mods.values() if m is not None]
        if not members:
            raise ValueError(f"checkpoint {path}: empty Ensemble")
        return members
    return None


def _sd_is_fused(sd: Dict[str, torch.Tensor]) -> bool:
    """True if the state_dict has BN folded into the convs (conv biases, no bn entries)."""
    has_bn = any(".bn." in f".{k}" for k in sd)
    has_conv_bias = any(k.endswith("conv.bias") for k in sd)
    return has_conv_bias and not has_bn


def _net_sd_meta(net, ckpt, path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict without the outer 'model.' prefix, meta) of one unpickled model."""
    from yololite_tpu_torch.models.model import guess_model_scale

    sd = _walk_module(net)
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    meta: Dict[str, Any] = {}
    nd = getattr(net, "__dict__", {})
    meta["yaml"] = nd.get("yaml")
    args = ckpt.get("train_args") or nd.get("args")
    if args is not None and not isinstance(args, dict):
        args = vars(args) if hasattr(args, "__dict__") or isinstance(args, SimpleNamespace) else None
    meta["args"] = args or {}
    meta["names"] = nd.get("names")
    meta["epoch"] = ckpt.get("epoch", -1)
    meta["best_fitness"] = ckpt.get("best_fitness")
    meta["scale"] = (meta["yaml"] or {}).get("scale") or guess_model_scale(path)
    meta["nc"] = (meta["yaml"] or {}).get("nc")
    if meta["nc"] is None and meta["names"]:
        meta["nc"] = len(meta["names"])
    return sd, meta


def read_pt_members(path) -> List[Tuple[Dict[str, torch.Tensor], Dict[str, Any]]]:
    """A .pt checkpoint -> [(state_dict, meta), ...], one entry per model ('ema' preferred over 'model').

    A plain checkpoint gives one entry; a pickled multi-member Ensemble one
    entry per member, in order.
    """
    ckpt = _torch_load_stubbed(str(path))
    if not isinstance(ckpt, dict):
        ckpt = {"model": ckpt}
    net = ckpt.get("ema") or ckpt.get("model")
    if net is None:
        raise ValueError(f"checkpoint {path} has no 'model' or 'ema' entry")
    members = _ensemble_members(net, path) or [net]
    return [_net_sd_meta(m, ckpt, path) for m in members]


def read_pt_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, meta) of the (last) model of a .pt checkpoint.

    meta keys: 'yaml', 'args', 'names', 'scale', 'nc', 'epoch', 'best_fitness'.
    """
    return read_pt_members(path)[-1]


def map_state_dict_into(sd: Dict[str, torch.Tensor], model: nn.Module, strict: bool = True) -> nn.Module:
    """Load upstream-named tensors (names relative to `model.model`) into the model in place.

    strict=True wants every entry to land and every leaf of the model to be
    filled, with equal shapes. strict=False is the intersect transfer of a
    fine-tune onto another class count: unknown or shape-mismatched entries
    are skipped and the leaves they would fill keep their fresh values.
    BN batch counters and the upstream Detect's fixed `dfl` conv are skipped.
    """
    own = model.state_dict()
    filled = set()
    for name, v in sd.items():
        parts = name.split(".")
        if parts[-1] == "num_batches_tracked" or "dfl" in parts:
            continue
        key = f"model.{name}"
        if key not in own:
            if strict:
                raise KeyError(f"checkpoint entry '{name}' has no place in the model")
            continue
        if tuple(own[key].shape) != tuple(v.shape):
            if strict:
                raise ValueError(f"shape mismatch at {name}: {tuple(own[key].shape)} vs {tuple(v.shape)}")
            continue
        own[key] = v.to(own[key].dtype)
        filled.add(key)
    leaves = [k for k in own if not k.endswith("num_batches_tracked")]
    missing = [k for k in leaves if k not in filled]
    if missing and strict:
        raise ValueError(f"checkpoint import left {len(missing)} leaves unfilled, e.g. {missing[:5]}")
    if not strict:
        LOGGER.info(f"Transferred {len(filled)}/{len(leaves)} items from pretrained weights")
    model.load_state_dict(own, strict=True)
    return model


def load_pt(path, nc: Optional[int] = None) -> Tuple[nn.Module, Dict]:
    """Load a .pt checkpoint -> (DetectionModel or EnsembleModel on the CPU in fp32, meta).

    Each member becomes a DetectionModel of the spec the checkpoint carries
    (its model's `yaml` dict; `yolo11{scale}.yaml` when it has none) with
    init(0) weights, which the checkpoint overwrites (fused first, if the
    checkpoint's BN is folded). When `nc` differs from the checkpoint's class
    count, the transfer is the intersect one: the class head keeps its init.
    """
    from yololite_tpu_torch.models.model import DetectionModel, EnsembleModel

    members = read_pt_members(path)

    def build_one(sd, meta):
        spec = meta.get("yaml")
        cfg = spec if isinstance(spec, dict) and spec.get("backbone") else f"yolo11{meta.get('scale') or 'n'}.yaml"
        model = DetectionModel(cfg, nc=nc or meta.get("nc")).init(0)
        if meta.get("names") and len(meta["names"]) == model.nc:
            model.names = meta["names"]
        model.args = meta.get("args", {})
        if _sd_is_fused(sd):
            model.fuse()
        return map_state_dict_into(sd, model, strict=nc is None or meta.get("nc") in (None, nc))

    if len(members) == 1:
        sd, meta = members[0]
        return build_one(sd, meta), meta
    ens = EnsembleModel([build_one(sd, meta) for sd, meta in members])
    meta = members[-1][1]
    ens.args = meta.get("args", {})
    LOGGER.info(f"checkpoint {path}: loaded Ensemble of {len(members)} models (pre-NMS concat)")
    return ens, meta


def attempt_load_one_weight(path, nc: Optional[int] = None):
    """Load one checkpoint, .pt or native .npz -> (model with its (EMA) weights on the CPU, meta)."""
    path = str(path)
    if path.endswith(".pt"):
        return load_pt(path, nc=nc)
    from yololite_tpu_torch.models.model import DetectionModel

    params, state, meta = load_native(path)
    model = DetectionModel(meta.get("cfg", "yolo11n.yaml"), nc=nc or meta.get("nc"))
    if meta.get("names"):
        model.names = {int(k): v for k, v in meta["names"].items()}
    model.args = meta.get("args", {})
    load_jax_trees(model, params, state.get("model_state", state))
    return model, meta
