"""Post-training int8 quantization for serving (port of yololite_tpu/models/quant.py).

The same scheme as the JAX package:
- symmetric per-output-channel int8 weights, taken after the Conv+BN fold;
- one global activation scale `s_act` for every int8 edge: the largest
  post-activation absmax of any Conv over the calibration batches of a bf16
  forward, over 127. One scale makes the saturating int16 residual adds and
  the concats free of rescaling;
- bf16 islands: the attention of C2PSA (Attention, PSABlock) and the Detect
  logit layers stay float. The conv feeding an island keeps its int8 math but
  writes bf16 (no `sout`), and an unquantized Conv dequantizes an int8 input
  at its `deq_s`.

The quantized net is a fused copy of the model whose float modules are bf16
(the JAX package casts their weights to the bf16 activations at each use)
and whose quantized Convs hold a `QConv` (models/modules.py), which runs K8.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from yololite_tpu_torch.engine.predictor import forward_nhwc
from yololite_tpu_torch.models import modules as M
from yololite_tpu_torch.models.model import YOLO11_REGISTRY


def conv_paths(net: nn.Module):
    """(path, Conv) for every Conv of the net, path as the JAX tree's key tuple ('model.' dropped)."""
    for name, mod in net.named_modules():
        if isinstance(mod, M.Conv) and name.startswith("model."):
            yield tuple(name[len("model."):].split(".")), mod


@torch.no_grad()
def calibrate(net: nn.Module, batches: Iterable) -> Dict:
    """bf16 forwards of the fused net over `batches` ((B, H, W, 3) float in [0, 1]) -> {'s_act', 'per_path'}.

    Records every Conv's post-activation absmax (the JAX package's
    `Ctx.calibrate` / `act_absmax`), as forward hooks on a bf16 copy.
    """
    half = copy.deepcopy(net).to(torch.bfloat16).eval()
    device = next(half.parameters()).device
    per_path: Dict[Tuple[str, ...], float] = {}
    seen: Dict[Tuple[str, ...], torch.Tensor] = {}
    hooks = [mod.register_forward_hook(lambda m, i, y, path=path: seen.__setitem__(path, y.float().abs().amax()))
             for path, mod in conv_paths(half)]
    try:
        for images in batches:
            seen.clear()
            forward_nhwc(half, torch.as_tensor(np.asarray(images, np.float32)).to(device, torch.bfloat16))
            for path, v in seen.items():
                per_path[path] = max(per_path.get(path, 0.0), float(v))
    finally:
        for h in hooks:
            h.remove()
    s_act = max(per_path.values()) / 127.0
    return {"s_act": s_act, "per_path": {k: v / 127.0 for k, v in per_path.items()}}


def _quantize_conv(mod: M.Conv, s_act: float, sin: float, requant: bool) -> M.QConv:
    """A fused Conv's float weights -> its QConv (port of `_quantize_conv`)."""
    conv = mod.conv
    w = conv.weight.detach().float().cpu()  # OIHW
    sw = torch.clamp(w.abs().amax((1, 2, 3)) / 127.0, min=1e-12)  # per output channel
    wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127).to(torch.int8)
    return M.QConv(wq.permute(0, 2, 3, 1), sw, conv.bias.detach().float().cpu(), sin, s_act if requant else None,
                   conv.stride[0], conv.padding[0], conv.groups)


def quantize_tree(net: nn.Module, scales: Dict) -> nn.Module:
    """Walk the fused net as the JAX `quantize_tree` walks its modules, quantizing every eligible Conv in place.

    Stay float, with `deq_s`: everything under Attention / PSABlock, and the
    Detect logit Conv2d's. Quantized without `sout` (bf16 out): C2PSA's cv1,
    and in each Detect branch the element just before the logit conv (in cv2
    one Conv, in cv3 the whole second Seq(DWConv, Conv)). The one2one branches
    of an end2end head are not walked.
    """
    s_act = float(np.float32(scales["s_act"]))

    def walk(mod: nn.Module, quantize_ok: bool, requant: bool) -> None:
        if isinstance(mod, (M.Attention, M.PSABlock)):
            quantize_ok = False
        if isinstance(mod, M.Conv):  # includes DWConv
            if quantize_ok and not isinstance(mod.conv, M.QConv) and mod.conv.bias is not None:
                mod.conv = _quantize_conv(mod, s_act, s_act, requant)
            else:
                mod.deq_s = s_act
            return
        if isinstance(mod, nn.Conv2d):
            mod.deq_s = s_act
            return
        if isinstance(mod, M.Detect):
            for branch in (mod.cv2, mod.cv3):
                for seq in branch:
                    for j, sub in enumerate(seq):
                        walk(sub, quantize_ok, requant=j != len(seq) - 2)  # j == len - 2 feeds the logits
            return
        if isinstance(mod, M.C2PSA):  # cv1 feeds the attention island: int8 math, bf16 out
            walk(mod.cv1, quantize_ok, False)
            walk(mod.m, False, requant)
            walk(mod.cv2, quantize_ok, requant)
            return
        for child in mod.children():
            walk(child, quantize_ok, requant)

    for row in net.model:
        walk(row, True, True)
    return net


def refuse_zoo_rows(net: nn.Module) -> None:
    """Raise NotImplementedError if the net holds a row of the extended block zoo.

    The zoo's blocks never take an int8 edge, and the JAX package cannot run
    one in int8 either: its RepConv and RepVGGDW apply SiLU to the sum of two
    int8 conv outputs (yololite_tpu/models/zoo.py:264, 277), which raises
    TypeError there. So int8 serving stays on models of YOLO11 blocks alone.
    """
    for row in net.model:
        if row.name not in YOLO11_REGISTRY:
            raise NotImplementedError(
                f"int8 serving: row {row.i} ({row.name}) is a block of the extended zoo; the JAX package cannot "
                "run the zoo in int8 either (RepConv and RepVGGDW apply SiLU to an int8 sum, "
                "yololite_tpu/models/zoo.py:264, 277), so only models of YOLO11 blocks quantize")


def quantize_model(net: nn.Module, calib_batches, device: Optional[torch.device] = None) -> Tuple[nn.Module, Dict]:
    """fuse -> calibrate -> quantize: (the int8 serving copy of `net` on `device`, scales).

    `net` is a DetectionModel, fused or not, in fp32 or bf16; it is left as
    it is. The copy's float modules are bf16; its QConvs keep fp32 scales.
    A model with a row of the extended zoo raises first (`refuse_zoo_rows`).
    """
    refuse_zoo_rows(net)
    device = device or next(net.parameters()).device
    fused = copy.deepcopy(net).eval()
    fused.fuse()
    fused = fused.float().to(device)
    scales = calibrate(fused, calib_batches)
    qnet = _float_modules_to_bf16(quantize_tree(fused, scales))
    return qnet.to(device), scales


@torch.no_grad()
def _float_modules_to_bf16(net: nn.Module) -> nn.Module:
    """Cast every float parameter and buffer to bf16 but the QConvs' fp32 scales and biases (in place)."""
    for mod in net.modules():
        if isinstance(mod, M.QConv):
            continue
        for name, p in mod.named_parameters(recurse=False):
            p.data = p.data.to(torch.bfloat16)
        for name, b in mod.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(mod, name, b.to(torch.bfloat16))
    return net


def quantized_paths(net: nn.Module) -> Dict[Tuple[str, ...], bool]:
    """{path of each quantized Conv: whether it requantizes its output (has sout)}."""
    return {path: mod.conv.sout is not None for path, mod in conv_paths(net) if isinstance(mod.conv, M.QConv)}
