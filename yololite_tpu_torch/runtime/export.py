"""Ahead-of-time export of the fused predict graph with torch.export (port of yololite_tpu/runtime/export.py).

Serializes forward + DFL decode + NMS, the graph the predictor runs, with the
weights inside, as `<path>` (`torch.export.save`) plus `<path>.json` (names,
shapes and thresholds for the host post-processing). The hand-written kernels
are `torch.library` ops in the graph: K3 (the candidate select and decode) and
K1 (the keep mask) always, K8 (the int8 convolution) when the graph is
quantized. Loading an artifact therefore
needs `yololite_tpu_torch` importable, for the registrations of those ops;
`load_exported` imports them. The artifact holds its weights on the device it
was exported on and runs there.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs, inference_net
from yololite_tpu_torch.ops.nms import nms_from_feats
from yololite_tpu_torch.utils import LOGGER, select_device


class PredictGraph(nn.Module):
    """The predictor's non-TTA graph as one module: normalized NHWC float32 images -> (B, max_det, 6) rows."""

    def __init__(self, net: nn.Module, strides, nc: int, reg_max: int, conf: float, iou: float, max_det: int,
                 half: bool):
        super().__init__()
        self.net = net
        self.strides, self.nc, self.reg_max = list(strides), int(nc), int(reg_max)
        self.conf, self.iou, self.max_det, self.half = float(conf), float(iou), int(max_det), bool(half)
        self.max_cand = max(256 if conf >= 0.25 else 512, max_det)  # the predictor's candidate-pool rule

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.bfloat16) if self.half else images
        return nms_from_feats(forward_nhwc(self.net, x), self.strides, self.nc, self.reg_max, conf_thres=self.conf,
                              iou_thres=self.iou, max_det=self.max_det, max_cand=self.max_cand, half=self.half)


def predict_graph(model, half: bool = True, fuse: bool = True, conf: float = 0.25, iou: float = 0.7,
                  max_det: int = 300, int8_calib: Optional[list] = None, device=None) -> PredictGraph:
    """The graph `export_predict` exports, in process: a fused (bf16 with half) copy of `model`, or with
    `int8_calib` its int8 serving copy (models/quant.py quantize_model on those batches)."""
    device = select_device(device) if device is not None else next(model.parameters()).device
    if int8_calib is not None:
        from yololite_tpu_torch.models.quant import quantize_model

        net, _ = quantize_model(model, int8_calib, device)
    else:
        net = inference_net(model, device, half, fuse)
    net.requires_grad_(False)
    return PredictGraph(net, model.strides, model.nc, model.reg_max, conf, iou, max_det, half).eval()


def export_predict(model, path, imgsz: int = 640, batch: int = 1, half: bool = True, fuse: bool = True,
                   conf: float = 0.25, iou: float = 0.7, max_det: int = 300, int8_calib: Optional[list] = None,
                   device=None) -> Path:
    """Export the fused predict graph with the weights inside; returns `path`.

    Contract: the input is a normalized float32 NHWC batch (batch, imgsz,
    imgsz, 3) on the export device (letterbox and /255 done by the caller);
    the output is (batch, max_det, 6) xyxy + conf + cls rows in input-pixel
    space, zero-padded: what the in-process graph (`predict_graph`) gives.
    int8_calib: a list of normalized NHWC float batches; when given, the graph
    is quantized on them first and its int8 convolutions run K8.
    """
    graph = predict_graph(model, half, fuse, conf, iou, max_det, int8_calib, device)
    dev = next(graph.parameters()).device
    example = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32, device=dev)
    program = torch.export.export(graph, (example,))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    meta = {
        "format": "torch.export",
        "device": str(dev),
        "imgsz": imgsz, "batch": batch, "half": half, "int8": int8_calib is not None,
        "conf": conf, "iou": iou, "max_det": max_det,
        "nc": model.nc, "names": model.names,
        "input": f"float32[{batch},{imgsz},{imgsz},3] normalized NHWC",
        "output": f"float32[{batch},{max_det},6] xyxy+conf+cls, zero-padded",
    }
    Path(f"{path}.json").write_text(json.dumps(meta, indent=2, default=str))
    LOGGER.info(f"exported predict graph to {path} ({path.stat().st_size / 1e6:.1f} MB) + {path}.json")
    return path


def load_exported(path) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Dict]:
    """Load an exported artifact -> (callable(images) -> (B, max_det, 6), meta).

    The callable runs without autograd and with cuDNN's TF32 off, as the
    predictor runs its fp32 graph.
    """
    import yololite_tpu_torch.ops.kernels  # noqa: F401  (registers the K1, K3, K4 and K8 ops the graph calls)

    path = Path(path)
    module = torch.export.load(str(path)).module()
    meta_path = Path(f"{path}.json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}

    def call(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), fp32_convs(images.device):
            return module(images)

    return call, meta
