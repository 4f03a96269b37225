"""YOLOLite facade (port of yololite_tpu/engine/model.py): build or load, predict, embed, val, train, save,
export, info.

`YOLOLite("yolo11n.yaml")` builds the model with `init(0)` on the card,
`YOLOLite("last.npz")` loads a native checkpoint of either package and
`YOLOLite("yolo11n.pt")` an upstream-format .pt (a pickled multi-member
Ensemble loads as an EnsembleModel); pass device="cpu" to run on the CPU.

Several devices (device="0,1", a list, or None with more than one card
visible) go through to the engines: predict and val shard each batch over
them in this process, and train runs one data-parallel rank per device
(parallel/mesh.py). The model itself lives on the first.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from yololite_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.parallel.mesh import resolve_devices
from yololite_tpu_torch.utils import LOGGER


class YOLOLite:
    """Facade: `YOLOLite('yolo11n.pt')(images)` -> list of Results."""

    def __init__(self, model: Union[str, Path, Dict] = "yolo11n.pt", task: str = "detect", verbose: bool = False,
                 device=None):
        if task != "detect":
            raise ValueError(f"only detection is supported, got task={task!r}")
        self.task = task
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self.overrides: Dict = {}
        self.predictor = None
        self.trainer = None
        self.metrics = None
        self.ckpt = None
        self.ckpt_path = None
        if isinstance(model, dict):
            self._new(model, verbose=verbose)
            return
        model = str(model).strip()
        self.ckpt_path = model
        if model.endswith((".yaml", ".yml")):
            self._new(model, verbose=verbose)
            self.overrides["model"] = model
        elif model.endswith(".npz"):
            self._load_native(model)
        else:
            self._load(model)

    def _new(self, cfg, verbose: bool = False):
        self.model = DetectionModel(cfg, verbose=verbose).init(0).to(self.device)
        self.overrides["task"] = self.task

    def _load(self, weights: str):
        """An upstream-format .pt checkpoint: its (EMA) weights, names and train args."""
        if not Path(weights).exists():
            raise FileNotFoundError(f"checkpoint '{weights}' not found. Pass a yolo11[nslmx].yaml to build from "
                                    "scratch, or a .pt/.npz checkpoint path.")
        if not weights.endswith(".pt"):
            raise ValueError(f"unsupported checkpoint format: {weights}")
        model, meta = ckpt.load_pt(weights)
        self.model = model.to(self.device)
        self.ckpt = meta
        self.overrides = {k: v for k, v in (meta.get("args") or {}).items() if k in DEFAULT_CFG_DICT}
        self.overrides.update({"model": weights, "task": self.task})

    def _load_native(self, path: str):
        """The EMA weights (and BN statistics) of a native .npz, with its names and train args."""
        model, meta = ckpt.attempt_load_one_weight(path)
        self.model = model.to(self.device)
        self.ckpt = meta
        self.overrides = {k: v for k, v in (meta.get("args") or {}).items() if k in DEFAULT_CFG_DICT}
        self.overrides.update({"model": path, "task": self.task})
        self.predictor = None

    def _engine_device(self, kwargs: Dict):
        """A call's own device argument, else the facade's device, or its devices when it has several."""
        if kwargs.get("device") is not None:
            return kwargs["device"]
        return list(self.devices) if len(self.devices) > 1 else self.device

    @property
    def names(self):
        return self.model.names

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)

    def predict(self, source=None, stream: bool = False, predictor=None, **kwargs):
        if source is None:
            raise ValueError("predict() requires a source (path, list, or array)")
        custom = {"conf": 0.25, "batch": 1, "save": True, "mode": "predict"}
        args = {**self.overrides, **custom, **kwargs}
        from yololite_tpu_torch.engine.predictor import DetectionPredictor

        # NMS/forward settings are fixed when the predictor is set up; rebuild when they change
        sig = tuple(args.get(k) if not isinstance(args.get(k), list) else tuple(args.get(k))
                    for k in ("conf", "iou", "max_det", "agnostic_nms", "augment", "half", "classes", "int8",
                          "device"))
        if self.predictor is None or predictor is not None or getattr(self.predictor, "_sig", None) != sig:
            self.predictor = (predictor or DetectionPredictor)(overrides=args, device=self._engine_device(kwargs))
            self.predictor.setup_model(self.model)
            self.predictor._sig = sig
        else:
            self.predictor.args = get_cfg(self.predictor.args, kwargs)
        return self.predictor(source=source, stream=stream)

    @torch.no_grad()
    def embed(self, source, layers=None, imgsz: int = 640):
        """Mean-pooled feature embeddings of the given rows (default: the last saved row).

        One (n, C) array per batch that the source's loader yields (a list of
        arrays is one batch, files come one at a time). The model runs as it
        is held (unfused, eval mode, TF32 off) on the host-letterboxed images.
        """
        from yololite_tpu_torch.data.build import load_inference_source
        from yololite_tpu_torch.engine.predictor import fp32_convs
        from yololite_tpu_torch.ops.letterbox import preprocess_batch

        layers = layers or [max(self.model.save)]
        dataset = load_inference_source(source, batch=1)
        was = self.model.training
        self.model.eval()
        out = []
        try:
            for _, im0s, _ in dataset:
                im = torch.from_numpy(preprocess_batch(im0s, imgsz=imgsz)).to(self.device)
                features: Dict[int, torch.Tensor] = {}
                with fp32_convs(self.device):
                    self.model(im.permute(0, 3, 1, 2), capture=layers, features=features)
                pooled = [features[i].float().mean((2, 3)).cpu().numpy() for i in sorted(features)]
                out.append(np.concatenate(pooled, axis=-1))
        finally:
            self.model.train(was)
        return out

    def info(self, imgsz: int = 640):
        n = self.model.num_params()
        g = self.model.gflops(imgsz)
        LOGGER.info(
            f"yolo11{self.model.yaml.get('scale', '?')}: {n:,} parameters, "
            f"{g:.1f} GFLOPs @{imgsz}, strides {self.model.strides}"
        )
        return {"params": n, "gflops": g, "strides": self.model.strides}

    def val(self, validator=None, **kwargs):
        """Validate on `data` (a dataset yaml) on self.device -> DetMetrics; rect batches by default."""
        custom = {"rect": True, "mode": "val"}
        args = {**self.overrides, **custom, **kwargs}
        from yololite_tpu_torch.engine.validator import DetectionValidator

        v = (validator or DetectionValidator)(args=args, device=self._engine_device(kwargs))
        v(model=self.model)
        self.metrics = v.metrics
        return v.metrics

    def train(self, trainer=None, **kwargs):
        """Train on `data` on self.device; afterwards the facade holds best.npz's weights, if one was written."""
        args = {**self.overrides, "mode": "train", **kwargs}
        if args.get("resume"):
            args["resume"] = self.ckpt_path
        from yololite_tpu_torch.engine.trainer import DetectionTrainer

        self.trainer = (trainer or DetectionTrainer)(overrides=args, device=self._engine_device(kwargs))
        if not args.get("resume"):
            self.trainer.set_model(self.model)
        self.trainer.train()
        best = getattr(self.trainer, "best", None)
        if best and Path(best).exists():
            self._load_native(str(best))
        self.metrics = getattr(self.trainer, "metrics", None)
        return self.metrics

    def save(self, path: Union[str, Path]):
        """Save the weights as a native .npz (loads in either package)."""
        meta = {"cfg": dict(self.model.yaml), "nc": self.model.nc, "names": self.model.names, "args": self.overrides}
        params, state = ckpt.jax_trees(self.model)
        ckpt.save_native(path, params, state, meta)
        return path

    def export(self, path: Union[str, Path] = None, imgsz: int = 640, batch: int = 1, half: bool = True, **kwargs):
        """Export the fused predict graph (forward + decode + NMS, weights inside) with torch.export.

        See runtime/export.py for the input and output contract; reload with
        `yololite_tpu_torch.runtime.load_exported(path)`.
        """
        from yololite_tpu_torch.runtime.export import export_predict

        if path is None:
            path = Path(self.ckpt_path or "yolo11n").with_suffix(".pt2").name
        return export_predict(self.model, path, imgsz=imgsz, batch=batch, half=half, device=self.device, **kwargs)
