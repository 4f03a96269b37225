"""YOLOLite facade (port of yololite_tpu/engine/model.py): build or load, predict, val, train, save, info.

`YOLOLite("yolo11n.yaml")` builds the model with `init(0)` on the card, and
`YOLOLite("last.npz")` loads a native checkpoint of either package; pass
device="cpu" to run on the CPU. Export and loading .pt checkpoints raise
NotImplementedError naming their place in ROADMAP.md.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from yololite_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.utils import LOGGER, select_device


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported to yololite_tpu_torch yet (ROADMAP.md, Queue 1, {where})")


class YOLOLite:
    """Facade: `YOLOLite('yolo11n.yaml')(images)` -> list of Results."""

    def __init__(self, model: Union[str, Path, Dict] = "yolo11n.yaml", task: str = "detect", verbose: bool = False,
                 device=None):
        if task != "detect":
            raise ValueError(f"only detection is supported, got task={task!r}")
        self.task = task
        self.device = select_device(device)
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
            raise _not_ported(f"loading the checkpoint '{model}'", "'The rest' (models/checkpoint.py)")

    def _new(self, cfg, verbose: bool = False):
        self.model = DetectionModel(cfg, verbose=verbose).init(0).to(self.device)
        self.overrides["task"] = self.task

    def _load_native(self, path: str):
        """The EMA weights (and BN statistics) of a native .npz, with its names and train args."""
        model, meta = ckpt.attempt_load_one_weight(path)
        self.model = model.to(self.device)
        self.ckpt = meta
        self.overrides = {k: v for k, v in (meta.get("args") or {}).items() if k in DEFAULT_CFG_DICT}
        self.overrides.update({"model": path, "task": self.task})
        self.predictor = None
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
                    for k in ("conf", "iou", "max_det", "agnostic_nms", "augment", "half", "classes"))
        if self.predictor is None or predictor is not None or getattr(self.predictor, "_sig", None) != sig:
            self.predictor = (predictor or DetectionPredictor)(overrides=args, device=self.device)
            self.predictor.setup_model(self.model)
            self.predictor._sig = sig
        else:
            self.predictor.args = get_cfg(self.predictor.args, kwargs)
        return self.predictor(source=source, stream=stream)

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

        v = (validator or DetectionValidator)(args=args, device=self.device)
        v(model=self.model)
        self.metrics = v.metrics
        return v.metrics

    def train(self, trainer=None, **kwargs):
        """Train on `data` on self.device; afterwards the facade holds best.npz's weights, if one was written."""
        args = {**self.overrides, "mode": "train", **kwargs}
        if args.get("resume"):
            args["resume"] = self.ckpt_path
        from yololite_tpu_torch.engine.trainer import DetectionTrainer

        self.trainer = (trainer or DetectionTrainer)(overrides=args, device=self.device)
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

    def export(self, *args, **kwargs):
        raise _not_ported("export", "'The rest' (runtime/export.py)")
