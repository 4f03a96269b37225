"""Inference results containers (host-side, numpy-backed).

Port of yololite_tpu/engine/results.py: the upstream attribute surface
(.boxes.xyxy/.conf/.cls, .plot(), .save_txt(), ...) backed by numpy arrays
copied off the device once per batch.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch.ops.boxes import xyxy2xywh
from yololite_tpu_torch.utils import LOGGER
from yololite_tpu_torch.utils.misc import SimpleClass
from yololite_tpu_torch.utils.plotting import Annotator, colors


class BaseTensor(SimpleClass):
    """Thin numpy container with torch-tensor-like conveniences."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.__class__(self.data[idx], self.orig_shape)

    def cpu(self):
        return self

    def numpy(self):
        return self.data

    def cuda(self):  # device shim: numpy-backed container
        return self

    def to(self, *args, **kwargs):  # device/dtype shim
        return self

    @property
    def shape(self):
        return self.data.shape


class Boxes(BaseTensor):
    """Detection boxes: data rows are [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, boxes: np.ndarray, orig_shape):
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        if boxes.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 or 7 columns, got {boxes.shape}")
        super().__init__(boxes, orig_shape)
        self.is_track = boxes.shape[-1] == 7
        self.orig_shape = orig_shape

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        return self.data[:, -3] if self.is_track else None

    @property
    def xywh(self):
        return xyxy2xywh(self.xyxy)

    @property
    def xyxyn(self):
        xy = self.xyxy.copy()
        xy[..., [0, 2]] /= self.orig_shape[1]
        xy[..., [1, 3]] /= self.orig_shape[0]
        return xy

    @property
    def xywhn(self):
        xy = self.xywh
        xy[..., [0, 2]] /= self.orig_shape[1]
        xy[..., [1, 3]] /= self.orig_shape[0]
        return xy


class Results(SimpleClass):
    """Single-image inference result: boxes + original image + bookkeeping."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str], boxes: Optional[np.ndarray] = None,
                 speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6), np.float32), self.orig_shape)
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}
        self.save_dir = None

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, idx):
        r = Results(self.orig_img, self.path, self.names, self.boxes.data[idx])
        r.speed = self.speed
        return r

    def update(self, boxes=None):
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)

    def new(self):
        """Empty Results carrying the same image/path/names."""
        r = Results(orig_img=self.orig_img, path=self.path, names=self.names)
        r.speed = self.speed
        return r

    def cpu(self):
        """No-op device shim: results are numpy-backed, already on the host."""
        return self

    def numpy(self):
        """No-op: already numpy."""
        return self

    def cuda(self):
        """Device-move shim: results stay on the host, so this is a no-op."""
        return self

    def to(self, *args, **kwargs):
        """Dtype-conversion shim; device arguments are ignored."""
        dtype = kwargs.get("dtype") or next((a for a in args if not isinstance(a, str)), None)
        if dtype is not None:
            try:
                r = self.new()
                r.boxes = Boxes(self.boxes.data.astype(dtype), self.orig_shape)
                return r
            except TypeError:
                pass
        return self

    def plot(self, conf=True, line_width=None, font_size=None, labels=True, boxes=True, img=None,
             pil=False, show=False, save=False, filename=None, color_mode="class"):
        """Draw detections on (a copy of) the original image; returns BGR array."""
        if color_mode not in {"instance", "class"}:
            raise ValueError(f"bad color_mode {color_mode!r}")
        im = (img if img is not None else self.orig_img).copy()
        ann = Annotator(im, line_width=line_width, font_size=font_size, pil=pil,
                        example=str(self.names))
        if boxes:
            for i, row in enumerate(self.boxes.data):
                x1, y1, x2, y2, cf, cl = row[:6]
                c = int(cl)
                name = self.names.get(c, str(c))
                label = (f"{name} {cf:.2f}" if conf else name) if labels else None
                ann.box_label((x1, y1, x2, y2), label,
                              color=colors(c if color_mode == "class" else i, True))
        if show:
            ann.show(self.path)
        if save:
            ann.save(filename or f"results_{Path(self.path).stem}.jpg")
        return ann.result()

    def show(self, *args, **kwargs):
        """Plot and display the annotated image."""
        self.plot(*args, show=True, **kwargs)

    def save(self, filename=None):
        filename = filename or f"results_{Path(self.path).stem}.jpg"
        from yololite_tpu_torch.utils.patches import imwrite

        imwrite(str(filename), self.plot())
        return filename

    def verbose(self) -> str:
        """Per-image log string, e.g. '3 persons, 1 car, '."""
        if len(self) == 0:
            return "(no detections), "
        counts = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return "".join(f"{n} {self.names.get(c, c)}{'s' * (n > 1)}, " for c, n in sorted(counts.items()))

    def save_txt(self, txt_file, save_conf=False):
        """Save detections as 'cls cx cy w h [conf]' normalized rows."""
        lines = []
        for row in self.boxes.data:
            xywhn = xyxy2xywh(row[None, :4])[0]
            xywhn[[0, 2]] /= self.orig_shape[1]
            xywhn[[1, 3]] /= self.orig_shape[0]
            vals = (int(row[5]), *xywhn.tolist()) + ((float(row[4]),) if save_conf else ())
            lines.append(("%g " * len(vals)).rstrip() % vals)
        if lines:
            Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
            with open(txt_file, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")

    def save_crop(self, save_dir, file_name=Path("im.jpg")):
        """Save cropped detections to save_dir/<class-name>/ (gain=1.02, pad=10, clip)."""
        from yololite_tpu_torch.utils.plotting import save_one_box

        for row in self.boxes.data:
            c = int(row[5])
            save_one_box(
                row[:4],
                self.orig_img.copy(),
                file=Path(save_dir) / self.names.get(c, str(c)) / Path(file_name).with_suffix(".jpg"),
                BGR=True,
            )

    def summary(self, normalize=False, decimals=5) -> List[Dict]:
        """List-of-dicts summary (one entry per detection)."""
        out = []
        h, w = self.orig_shape
        for row in self.boxes.data:
            x1, y1, x2, y2, cf, cl = (float(v) for v in row[:6])
            if normalize:
                x1, x2, y1, y2 = x1 / w, x2 / w, y1 / h, y2 / h
            out.append(
                {
                    "name": self.names.get(int(cl), str(int(cl))),
                    "class": int(cl),
                    "confidence": round(cf, decimals),
                    "box": {"x1": round(x1, decimals), "y1": round(y1, decimals),
                            "x2": round(x2, decimals), "y2": round(y2, decimals)},
                }
            )
        return out

    def to_json(self, normalize=False, decimals=5) -> str:
        return json.dumps(self.summary(normalize, decimals), indent=2)

    def tojson(self, normalize=False, decimals=5) -> str:
        """Deprecated alias of to_json, kept for upstream API parity."""
        LOGGER.warning("'tojson' is deprecated, use 'to_json' instead.")
        return self.to_json(normalize, decimals)

    def to_df(self, normalize=False, decimals=5):
        """Summary as a pandas DataFrame (pandas is an optional dependency)."""
        import pandas as pd  # noqa: deferred

        return pd.DataFrame(self.summary(normalize, decimals))

    def to_xml(self, normalize=False, decimals=5, *args, **kwargs) -> str:
        """Detections as an XML string via pandas.DataFrame.to_xml."""
        df = self.to_df(normalize, decimals)
        if len(df) == 0:
            return '<?xml version="1.0" encoding="utf-8"?>\n<root></root>'
        return df.to_xml(*args, **kwargs)

    def to_csv(self) -> str:
        rows = self.summary()
        if not rows:
            return ""
        cols = ["name", "class", "confidence", "x1", "y1", "x2", "y2"]
        lines = [",".join(cols)]
        for r in rows:
            lines.append(
                ",".join(
                    str(v)
                    for v in (r["name"], r["class"], r["confidence"], r["box"]["x1"], r["box"]["y1"],
                              r["box"]["x2"], r["box"]["y2"])
                )
            )
        return "\n".join(lines)
