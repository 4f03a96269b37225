"""Numpy box containers used by the data pipeline (port of yololite_tpu/utils/instance.py).

The part the val transforms use: horizontal boxes, format conversion,
(de)normalization, scaling and padding. Clipping, flips, indexing and
concatenation come with the train augmentations (ROADMAP.md, Queue 1, item 6).
"""

from __future__ import annotations

import numpy as np

from yololite_tpu_torch.ops.boxes import ltwh2xyxy, xywh2xyxy, xyxy2ltwh, xyxy2xywh

_FORMATS = ("xyxy", "xywh", "ltwh")


class Bboxes:
    """A set of boxes in one of xyxy / xywh / ltwh formats."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        if format not in _FORMATS:
            raise ValueError(f"format must be one of {_FORMATS}, got {format!r}")
        bboxes = bboxes[None, :] if bboxes.ndim == 1 else bboxes
        if bboxes.ndim != 2 or bboxes.shape[1] != 4:
            raise ValueError(f"boxes must be (N, 4), got {bboxes.shape}")
        self.bboxes = bboxes
        self.format = format

    def convert(self, format: str):
        if format not in _FORMATS:
            raise ValueError(f"format must be one of {_FORMATS}, got {format!r}")
        if self.format == format:
            return
        if self.format == "xyxy":
            func = xyxy2xywh if format == "xywh" else xyxy2ltwh
        elif self.format == "xywh":
            func = xywh2xyxy if format == "xyxy" else lambda b: xyxy2ltwh(xywh2xyxy(b))
        else:
            func = ltwh2xyxy if format == "xyxy" else lambda b: xyxy2xywh(ltwh2xyxy(b))
        self.bboxes = func(self.bboxes)
        self.format = format

    def mul(self, scale):
        """Scale coords by (sx, sy, sx2, sy2) or a scalar."""
        if not isinstance(scale, (tuple, list)):
            scale = (scale,) * 4
        for i in range(4):
            self.bboxes[:, i] *= scale[i]

    def add(self, offset):
        """Offset coords by (ox, oy, ox2, oy2) or a scalar."""
        if not isinstance(offset, (tuple, list)):
            offset = (offset,) * 4
        for i in range(4):
            self.bboxes[:, i] += offset[i]

    def __len__(self):
        return len(self.bboxes)


class Instances:
    """Boxes + normalization flag, with the geometry ops the val transforms need."""

    def __init__(self, bboxes: np.ndarray, bbox_format="xywh", normalized=True):
        self._bboxes = Bboxes(np.asarray(bboxes, dtype=np.float32).reshape(-1, 4), format=bbox_format)
        self.normalized = normalized

    @property
    def bboxes(self):
        return self._bboxes.bboxes

    def convert_bbox(self, format):
        self._bboxes.convert(format)

    def scale(self, scale_w, scale_h):
        self._bboxes.mul((scale_w, scale_h, scale_w, scale_h))

    def denormalize(self, w, h):
        if not self.normalized:
            return
        self._bboxes.mul((w, h, w, h))
        self.normalized = False

    def add_padding(self, padw, padh):
        if self.normalized:
            raise ValueError("denormalize before adding padding")
        if self._bboxes.format == "xyxy":
            self._bboxes.add((padw, padh, padw, padh))
        else:  # xywh/ltwh: offset center/corner only
            self._bboxes.add((padw, padh, 0, 0))

    def __len__(self):
        return len(self._bboxes)
