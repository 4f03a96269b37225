"""Numpy box containers used by the data pipeline (port of yololite_tpu/utils/instance.py).

Horizontal boxes with the geometry the val and train transforms use: format
conversion, (de)normalization, scaling, padding, clipping, flips, indexing
and concatenation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from yololite_tpu_torch.ops.boxes import ltwh2xyxy, xywh2xyxy, xyxy2ltwh, xyxy2xywh

_FORMATS = ("xyxy", "xywh", "ltwh")


def _python_scalars(values) -> bool:
    """All Python ints and floats: numpy casts each to the array's dtype before it operates (a NumPy scalar may
    instead widen the operation), so the four column ops are one op with an array of that dtype."""
    return all(type(v) is int or type(v) is float for v in values)


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

    def areas(self) -> np.ndarray:
        b = self.bboxes
        if self.format == "xyxy":
            return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        return b[:, 2] * b[:, 3]

    def mul(self, scale):
        """Scale coords by (sx, sy, sx2, sy2) or a scalar."""
        if not isinstance(scale, (tuple, list)):
            scale = (scale,) * 4
        if _python_scalars(scale):
            self.bboxes *= np.array(scale, dtype=self.bboxes.dtype)
            return
        for i in range(4):
            self.bboxes[:, i] *= scale[i]

    def add(self, offset):
        """Offset coords by (ox, oy, ox2, oy2) or a scalar."""
        if not isinstance(offset, (tuple, list)):
            offset = (offset,) * 4
        if _python_scalars(offset):
            self.bboxes += np.array(offset, dtype=self.bboxes.dtype)
            return
        for i in range(4):
            self.bboxes[:, i] += offset[i]

    def __len__(self):
        return len(self.bboxes)

    @classmethod
    def concatenate(cls, boxes_list: Sequence["Bboxes"], axis=0) -> "Bboxes":
        if not boxes_list:
            raise ValueError("nothing to concatenate")
        fmt = boxes_list[0].format
        for b in boxes_list:
            b.convert(fmt)
        return cls(np.concatenate([b.bboxes for b in boxes_list], axis=axis), fmt)

    def __getitem__(self, index) -> "Bboxes":
        b = self.bboxes[index]
        return Bboxes(b if b.ndim == 2 else b[None], self.format)


class Instances:
    """Boxes + normalization flag, with the geometry ops the transforms need."""

    def __init__(self, bboxes: np.ndarray, bbox_format="xywh", normalized=True):
        self._bboxes = Bboxes(np.asarray(bboxes, dtype=np.float32).reshape(-1, 4), format=bbox_format)
        self.normalized = normalized

    @property
    def bboxes(self):
        return self._bboxes.bboxes

    @property
    def bbox_areas(self):
        return self._bboxes.areas()

    def convert_bbox(self, format):
        self._bboxes.convert(format)

    def scale(self, scale_w, scale_h):
        self._bboxes.mul((scale_w, scale_h, scale_w, scale_h))

    def denormalize(self, w, h):
        if not self.normalized:
            return
        self._bboxes.mul((w, h, w, h))
        self.normalized = False

    def normalize(self, w, h):
        if self.normalized:
            return
        self._bboxes.mul((1 / w, 1 / h, 1 / w, 1 / h))
        self.normalized = True

    def add_padding(self, padw, padh):
        if self.normalized:
            raise ValueError("denormalize before adding padding")
        if self._bboxes.format == "xyxy":
            self._bboxes.add((padw, padh, padw, padh))
        else:  # xywh/ltwh: offset center/corner only
            self._bboxes.add((padw, padh, 0, 0))

    def clip(self, w, h):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self.bboxes
        np.clip(b[:, 0::2], 0, w, out=b[:, 0::2])  # in place through views: the same values as a gather, clip, scatter
        np.clip(b[:, 1::2], 0, h, out=b[:, 1::2])
        if fmt != "xyxy":
            self.convert_bbox(fmt)

    def flipud(self, h):
        if self._bboxes.format == "xyxy":
            y1 = self.bboxes[:, 1].copy()
            y2 = self.bboxes[:, 3].copy()
            self.bboxes[:, 1] = h - y2
            self.bboxes[:, 3] = h - y1
        else:
            self.bboxes[:, 1] = h - self.bboxes[:, 1]

    def fliplr(self, w):
        if self._bboxes.format == "xyxy":
            x1 = self.bboxes[:, 0].copy()
            x2 = self.bboxes[:, 2].copy()
            self.bboxes[:, 0] = w - x2
            self.bboxes[:, 2] = w - x1
        else:
            self.bboxes[:, 0] = w - self.bboxes[:, 0]

    def remove_zero_area_boxes(self) -> np.ndarray:
        """Drop boxes of zero area (after clipping); returns the keep mask."""
        good = self.bbox_areas > 0
        if not good.all():
            self._bboxes = self._bboxes[good]
        return good

    def update(self, bboxes):
        self._bboxes = Bboxes(bboxes, format=self._bboxes.format)

    def __len__(self):
        return len(self._bboxes)

    def __getitem__(self, index) -> "Instances":
        b = self.bboxes[index]
        return Instances(b if np.ndim(b) == 2 else b[None], bbox_format=self._bboxes.format,
                         normalized=self.normalized)

    @classmethod
    def concatenate(cls, instances_list: Sequence["Instances"], axis=0) -> "Instances":
        if not instances_list:
            raise ValueError("nothing to concatenate")
        norm = instances_list[0].normalized
        fmt = instances_list[0]._bboxes.format
        for ins in instances_list:
            ins.convert_bbox(fmt)
            if ins.normalized != norm:
                raise ValueError("cannot concatenate normalized and pixel boxes")
        cat = np.concatenate([ins.bboxes for ins in instances_list], axis=axis)
        return cls(cat, bbox_format=fmt, normalized=norm)
