"""Letterbox preprocessing (port of yololite_tpu/ops/letterbox.py).

`LetterBox` / `preprocess_batch` are the host path for batches of mixed
shapes (cv2, imported when first used). Same-shape batches take
`ops.kernels.device_letterbox` instead. `scale_img` rescales a batch on its
device for test-time augmentation.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class LetterBox:
    """Resize + pad an HWC uint8 image to new_shape preserving aspect ratio."""

    def __init__(self, new_shape=(640, 640), auto=False, scale_fill=False, scaleup=True, center=True, stride=32):
        self.new_shape = (new_shape, new_shape) if isinstance(new_shape, int) else tuple(new_shape)
        self.auto = auto
        self.scale_fill = scale_fill
        self.scaleup = scaleup
        self.center = center
        self.stride = stride

    def params(self, shape: Tuple[int, int], new_shape: Optional[Tuple[int, int]] = None):
        """Compute (ratio, new_unpad(w,h), (dw, dh)) for an input (h, w)."""
        new_shape = new_shape or self.new_shape
        r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
        if not self.scaleup:
            r = min(r, 1.0)
        new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
        dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
        if self.auto:
            dw, dh = dw % self.stride, dh % self.stride
        elif self.scale_fill:
            dw, dh = 0.0, 0.0
            new_unpad = (new_shape[1], new_shape[0])
            r = None  # anisotropic
        if self.center:
            dw /= 2
            dh /= 2
        return r, new_unpad, (dw, dh)

    def __call__(self, image: np.ndarray, new_shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
        import cv2

        shape = image.shape[:2]
        new_shape = new_shape or self.new_shape
        r, new_unpad, (dw, dh) = self.params(shape, new_shape)
        if shape[::-1] != new_unpad:
            image = cv2.resize(image, new_unpad, interpolation=cv2.INTER_LINEAR)
        top = int(round(dh - 0.1)) if self.center else 0
        bottom = int(round(dh + 0.1))
        left = int(round(dw - 0.1)) if self.center else 0
        right = int(round(dw + 0.1))
        return cv2.copyMakeBorder(image, top, bottom, left, right, cv2.BORDER_CONSTANT, value=(114, 114, 114))


def preprocess_batch(images, imgsz: int = 640, stride: int = 32, auto: bool = False) -> np.ndarray:
    """Letterbox a list of HWC BGR uint8 images and stack to (B, S, S, 3) RGB float32 in [0, 1]."""
    same = len({im.shape for im in images}) == 1
    lb = LetterBox((imgsz, imgsz), auto=auto and same, stride=stride)
    out = np.stack([lb(im) for im in images])
    out = out[..., ::-1]  # BGR -> RGB
    return np.ascontiguousarray(out, dtype=np.float32) / 255.0


def scale_img(img: torch.Tensor, ratio: float = 1.0, same_shape: bool = False, gs: int = 32) -> torch.Tensor:
    """Scale an NHWC batch by `ratio` for TTA (bilinear, antialiased like jax.image.resize).

    Unless same_shape, pads out to the next gs-multiple of the ORIGINAL size
    with the ImageNet-mean fill 0.447.
    """
    if ratio == 1.0:
        return img
    b, h, w, c = img.shape
    hs, ws = int(h * ratio), int(w * ratio)
    x = img.permute(0, 3, 1, 2)
    out = F.interpolate(x.float(), size=(hs, ws), mode="bilinear", align_corners=False, antialias=True).to(img.dtype)
    if not same_shape:
        h, w = (math.ceil(v * ratio / gs) * gs for v in (h, w))
    out = F.pad(out, (0, w - ws, 0, h - hs), value=0.447)
    return out.permute(0, 2, 3, 1)
