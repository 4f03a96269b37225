"""Val transforms (port of the val part of yololite_tpu/data/augment.py).

Compose, the label-aware LetterBox and Format. Images stay uint8 HWC on the
host; the validator divides by 255 on the device. The train augmentations
(Mosaic, MixUp, CopyPaste, RandomPerspective, HSV, flips, Albumentations,
v8_transforms) are not ported yet (ROADMAP.md, Queue 1, item 6).
"""

from __future__ import annotations

import numpy as np

from yololite_tpu_torch.ops.letterbox import LetterBox as _ImgLetterBox


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, labels):
        for t in self.transforms:
            labels = t(labels)
        return labels


class LetterBox:
    """Label-aware letterbox wrapping the image-only `ops.letterbox.LetterBox`."""

    def __init__(self, new_shape=(640, 640), auto=False, scale_fill=False, scaleup=True, center=True, stride=32):
        self.lb = _ImgLetterBox(new_shape, auto=auto, scale_fill=scale_fill, scaleup=scaleup, center=center,
                                stride=stride)
        self.new_shape = self.lb.new_shape
        self.center = center

    def __call__(self, labels=None, image=None):
        import cv2

        if labels is None:
            labels = {}
        img = labels.get("img") if image is None else image
        shape = img.shape[:2]
        new_shape = labels.pop("rect_shape", self.new_shape)
        if isinstance(new_shape, int):
            new_shape = (new_shape, new_shape)
        r, new_unpad, (dw, dh) = self.lb.params(shape, tuple(new_shape))
        ratio = (r, r) if r is not None else (new_shape[1] / shape[1], new_shape[0] / shape[0])
        if shape[::-1] != new_unpad:
            img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
        top = int(round(dh - 0.1)) if self.center else 0
        bottom = int(round(dh + 0.1))
        left = int(round(dw - 0.1)) if self.center else 0
        right = int(round(dw + 0.1))
        img = cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=(114, 114, 114))
        if labels.get("ratio_pad"):
            labels["ratio_pad"] = (labels["ratio_pad"], (left, top))
        if len(labels):
            labels["instances"].convert_bbox(format="xyxy")
            labels["instances"].denormalize(*shape[::-1])
            labels["instances"].scale(*ratio)
            labels["instances"].add_padding(left, top)
            labels["img"] = img
            labels["resized_shape"] = tuple(new_shape)
            return labels
        return img


class Format:
    """Final packaging: HWC BGR uint8 -> RGB uint8 NHWC-ready image, normalized xywh boxes.

    The image stays uint8, so the upload moves one byte a pixel; the /255
    runs on the device.
    """

    def __init__(self, bbox_format="xywh", normalize=True, batch_idx=True):
        self.bbox_format, self.normalize, self.batch_idx = bbox_format, normalize, batch_idx

    def __call__(self, labels):
        img, cls, instances = (labels.pop(k) for k in ("img", "cls", "instances"))
        h, w = img.shape[:2]
        instances.convert_bbox(format=self.bbox_format)
        instances.denormalize(w, h)
        nl = len(instances)

        labels["img"] = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
        labels["cls"] = np.asarray(cls, np.float32).reshape(nl, -1)[:, :1] if nl else np.zeros((0, 1), np.float32)
        bboxes = instances.bboxes.astype(np.float32) if nl else np.zeros((0, 4), np.float32)
        if self.normalize and nl:
            bboxes = bboxes.copy()
            bboxes[:, [0, 2]] /= w
            bboxes[:, [1, 3]] /= h
        labels["bboxes"] = bboxes
        if self.batch_idx:
            labels["batch_idx"] = np.zeros(nl, np.float32)
        return labels
