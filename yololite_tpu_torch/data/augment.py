"""Val and train transforms on the host (port of yololite_tpu/data/augment.py).

Compose, Mosaic (3/4/9 tiles), MixUp, CopyPaste (flip mode),
RandomPerspective, RandomHSV, RandomFlip, the label-aware LetterBox,
Albumentations (a no-op without the package), Format and `v8_transforms`.
Images stay uint8 HWC on the host; the /255 runs on the device.

The JAX package's transforms draw from the process-wide `random` and
`np.random`. Here each draws from the generators it is given, a
`random.Random` and an `np.random.RandomState`, in the same order: seeded
alike, the two packages make the same images. The dataset owns one pair and
hands it to all its transforms.

Every draw depends on image shapes, labels and the order of loads, never on
a pixel. So each transform works in two halves. Called on labels whose
"img" is a `PlannedImage` (the dataset's loads are), it takes its draws,
does all its label work and returns a `PlannedImage` that records its pixel
work: the plan, which must run in load order on one thread. `build()` then
does the pixel work with the same cv2 and numpy calls: the apply, which any
thread may run. Called on an ndarray, a transform does both at once.
"""

from __future__ import annotations

import math
import random
import time
from copy import deepcopy
from functools import partial

import numpy as np

from yololite_tpu_torch.ops.boxes import bbox_ioa
from yololite_tpu_torch.ops.letterbox import LetterBox as _ImgLetterBox
from yololite_tpu_torch.utils import LOGGER
from yololite_tpu_torch.utils.instance import Instances


class PlannedImage:
    """An image whose shape the plan knows and whose pixels `build()` makes later.

    `fn(*sources)` makes the pixels from the sources' (planned images or
    arrays); `stage` names the apply's stage the work belongs to. The leaves
    are the dataset's loads. Each node is built once, by one thread, and its
    output goes to its one parent, which may write into it.
    """

    __slots__ = ("shape", "stage", "fn", "srcs")
    dtype = np.dtype(np.uint8)

    def __init__(self, shape, stage: str, fn, srcs=()):
        self.shape, self.stage, self.fn, self.srcs = tuple(shape), stage, fn, srcs

    def build(self, times=None) -> np.ndarray:
        """The pixels; with a dict `times`, each stage's seconds (its sources' excluded) are added to it."""
        args = [s.build(times) if isinstance(s, PlannedImage) else s for s in self.srcs]
        t0 = time.perf_counter() if times is not None else 0.0
        out = self.fn(*args)
        if times is not None:
            times[self.stage] = times.get(self.stage, 0.0) + time.perf_counter() - t0
        if out.shape != self.shape:
            raise RuntimeError(f"{self.stage} made an image of shape {out.shape}, its plan {self.shape}")
        return out

    def leaves(self) -> list:
        """The planned images without planned sources (the loads), depth first."""
        planned = [s for s in self.srcs if isinstance(s, PlannedImage)]
        return [self] if not planned else [x for s in planned for x in s.leaves()]


def _pixels(stage: str, shape, fn, *srcs):
    """fn(*srcs) now when no source is planned, else a PlannedImage of `shape` that calls it at build time."""
    if any(isinstance(s, PlannedImage) for s in srcs):
        return PlannedImage(shape, stage, fn, srcs)
    return fn(*srcs)


def _mosaic_pixels(side, channels, windows, crop, *tiles):
    canvas = np.full((side, side, channels), 114, dtype=np.uint8)
    for (dst, src), tile in zip(windows, tiles):
        canvas[dst] = tile[src]
    return canvas[crop] if crop else canvas


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, labels):
        for t in self.transforms:
            labels = t(labels)
        return labels

    def append(self, t):
        self.transforms.append(t)

    def insert(self, i, t):
        self.transforms.insert(i, t)


class BaseMixTransform:
    """Base of the transforms that mix several dataset images (mosaic, mixup)."""

    def __init__(self, dataset, rng: random.Random, pre_transform=None, p=0.0):
        self.dataset, self.rng, self.pre_transform, self.p = dataset, rng, pre_transform, p

    def __call__(self, labels):
        if self.rng.uniform(0, 1) > self.p:
            return labels
        idx = self.get_indexes()
        extra = [self.dataset.get_image_and_label(i) for i in ([idx] if isinstance(idx, int) else idx)]
        if self.pre_transform is not None:
            extra = [self.pre_transform(d) for d in extra]
        labels["mix_labels"] = extra
        labels = self._mix_transform(labels)
        labels.pop("mix_labels", None)
        return labels

    def get_indexes(self):
        return self.rng.randint(0, len(self.dataset) - 1)

    def _mix_transform(self, labels):
        raise NotImplementedError


class Mosaic(BaseMixTransform):
    """3-, 4- or 9-image mosaic on a 2 x imgsz canvas (3: a 1 x 3 strip, 9: a spiral, both cropped to 2 x imgsz)."""

    def __init__(self, dataset, rng: random.Random, imgsz=640, p=1.0, n=4):
        if n not in (3, 4, 9):
            raise ValueError(f"mosaic takes 3, 4 or 9 images, got {n}")
        super().__init__(dataset=dataset, rng=rng, p=p)
        self.imgsz = imgsz
        self.border = (-imgsz // 2, -imgsz // 2)
        self.n = n

    def get_indexes(self):
        """Companion tiles from the dataset's rolling buffer of recently loaded images, with replacement."""
        buf = getattr(self.dataset, "buffer", None)
        if buf:
            return self.rng.choices(list(buf), k=self.n - 1)
        return [self.rng.randint(0, len(self.dataset) - 1) for _ in range(self.n - 1)]

    def _mix_transform(self, labels):
        if labels.get("rect_shape") is not None:
            raise ValueError("rect and mosaic are mutually exclusive")
        if self.n == 3:
            return self._mosaic3(labels)
        return self._mosaic4(labels) if self.n == 4 else self._mosaic9(labels)

    def _mosaic3(self, labels):
        """1 x 3 horizontal strip on a 3s canvas (centre, right, left bottom-aligned), cropped to 2s."""
        mosaic_labels, windows, tiles = [], [], []
        s = self.imgsz
        h0 = w0 = 0
        for i in range(3):
            patch = labels if i == 0 else labels["mix_labels"][i - 1]
            h, w = patch.pop("resized_shape")
            if i == 0:
                h0, w0 = h, w
                box = s, s, s + w, s + h
            elif i == 1:
                box = s + w0, s, s + w0 + w, s + h
            else:
                box = s - w, s + h0 - h, s, s + h0
            padw, padh = box[:2]
            x1, y1, x2, y2 = (max(v, 0) for v in box)
            windows.append(((slice(y1, y2), slice(x1, x2)), (slice(y1 - padh, None), slice(x1 - padw, None))))
            tiles.append(patch["img"])
            mosaic_labels.append(self._update_labels(patch, padw + self.border[0], padh + self.border[1]))
        return self._canvas(self._cat_labels(mosaic_labels), s * 3, windows, tiles, crop=True)

    def _mosaic4(self, labels):
        mosaic_labels, windows, tiles = [], [], []
        s = self.imgsz
        yc, xc = (int(self.rng.uniform(-x, 2 * s + x)) for x in self.border)
        for i in range(4):
            patch = labels if i == 0 else labels["mix_labels"][i - 1]
            h, w = patch.pop("resized_shape")
            # canvas window (c*) at the shared centre (xc, yc); source window (s*) is what of the tile fits
            if i == 0:  # top-left
                cx1, cy1, cx2, cy2 = max(xc - w, 0), max(yc - h, 0), xc, yc
                sx1, sy1, sx2, sy2 = w - (cx2 - cx1), h - (cy2 - cy1), w, h
            elif i == 1:  # top-right
                cx1, cy1, cx2, cy2 = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                sx1, sy1, sx2, sy2 = 0, h - (cy2 - cy1), min(w, cx2 - cx1), h
            elif i == 2:  # bottom-left
                cx1, cy1, cx2, cy2 = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                sx1, sy1, sx2, sy2 = w - (cx2 - cx1), 0, w, min(cy2 - cy1, h)
            else:  # bottom-right
                cx1, cy1, cx2, cy2 = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                sx1, sy1, sx2, sy2 = 0, 0, min(w, cx2 - cx1), min(cy2 - cy1, h)
            windows.append(((slice(cy1, cy2), slice(cx1, cx2)), (slice(sy1, sy2), slice(sx1, sx2))))
            tiles.append(patch["img"])
            mosaic_labels.append(self._update_labels(patch, cx1 - sx1, cy1 - sy1))
        return self._canvas(self._cat_labels(mosaic_labels), s * 2, windows, tiles, crop=False)

    def _mosaic9(self, labels):
        mosaic_labels, windows, tiles = [], [], []
        s = self.imgsz
        hp, wp = -1, -1
        for i in range(9):
            patch = labels if i == 0 else labels["mix_labels"][i - 1]
            h, w = patch.pop("resized_shape")
            # spiral placement on the 3s canvas; h0/w0 the first tile, hp/wp the previous one
            if i == 0:
                h0, w0 = h, w
                box = s, s, s + w, s + h
            elif i == 1:
                box = s, s - h, s + w, s
            elif i == 2:
                box = s + wp, s - h, s + wp + w, s
            elif i == 3:
                box = s + w0, s, s + w0 + w, s + h
            elif i == 4:
                box = s + w0, s + hp, s + w0 + w, s + hp + h
            elif i == 5:
                box = s + w0 - w, s + h0, s + w0, s + h0 + h
            elif i == 6:
                box = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
            elif i == 7:
                box = s - w, s + h0 - h, s, s + h0
            else:
                box = s - w, s + h0 - hp - h, s, s + h0 - hp
            padw, padh = box[:2]
            x1, y1, x2, y2 = (max(v, 0) for v in box)
            windows.append(((slice(y1, y2), slice(x1, x2)), (slice(y1 - padh, None), slice(x1 - padw, None))))
            tiles.append(patch["img"])
            hp, wp = h, w
            # labels live in the 2s centre crop, so the (negative) border shifts into the pad offsets
            mosaic_labels.append(self._update_labels(patch, padw + self.border[0], padh + self.border[1]))
        return self._canvas(self._cat_labels(mosaic_labels), s * 3, windows, tiles, crop=True)

    def _canvas(self, final, side: int, windows, tiles, crop: bool):
        """The mosaic's image: a side x side canvas of 114 with each tile's window copied in, cropped by the border
        (3 and 9 tiles)."""
        crop = (slice(-self.border[0], self.border[0]), slice(-self.border[1], self.border[1])) if crop else None
        channels = tiles[0].shape[2]
        hw = (len(range(side)[crop[0]]), len(range(side)[crop[1]])) if crop else (side, side)
        final["img"] = _pixels("mosaic", (*hw, channels), partial(_mosaic_pixels, side, channels, windows, crop),
                               *tiles)
        return final

    @staticmethod
    def _update_labels(labels, padw, padh):
        nh, nw = labels["img"].shape[:2]
        labels["instances"].convert_bbox(format="xyxy")
        labels["instances"].denormalize(nw, nh)
        labels["instances"].add_padding(padw, padh)
        return labels

    def _cat_labels(self, mosaic_labels):
        if not mosaic_labels:
            return {}
        imgsz = self.imgsz * 2
        cls = np.concatenate([lb["cls"] for lb in mosaic_labels], 0)
        instances = Instances.concatenate([lb["instances"] for lb in mosaic_labels], axis=0)
        instances.clip(imgsz, imgsz)
        good = instances.remove_zero_area_boxes()
        return {
            "im_file": mosaic_labels[0]["im_file"],
            "ori_shape": mosaic_labels[0]["ori_shape"],
            "resized_shape": (imgsz, imgsz),
            "cls": cls[good],
            "instances": instances,
            "mosaic_border": self.border,
        }


class MixUp(BaseMixTransform):
    """Blend with a second image at a Beta(32, 32) ratio."""

    def __init__(self, dataset, rng: random.Random, np_rng: np.random.RandomState, pre_transform=None, p=0.0):
        super().__init__(dataset, rng, pre_transform=pre_transform, p=p)
        self.np_rng = np_rng

    def _mix_transform(self, labels):
        r = self.np_rng.beta(32.0, 32.0)
        labels2 = labels["mix_labels"][0]
        img = labels["img"]
        labels["img"] = _pixels("mixup", img.shape, partial(_mixup_pixels, r), img, labels2["img"])
        labels["instances"] = Instances.concatenate([labels["instances"], labels2["instances"]], axis=0)
        labels["cls"] = np.concatenate([labels["cls"], labels2["cls"]], 0)
        return labels


def _mixup_pixels(r, im1, im2):
    return (im1 * r + im2 * (1 - r)).astype(np.uint8)


class CopyPaste:
    """Flip-mode copy-paste: mirror the instances and paste back those that overlap no existing box much."""

    def __init__(self, rng: random.Random, p=0.5):
        self.rng, self.p = rng, p

    def __call__(self, labels):
        if self.p == 0 or len(labels["instances"]) == 0:
            return labels
        im = labels["img"]
        cls = labels["cls"]
        h, w = im.shape[:2]
        instances = labels.pop("instances")
        instances.convert_bbox(format="xyxy")
        instances.denormalize(w, h)
        ins_flip = deepcopy(instances)
        ins_flip.fliplr(w)
        ioa = bbox_ioa(ins_flip.bboxes, instances.bboxes)  # intersection over the existing box's area
        idx = np.nonzero((ioa < 0.30).all(1))[0]
        n = len(idx)
        sel = self.rng.sample(list(idx), k=round(self.p * n)) if n else []
        if sel:
            cls = np.concatenate((cls, cls[sel]), axis=0)
            instances = Instances.concatenate((instances, ins_flip[sel]), axis=0)
            rects = [tuple(ins_flip.bboxes[j].astype(int)) for j in sel]
            # a load's pixels are the dataset's shared copy (mosaic skipped): paste into a copy of them
            shared = isinstance(im, PlannedImage) and not im.srcs
            im = _pixels("copy_paste", im.shape, partial(_copy_paste_pixels, rects, shared), im)
        labels["img"] = im
        labels["cls"] = cls
        labels["instances"] = instances
        return labels


def _copy_paste_pixels(rects, copy, im):
    """Paste the mirrored image back inside the mirrored boxes' rectangles (x1, y1, x2, y2), in place (into a copy
    with `copy`)."""
    import cv2

    if copy:
        im = im.copy()
    im_new = np.zeros(im.shape, np.uint8)
    for x1, y1, x2, y2 in rects:
        cv2.rectangle(im_new, (x1, y1), (x2, y2), (1, 1, 1), cv2.FILLED)
    result = cv2.flip(im, 1)
    np.copyto(im, result, where=cv2.flip(im_new, 1).astype(bool))  # im[mask] = result[mask], without the gathers
    return im


class RandomPerspective:
    """Affine warp (translate, scale, rotate, shear, perspective) with box transform and candidate filtering."""

    def __init__(self, rng: random.Random, degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
                 border=(0, 0), pre_transform=None):
        self.rng = rng
        self.degrees, self.translate, self.scale = degrees, translate, scale
        self.shear, self.perspective = shear, perspective
        self.border, self.pre_transform = border, pre_transform

    def affine_transform(self, img, border, size):
        """M = T @ S @ R @ P @ C, drawn in the order perspective, angle, scale, shear x2, translate x2."""
        import cv2

        u = self.rng.uniform
        eye3 = lambda: np.eye(3, dtype=np.float32)
        C = eye3()  # centre to origin
        C[:2, 2] = -img.shape[1] / 2, -img.shape[0] / 2
        P = eye3()  # perspective
        P[2, :2] = u(-self.perspective, self.perspective), u(-self.perspective, self.perspective)
        R = eye3()  # rotation and scale
        a, s = u(-self.degrees, self.degrees), u(1 - self.scale, 1 + self.scale)
        R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
        S = eye3()  # shear, degrees -> tangent
        S[0, 1], S[1, 0] = (math.tan(u(-self.shear, self.shear) * math.pi / 180) for _ in range(2))
        T = eye3()  # translation, in output-canvas units
        T[:2, 2] = [u(0.5 - self.translate, 0.5 + self.translate) * d for d in size]
        M = T @ S @ R @ P @ C
        if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
            img = _pixels("warp", (size[1], size[0], *img.shape[2:]),
                          partial(_warp_pixels, M, tuple(size), bool(self.perspective)), img)
        return img, M, s

    def apply_bboxes(self, bboxes, M):
        n = len(bboxes)
        if n == 0:
            return bboxes
        xy = np.ones((n * 4, 3), dtype=bboxes.dtype)
        xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if self.perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        return np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1)), dtype=bboxes.dtype).reshape(4, n).T

    def __call__(self, labels):
        if self.pre_transform and "mosaic_border" not in labels:
            labels = self.pre_transform(labels)
        labels.pop("ratio_pad", None)
        img = labels["img"]
        cls = labels["cls"]
        instances = labels.pop("instances")
        instances.convert_bbox(format="xyxy")
        instances.denormalize(*img.shape[:2][::-1])

        border = labels.pop("mosaic_border", self.border)
        size = img.shape[1] + border[1] * 2, img.shape[0] + border[0] * 2
        img, M, scale = self.affine_transform(img, border, size)
        bboxes = self.apply_bboxes(instances.bboxes, M)
        new_instances = Instances(bboxes, bbox_format="xyxy", normalized=False)
        new_instances.clip(*size)

        instances.scale(scale_w=scale, scale_h=scale)
        i = self.box_candidates(box1=instances.bboxes.T, box2=new_instances.bboxes.T, area_thr=0.10)
        labels["instances"] = new_instances[i]
        labels["cls"] = cls[i]
        labels["img"] = img
        labels["resized_shape"] = img.shape[:2]
        return labels

    @staticmethod
    def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
        w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
        w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
        ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
        return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _warp_pixels(M, size, perspective, img):
    import cv2

    warp = cv2.warpPerspective if perspective else cv2.warpAffine
    return warp(img, M if perspective else M[:2], dsize=size, borderValue=(114, 114, 114))


class RandomHSV:
    """Hue, saturation and value jitter through lookup tables, in place."""

    def __init__(self, np_rng: np.random.RandomState, hgain=0.5, sgain=0.5, vgain=0.5):
        self.np_rng = np_rng
        self.hgain, self.sgain, self.vgain = hgain, sgain, vgain

    def __call__(self, labels):
        if self.hgain or self.sgain or self.vgain:
            r = self.np_rng.uniform(-1, 1, 3) * [self.hgain, self.sgain, self.vgain] + 1
            img = labels["img"]
            labels["img"] = _pixels("hsv", img.shape, partial(_hsv_pixels, r), img)
        return labels


def _hsv_pixels(r, img):
    """BGR -> HSV, each channel through its table of gain r, -> BGR into img."""
    import cv2

    dtype = img.dtype
    x = np.arange(0, 256, dtype=r.dtype)
    lut = np.stack((((x * r[0]) % 180).astype(dtype),  # hue wraps at 180
                    np.clip(x * r[1], 0, 255).astype(dtype),
                    np.clip(x * r[2], 0, 255).astype(dtype)), -1)[:, None]  # (256, 1, 3): a table a channel
    cv2.cvtColor(cv2.LUT(cv2.cvtColor(img, cv2.COLOR_BGR2HSV), lut), cv2.COLOR_HSV2BGR, dst=img)
    return img


class RandomFlip:
    """Horizontal or vertical flip with the boxes."""

    def __init__(self, rng: random.Random, p=0.5, direction="horizontal"):
        if direction not in ("horizontal", "vertical"):
            raise ValueError(f"direction must be 'horizontal' or 'vertical', got {direction!r}")
        self.rng, self.p, self.direction = rng, p, direction

    def __call__(self, labels):
        img = labels["img"]
        instances = labels.pop("instances")
        instances.convert_bbox(format="xywh")
        h, w = (1, 1) if instances.normalized else img.shape[:2]
        flip = None  # cv2.flip's code: 0 about the x axis (np.flipud), 1 about the y axis (np.fliplr)
        if self.direction == "vertical" and self.rng.random() < self.p:
            flip = 0
            instances.flipud(h)
        if self.direction == "horizontal" and self.rng.random() < self.p:
            flip = 1
            instances.fliplr(w)
        labels["img"] = _pixels("flips", img.shape, partial(_flip_pixels, flip), img)
        labels["instances"] = instances
        return labels


def _flip_pixels(flip, img):
    """np.flipud / np.fliplr made contiguous, by cv2 (numpy's copy of a view reversed over pixels of 3 bytes is some
    10x slower)."""
    import cv2

    return cv2.flip(img, flip) if flip is not None else np.ascontiguousarray(img)


class LetterBox:
    """Label-aware letterbox wrapping the image-only `ops.letterbox.LetterBox`."""

    def __init__(self, new_shape=(640, 640), auto=False, scale_fill=False, scaleup=True, center=True, stride=32):
        self.lb = _ImgLetterBox(new_shape, auto=auto, scale_fill=scale_fill, scaleup=scaleup, center=center,
                                stride=stride)
        self.new_shape = self.lb.new_shape
        self.center = center

    def __call__(self, labels=None, image=None):
        if labels is None:
            labels = {}
        img = labels.get("img") if image is None else image
        shape = img.shape[:2]
        new_shape = labels.pop("rect_shape", self.new_shape)
        if isinstance(new_shape, int):
            new_shape = (new_shape, new_shape)
        r, new_unpad, (dw, dh) = self.lb.params(shape, tuple(new_shape))
        ratio = (r, r) if r is not None else (new_shape[1] / shape[1], new_shape[0] / shape[0])
        top = int(round(dh - 0.1)) if self.center else 0
        bottom = int(round(dh + 0.1))
        left = int(round(dw - 0.1)) if self.center else 0
        right = int(round(dw + 0.1))
        pads = (top, bottom, left, right)
        resize = new_unpad if shape[::-1] != new_unpad else None
        img = _pixels("letterbox", (new_unpad[1] + top + bottom, new_unpad[0] + left + right, *img.shape[2:]),
                      partial(_letterbox_pixels, resize, pads), img)
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


def _letterbox_pixels(resize, pads, img):
    import cv2

    if resize is not None:
        img = cv2.resize(img, resize, interpolation=cv2.INTER_LINEAR)
    top, bottom, left, right = pads
    return cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=(114, 114, 114))


class Format:
    """Final packaging: HWC BGR uint8 -> RGB uint8 NHWC-ready image, normalized xywh boxes.

    The image stays uint8, so the upload moves one byte a pixel; the /255
    runs on the device. With bgr > 0 (train), an image keeps BGR order with
    that probability.
    """

    def __init__(self, bbox_format="xywh", normalize=True, batch_idx=True, bgr=0.0, rng: random.Random = None):
        self.bbox_format, self.normalize, self.batch_idx = bbox_format, normalize, batch_idx
        self.bgr, self.rng = bgr, rng

    def __call__(self, labels):
        img, cls, instances = (labels.pop(k) for k in ("img", "cls", "instances"))
        h, w = img.shape[:2]
        instances.convert_bbox(format=self.bbox_format)
        instances.denormalize(w, h)
        nl = len(instances)

        keep_bgr = self.bgr and self.rng.random() < self.bgr
        labels["img"] = _pixels("format", img.shape, partial(_format_pixels, bool(keep_bgr)), img)  # BGR -> RGB
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


def _format_pixels(keep_bgr, img):
    """img[..., ::-1] made contiguous, by cv2 (numpy's copy of the reversed channel axis is some 100x slower)."""
    import cv2

    return np.ascontiguousarray(img) if keep_bgr else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Albumentations:
    """Optional albumentations recipe (Blur, MedianBlur, ToGray, CLAHE at p = 0.01); a no-op without the package.

    The recipe is pixel-level only, so the boxes never change here. Its own
    draws come from albumentations' generators at apply time, so with the
    package installed the images repeat only where one thread builds them.
    """

    def __init__(self, rng: random.Random, p=1.0):
        self.rng, self.p = rng, p
        self.transform = None
        try:
            import albumentations as A
        except ImportError:
            return  # optional dependency absent: no-op
        try:
            recipe = [t(p=0.01) for t in (A.Blur, A.MedianBlur, A.ToGray, A.CLAHE)]
            recipe += [A.RandomBrightnessContrast(p=0.0), A.RandomGamma(p=0.0),
                       A.ImageCompression(quality_lower=75, p=0.0)]
            self.transform = A.Compose(recipe)
            LOGGER.info("albumentations: " + ", ".join(str(t) for t in recipe if t.p))
        except Exception as e:  # an albumentations version whose API differs: stay a no-op, say why
            LOGGER.info(f"albumentations: {e}")

    def __call__(self, labels):
        if self.transform is not None and self.rng.random() <= self.p:
            img = labels["img"]
            labels["img"] = _pixels("albumentations", img.shape, partial(_albumentations_pixels, self.transform),
                                    img)
        return labels


def _albumentations_pixels(transform, img):
    return transform(image=img)["image"]


def v8_transforms(dataset, imgsz, hyp, rng: random.Random, np_rng: np.random.RandomState):
    """The YOLO train pipeline: mosaic, copy-paste, perspective, mixup, albumentations, HSV and flips."""
    mosaic = Mosaic(dataset, rng, imgsz=imgsz, p=hyp.mosaic)
    affine = RandomPerspective(
        rng, degrees=hyp.degrees, translate=hyp.translate, scale=hyp.scale, shear=hyp.shear,
        perspective=hyp.perspective, pre_transform=LetterBox(new_shape=(imgsz, imgsz)),
    )
    pre_transform = Compose([mosaic, affine])
    if hyp.copy_paste_mode == "flip":
        pre_transform.insert(1, CopyPaste(rng, p=hyp.copy_paste))
    return Compose([
        pre_transform,
        MixUp(dataset, rng, np_rng, pre_transform=pre_transform, p=hyp.mixup),
        Albumentations(rng, p=1.0),
        RandomHSV(np_rng, hgain=hyp.hsv_h, sgain=hyp.hsv_s, vgain=hyp.hsv_v),
        RandomFlip(rng, direction="vertical", p=hyp.flipud),
        RandomFlip(rng, direction="horizontal", p=hyp.fliplr),
    ])
