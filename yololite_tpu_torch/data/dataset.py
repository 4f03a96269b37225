"""YOLO detection dataset and host dataloader (port of yololite_tpu/data/dataset.py).

File globbing, the label cache (the JAX package's format and version, so
either package reads the other's `labels.cache.npy`), rect batching, image
loading, the train transforms with their rolling image buffer, and collate,
with a thread-pool loader that keeps two batches in flight. Batches are numpy
dicts; images stay uint8 NHWC RGB.

With augment=True the dataset owns one `random.Random` and one
`np.random.RandomState`, seeded with `seed`, from which all its transforms
draw (the JAX package draws from the process-wide `random` and `np.random`).
"""

from __future__ import annotations

import glob
import math
import os
import pickle
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch.data.augment import Compose, Format, LetterBox, v8_transforms
from yololite_tpu_torch.data.utils import (
    IMG_FORMATS,
    get_hash,
    img2label_paths,
    load_dataset_cache_file,
    save_dataset_cache_file,
    verify_image_label,
)
from yololite_tpu_torch.utils import LOGGER
from yololite_tpu_torch.utils.instance import Instances
from yololite_tpu_torch.utils.patches import imread

DATASET_CACHE_VERSION = "tpu-1.0"  # shared with the JAX package


class YOLODataset:
    """Map-style detection dataset over YOLO-txt labels."""

    def __init__(
        self,
        img_path,
        imgsz: int = 640,
        batch_size: int = 16,
        augment: bool = False,
        hyp=None,
        rect: bool = False,
        cache: bool = False,
        single_cls: bool = False,
        classes: Optional[List[int]] = None,
        fraction: float = 1.0,
        data: Optional[Dict] = None,
        pad: float = 0.5,
        stride: int = 32,
        seed: int = 0,
    ):
        if augment and hyp is None:
            raise ValueError("augment=True needs the hyperparameters (hyp) of the train transforms")
        self.img_path = img_path
        self.imgsz = imgsz
        self.batch_size = batch_size
        self.augment = augment
        self.rect = rect
        self.single_cls = single_cls
        self.data = data or {}
        self.pad = pad
        self.stride = stride
        self.im_files = self.get_img_files(img_path, fraction)
        self.labels = self.get_labels()
        self.im_files = [lb["im_file"] for lb in self.labels]  # corrupt files were dropped
        if single_cls or classes is not None:
            self.update_labels(classes)
        self.ni = len(self.labels)
        self.cache_ram = cache is True or cache == "ram"
        self.ims = [None] * self.ni  # RAM image cache
        self.im_hw0 = [None] * self.ni
        self.im_hw = [None] * self.ni
        self.buffer: List[int] = []  # train: indices of the recently loaded images mosaic draws from
        self.max_buffer_length = min(self.ni, batch_size * 8, 1000) if augment else 0
        self._buffer_lock = threading.Lock()
        if self.rect:
            self.set_rectangle()
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.transforms = self.build_transforms(hyp)

    # ---- files & labels ----

    @staticmethod
    def get_img_files(img_path, fraction: float = 1.0) -> List[str]:
        f: List[str] = []
        for p in img_path if isinstance(img_path, list) else [img_path]:
            p = Path(p)
            if p.is_dir():
                f += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():
                with open(p) as t:
                    parent = str(p.parent) + os.sep
                    f += [x.replace("./", parent) if x.startswith("./") else x for x in t.read().strip().splitlines()]
            else:
                raise FileNotFoundError(f"{p} does not exist")
        im_files = sorted(x for x in f if x.rpartition(".")[-1].lower() in IMG_FORMATS)
        if not im_files:
            raise FileNotFoundError(f"no images found in {img_path}")
        if fraction < 1.0:
            im_files = im_files[: max(round(len(im_files) * fraction), 1)]
        return im_files

    def get_labels(self) -> List[Dict]:
        """Verify all image/label pairs (in parallel), reusing a valid `.cache.npy` beside the labels."""
        label_files = img2label_paths(self.im_files)
        cache_path = Path(label_files[0]).parent.with_suffix(".cache.npy")
        h = get_hash(self.im_files + label_files)
        if cache_path.exists():
            try:
                cached = load_dataset_cache_file(cache_path)
            except (OSError, ValueError, EOFError, pickle.UnpicklingError) as e:
                LOGGER.warning(f"ignoring unreadable label cache {cache_path}: {e}")
            else:
                if cached.get("version") == DATASET_CACHE_VERSION and cached.get("hash") == h:
                    return cached["labels"]

        labels = []
        nm = nf = ne = ncorr = 0  # missing / found / empty / corrupt counts
        with ThreadPoolExecutor(max_workers=8) as ex:
            ncls = len(self.data.get("names", {})) or 10**9
            results = ex.map(lambda args: verify_image_label(*args, ncls), zip(self.im_files, label_files))
            for im_file, cls, bboxes, shape, nm_f, nf_f, ne_f, nc_f, msg in results:
                nm, nf, ne, ncorr = nm + nm_f, nf + nf_f, ne + ne_f, ncorr + nc_f
                if msg:
                    LOGGER.warning(msg)
                if im_file is None:  # corrupt image/label: skip, keep going
                    continue
                labels.append({"im_file": im_file, "shape": shape, "cls": cls, "bboxes": bboxes,
                               "normalized": True, "bbox_format": "xywh"})
        LOGGER.info(f"Scanned {len(self.im_files)} images: {nf} labels found, {nm} missing, "
                    f"{ne} empty, {ncorr} corrupt")
        if not labels:
            raise FileNotFoundError(f"no valid images found in {self.img_path} ({ncorr} corrupt)")
        if nf == 0:
            LOGGER.warning(f"no labels found in {self.img_path}")
        try:
            save_dataset_cache_file("", cache_path, {"labels": labels, "hash": h, "version": DATASET_CACHE_VERSION})
        except OSError as e:  # a read-only dataset directory only loses the cache
            LOGGER.warning(f"label cache not saved to {cache_path}: {e}")
        return labels

    def update_labels(self, classes: Optional[List[int]]):
        """Apply single_cls / class filtering in place."""
        for lb in self.labels:
            if classes is not None:
                keep = np.isin(lb["cls"].reshape(-1), classes)
                lb["cls"] = lb["cls"][keep]
                lb["bboxes"] = lb["bboxes"][keep]
            if self.single_cls:
                lb["cls"][:, 0] = 0

    # ---- rect batching ----

    def set_rectangle(self):
        """Sort images by aspect ratio and give each batch one stride-aligned rect shape (pad 0.5)."""
        bi = np.floor(np.arange(self.ni) / self.batch_size).astype(int)
        nb = bi[-1] + 1
        s = np.array([lb["shape"] for lb in self.labels], dtype=np.float64)  # (h, w)
        ar = s[:, 0] / s[:, 1]
        irect = ar.argsort()
        self.im_files = [self.im_files[i] for i in irect]
        self.labels = [self.labels[i] for i in irect]
        ar = ar[irect]
        shapes = [[1, 1]] * nb
        for i in range(nb):
            ari = ar[bi == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[i] = [maxi, 1]
            elif mini > 1:
                shapes[i] = [1, 1 / mini]
        self.batch_shapes = np.ceil(np.array(shapes) * self.imgsz / self.stride + self.pad).astype(int) * self.stride
        self.batch = bi

    # ---- image loading ----

    def load_image(self, i: int):
        """BGR image i resized so its long side is imgsz, with its original and new (h, w).

        With augment, the image joins the rolling buffer of the last
        max_buffer_length loaded images, which stay in RAM for mosaic.
        """
        with self._buffer_lock:  # loader threads evict from the buffer while others read
            im, hw0, hw = self.ims[i], self.im_hw0[i], self.im_hw[i]
        if im is not None:
            return im, hw0, hw
        import cv2

        im = imread(self.im_files[i])
        if im is None:
            raise FileNotFoundError(f"image not found {self.im_files[i]}")
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            w, h = (min(math.ceil(w0 * r), self.imgsz), min(math.ceil(h0 * r), self.imgsz))
            im = cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
        if self.augment or self.cache_ram:
            with self._buffer_lock:
                self.ims[i], self.im_hw0[i], self.im_hw[i] = im, (h0, w0), im.shape[:2]
                if self.augment:
                    self.buffer.append(i)
                    if 1 < len(self.buffer) >= self.max_buffer_length:
                        j = self.buffer.pop(0)
                        self.ims[j], self.im_hw0[j], self.im_hw[j] = None, None, None
        return im, (h0, w0), im.shape[:2]

    # ---- items ----

    def get_image_and_label(self, index: int) -> Dict:
        label = deepcopy(self.labels[index])
        label.pop("shape", None)
        label["img"], label["ori_shape"], label["resized_shape"] = self.load_image(index)
        label["ratio_pad"] = (
            label["resized_shape"][0] / label["ori_shape"][0],
            label["resized_shape"][1] / label["ori_shape"][1],
        )
        if self.rect:
            label["rect_shape"] = self.batch_shapes[self.batch[index]]
        bboxes = label.pop("bboxes")
        label["instances"] = Instances(bboxes, bbox_format=label.pop("bbox_format"),
                                       normalized=label.pop("normalized"))
        return label

    def __getitem__(self, index: int) -> Dict:
        return self.transforms(self.get_image_and_label(index))

    def __len__(self):
        return len(self.labels)

    def build_transforms(self, hyp=None) -> Compose:
        """Train: v8_transforms (no mosaic or mixup with rect); val: LetterBox without upscaling. Then Format."""
        if self.augment:
            hyp.mosaic = hyp.mosaic if not self.rect else 0.0
            hyp.mixup = hyp.mixup if not self.rect else 0.0
            transforms = v8_transforms(self, self.imgsz, hyp, self.rng, self.np_rng)
        else:
            transforms = Compose([LetterBox(new_shape=(self.imgsz, self.imgsz), scaleup=False)])
        transforms.append(Format(bbox_format="xywh", normalize=True, batch_idx=True,
                                 bgr=hyp.bgr if self.augment else 0.0, rng=self.rng))
        return transforms

    def close_mosaic(self, hyp):
        """Turn off mosaic, copy-paste and mixup for the last epochs."""
        hyp.mosaic = 0.0
        hyp.copy_paste = 0.0
        hyp.mixup = 0.0
        self.transforms = self.build_transforms(hyp)

    # ---- collate ----

    @staticmethod
    def collate_fn(batch: List[Dict]) -> Dict:
        """Stack images; concatenate boxes and classes with a per-image batch_idx."""
        out: Dict = {}
        keys = batch[0].keys()
        values = list(zip(*[list(b.values()) for b in batch]))
        for i, k in enumerate(keys):
            v = values[i]
            if k == "img":
                v = np.stack(v, 0)
            elif k in {"bboxes", "cls"}:
                v = np.concatenate(v, 0)
            elif k == "batch_idx":
                v = np.concatenate([vi + j for j, vi in enumerate(v)], 0)
            out[k] = v
        return out


class DataLoader:
    """Thread-pool map + prefetch loader over a map-style dataset.

    cv2 and numpy release the GIL for the heavy parts, so threads pipeline
    well and share the RAM image cache. The explicit `seed` drives the
    shuffle, so a run is repeatable.
    """

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False, workers: int = 8,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.rng = random.Random(seed)
        self.collate_fn = getattr(dataset, "collate_fn", None)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _batches(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            pending = []
            batch_iter = self._batches()
            for _ in range(2):  # two batches in flight
                chunk = next(batch_iter, None)
                if chunk is not None:
                    pending.append(ex.submit(self._load_batch, chunk))
            while pending:
                fut = pending.pop(0)
                chunk = next(batch_iter, None)
                if chunk is not None:
                    pending.append(ex.submit(self._load_batch, chunk))
                yield fut.result()

    def _load_batch(self, indices):
        items = [self.dataset[i] for i in indices]
        return self.collate_fn(items) if self.collate_fn else items


def build_yolo_dataset(cfg, img_path, batch, data, mode: str = "val", rect: bool = False, stride: int = 32):
    """Dataset factory: mode 'train' augments with cfg's hyperparameters and seed."""
    train = mode == "train"
    return YOLODataset(
        img_path=img_path,
        imgsz=cfg.imgsz,
        batch_size=batch,
        augment=train,
        hyp=cfg,
        rect=cfg.rect or rect,
        cache=cfg.get("cache", False),
        single_cls=cfg.single_cls or False,
        classes=cfg.classes,
        fraction=getattr(cfg, "fraction", 1.0) if train else 1.0,
        data=data,
        stride=stride,
        pad=0.0 if train else 0.5,
        seed=int(cfg.get("seed", 0) or 0),
    )


def build_dataloader(dataset, batch: int, workers: int, shuffle: bool = True, seed: int = 0):
    """Dataloader factory."""
    return DataLoader(dataset, batch_size=batch, shuffle=shuffle, workers=workers, seed=seed)
