"""YOLO detection dataset and host dataloader (port of yololite_tpu/data/dataset.py).

File globbing, the label cache (the JAX package's format and version, so
either package reads the other's `labels.cache.npy`), rect batching, image
loading, the train transforms with their rolling image buffer, and collate.
Batches are numpy dicts; images stay uint8 NHWC RGB.

With augment=True the dataset owns one `random.Random` and one
`np.random.RandomState`, seeded with `seed`, from which all its transforms
draw (the JAX package draws from the process-wide `random` and `np.random`).
No draw depends on a pixel (data/augment.py), so an item is made in two
halves: `plan(i)` takes its draws, keeps the buffer and does the label work
from the image sizes in the label cache, in load order on one thread;
`apply(item)` decodes, resizes and transforms the pixels on any thread.
`dataset[i]` is the one followed by the other. The `DataLoader` plans each
batch on one thread and spreads its applies over a pool, so any number of
threads gives the batches one thread gives, which are the JAX package's
loader's at workers 0.
"""

from __future__ import annotations

import glob
import math
import os
import pickle
import random
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from yololite_tpu_torch.data.augment import Compose, Format, LetterBox, PlannedImage, v8_transforms
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


class _PlannedLoad(PlannedImage):
    """A planned image's leaf: the dataset's image `index`, decoded and resized."""

    __slots__ = ("index",)

    def __init__(self, index: int, shape, fn):
        super().__init__(shape, "decode", fn)
        self.index = index


class _Entry:
    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done, self.value, self.error = threading.Event(), None, None


class ImageCache:
    """The decoded and resized images that the applies share, by dataset index; thread-safe.

    The first apply that needs an image decodes it and the others wait for
    it. The plan pins each image that an item reads (`pin`), and the item's
    apply unpins it when the item is built; the plan also says which images
    to keep (`keep`, `release`: the rolling buffer's). An image leaves the
    cache when nothing pins it and nothing keeps it (`keep_all`: never), so
    the cache is bounded by the buffer and the items in flight, and it never
    drops an image that a planned item has still to read.
    """

    def __init__(self, keep_all: bool = False):
        self.keep_all = keep_all
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}
        self._pins = Counter()
        self._kept = set()

    def __contains__(self, i: int) -> bool:
        return i in self._entries

    def indices(self) -> set:
        with self._lock:
            return set(self._entries)

    def pinned(self) -> Dict[int, int]:
        """Each pinned image's count of planned items that have still to read it."""
        with self._lock:
            return dict(self._pins)

    def pin(self, i: int):
        with self._lock:
            self._pins[i] += 1

    def unpin(self, indices):
        with self._lock:
            for i in indices:
                self._pins[i] -= 1
                if self._pins[i] <= 0:
                    del self._pins[i]
                    self._drop(i)

    def keep(self, i: int):
        with self._lock:
            self._kept.add(i)

    def release(self, i: int):
        with self._lock:
            self._kept.discard(i)
            self._drop(i)

    def _drop(self, i: int):
        if not self.keep_all and i not in self._kept and not self._pins[i]:
            self._entries.pop(i, None)

    def get(self, i: int, load) -> np.ndarray:
        """Image i, from `load()` if no apply has loaded it and it is not loading."""
        with self._lock:
            entry = self._entries.get(i)
            owner = entry is None
            if owner:
                entry = self._entries[i] = _Entry()
        if owner:
            try:
                entry.value = load()
            except BaseException as e:
                entry.error = e
                with self._lock:
                    if self._entries.get(i) is entry:
                        del self._entries[i]
                raise
            finally:
                entry.done.set()
        else:
            entry.done.wait()
            if entry.error is not None:
                raise entry.error
        return entry.value


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
        # the decoded images the applies share: the buffer's and, with cache='ram' and no augment, every one
        self.ims = ImageCache(keep_all=self.cache_ram and not augment)
        self.buffer: List[int] = []  # train: indices of the recently loaded images mosaic draws from (the plan's)
        self._buffered = set()
        self.max_buffer_length = min(self.ni, batch_size * 8, 1000) if augment else 0
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

    def plan_image(self, i: int):
        """Plan the load of image i: its planned pixels (BGR, the long side resized to imgsz) and its original and
        new (h, w), from the size the label cache holds.

        With augment, an image not in the rolling buffer of the last
        max_buffer_length loaded images joins it (the oldest leaves), as
        loading it did when the load decoded it. The image stays pinned in
        the cache until the apply of the item that planned it is done.
        """
        h0, w0 = (int(v) for v in self.labels[i]["shape"])
        r = self.imgsz / max(h0, w0)
        h, w = (min(math.ceil(h0 * r), self.imgsz), min(math.ceil(w0 * r), self.imgsz)) if r != 1 else (h0, w0)
        if self.augment and i not in self._buffered:
            self.buffer.append(i)
            self._buffered.add(i)
            self.ims.keep(i)
            if 1 < len(self.buffer) >= self.max_buffer_length:
                j = self.buffer.pop(0)
                self._buffered.discard(j)
                self.ims.release(j)
        self.ims.pin(i)
        return _PlannedLoad(i, (h, w, 3), partial(self.ims.get, i, partial(self.load_image, i))), (h0, w0), (h, w)

    def load_image(self, i: int) -> np.ndarray:
        """BGR image i decoded and resized so its long side is imgsz; raises if its size is not the label cache's,
        the size its plan was made from."""
        import cv2

        im = imread(self.im_files[i])
        if im is None:
            raise FileNotFoundError(f"image not found {self.im_files[i]}")
        h0, w0 = im.shape[:2]
        if (h0, w0) != tuple(int(v) for v in self.labels[i]["shape"]):
            raise ValueError(f"{self.im_files[i]}: decoded as {h0}x{w0} (h x w), its label cache holds "
                             f"{tuple(self.labels[i]['shape'])}, the size the transforms were planned for; delete "
                             "the labels' .cache.npy to rescan")
        r = self.imgsz / max(h0, w0)
        if r != 1:
            w, h = (min(math.ceil(w0 * r), self.imgsz), min(math.ceil(h0 * r), self.imgsz))
            im = cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
        return im

    # ---- items ----

    def get_image_and_label(self, index: int) -> Dict:
        """Item index's labels with its planned image (`plan_image`)."""
        label = {k: v.copy() if isinstance(v, np.ndarray) else deepcopy(v)  # a deepcopy, in a tenth of the time
                 for k, v in self.labels[index].items() if k != "shape"}
        label["img"], label["ori_shape"], label["resized_shape"] = self.plan_image(index)
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

    def plan(self, index: int) -> Dict:
        """Item index with every draw taken and its labels final, its "img" a PlannedImage. Plans must run in load
        order on one thread: they draw from the dataset's generators and keep the buffer."""
        return self.transforms(self.get_image_and_label(index))

    def apply(self, item: Dict, out: Optional[np.ndarray] = None, times: Optional[Dict] = None) -> Dict:
        """A planned item with its image built (into `out` if given), on any thread; with a dict `times`, the
        seconds of each stage of the pixel work are added to it. Unpins the item's images."""
        node = item["img"]
        try:
            img = node.build(times)
        finally:
            self.release(item)
        if out is not None:
            t0 = time.perf_counter()
            np.copyto(out, img)
            img = out
            if times is not None:
                times["collate"] = times.get("collate", 0.0) + time.perf_counter() - t0
        return {**item, "img": img}

    def release(self, item: Dict):
        """Unpin a planned item's images, built or not (a rank's loader skips the other ranks' rows)."""
        self.ims.unpin(x.index for x in item["img"].leaves())

    def __getitem__(self, index: int) -> Dict:
        return self.apply(self.plan(index))

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
    """Batches of a YOLODataset built by a pool of threads, two batches in flight.

    One thread plans each batch's items in order, batch after batch
    (`dataset.plan`: every augmentation draw, the labels, the image buffer).
    Each item's pixel work (`dataset.apply`) then goes to the pool of
    `workers` threads and writes its row of the batch's image array, and the
    labels are collated in index order. So any `workers` gives the batches
    one thread gives: those of the JAX package's loader at workers 0. cv2 and
    numpy release the GIL for the pixel work. workers=0: one thread plans and
    builds everything. A pool of more than one thread turns cv2's own thread
    pool off for the process (`cv2.setNumThreads(0)`, as the upstream package
    does at import): with both, the threads contended.

    On a data-parallel rank (`rank` of `world`), every rank plans the whole
    global batch and builds only its own rows of the images when the batch
    divides (all of them when it does not): a batch's "img" holds rows
    `img_rows` = (start, stop, n) of its n images, its labels are the global
    batch's. The explicit `seed` drives the shuffle, so a run is repeatable.
    """

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False, workers: int = 8,
                 drop_last: bool = False, seed: int = 0, rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a world of {world}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(0, workers)
        self.drop_last = drop_last
        self.rng = random.Random(seed)
        self.rank, self.world = rank, world
        self.collate_fn = dataset.collate_fn

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

    def rows(self, n: int) -> slice:
        """The image rows of a batch of n that this rank builds: its equal share when n divides, else all."""
        if n % self.world:
            return slice(0, n)
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def __iter__(self):
        return self.iterate()

    def iterate(self, alloc: Callable = np.empty):
        """The batches, each batch's image array made by `alloc(shape, np.uint8)` (a feed's pinned host buffer;
        by default a fresh array, so that batches held at once never share memory)."""
        if self.workers > 1:  # the pool's threads each run cv2 on one thread: cv2's own pool fought them
            import cv2

            cv2.setNumThreads(0)
        with ThreadPoolExecutor(1) as planner, ThreadPoolExecutor(max(1, self.workers)) as pool:
            pending = deque()
            chunks = self._batches()

            def submit():
                chunk = next(chunks, None)
                if chunk is not None:
                    pending.append(planner.submit(self._start_batch, chunk, pool if self.workers else None, alloc))

            for _ in range(2):  # two batches in flight
                submit()
            while pending:
                started = pending.popleft().result()
                submit()
                yield self._finish_batch(*started)

    def _start_batch(self, chunk, pool, alloc):
        """Plan the batch's items in order, then start the pixel work of this rank's rows (on the pool, or here) into
        an array from `alloc`."""
        items = [self.dataset.plan(i) for i in chunk]
        rows = self.rows(len(items))
        shape = items[rows.start]["img"].shape
        for j in range(rows.start, rows.stop):
            if items[j]["img"].shape != shape:
                raise ValueError(f"a batch's images differ in shape: {items[j]['img'].shape} and {shape}")
        out = alloc((rows.stop - rows.start, *shape), np.uint8)
        work = [partial(self.dataset.apply, items[j], out[j - rows.start]) for j in range(rows.start, rows.stop)]
        for j in (*range(rows.start), *range(rows.stop, len(items))):  # other ranks' rows
            self.dataset.release(items[j])
        if pool is None:
            for w in work:
                w()
            return items, rows, out, []
        return items, rows, out, [pool.submit(w) for w in work]

    def _finish_batch(self, items, rows, out, futures):
        for f in futures:
            f.result()
        for item in items:
            item.pop("img")
        batch = self.collate_fn(items)
        batch["img"] = out
        if self.world > 1:
            batch["img_rows"] = (rows.start, rows.stop, len(items))
        return batch


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


def build_dataloader(dataset, batch: int, workers: int, shuffle: bool = True, seed: int = 0, rank: int = 0,
                     world: int = 1):
    """Dataloader factory; on data-parallel ranks, `rank` of `world` builds its rows of each global batch."""
    return DataLoader(dataset, batch_size=batch, shuffle=shuffle, workers=workers, seed=seed, rank=rank,
                      world=world)
