"""Inference source loaders: files, videos, in-memory arrays, streams, screenshots.

Port of yololite_tpu/data/loaders.py. Every loader yields (paths,
images_bgr, info_strings) batches of HWC BGR uint8 numpy arrays. cv2 (and
PIL) are imported only by the loaders that decode files, video or streams,
so in-memory numpy sources need neither.
"""

from __future__ import annotations

import glob
import math
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from yololite_tpu_torch.utils import LOGGER
from yololite_tpu_torch.utils.patches import imread

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm", "heic"}
VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}


@dataclass
class SourceTypes:
    """Flags describing the inference source kind."""

    stream: bool = False
    screenshot: bool = False
    from_img: bool = False
    tensor: bool = False


class LoadImagesAndVideos:
    """Batched iterator over image files, directories, globs, and videos."""

    def __init__(self, path, batch: int = 1, vid_stride: int = 1):
        files = []
        paths = path if isinstance(path, (list, tuple)) else [path]
        for p in paths:
            p = str(p)
            if "*" in p:
                files.extend(sorted(glob.glob(p, recursive=True)))
            elif os.path.isdir(p):
                files.extend(sorted(glob.glob(os.path.join(p, "*.*"))))
            elif os.path.isfile(p):
                files.append(p)
            else:
                raise FileNotFoundError(f"source '{p}' does not exist")
        self.files = [f for f in files if f.split(".")[-1].lower() in IMG_FORMATS | VID_FORMATS]
        if not self.files:
            raise FileNotFoundError(f"no images/videos found in {path}")
        self.nf = len(self.files)
        self.batch = batch
        self.vid_stride = vid_stride
        self.mode = "image"
        self.cap = None

    def __len__(self):
        return math.ceil(self.nf / self.batch)

    def __iter__(self):
        self.count = 0
        return self

    def _open_video(self, path):
        import cv2

        self.cap = cv2.VideoCapture(path)
        self.mode = "video"
        if not self.cap.isOpened():
            raise IOError(f"failed to open video {path}")
        self.frames = max(int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) / self.vid_stride), 0)
        self.frame = 0

    def __next__(self):
        paths, imgs, infos = [], [], []
        while len(imgs) < self.batch:
            if self.count >= self.nf and self.cap is None:
                if imgs:
                    return paths, imgs, infos
                raise StopIteration
            path = self.files[min(self.count, self.nf - 1)]
            suffix = path.split(".")[-1].lower()
            if suffix in VID_FORMATS:
                if self.cap is None:
                    self._open_video(path)
                for _ in range(self.vid_stride):
                    ok = self.cap.grab()
                    if not ok:
                        break
                ok, frame = self.cap.retrieve() if ok else (False, None)
                if not ok:
                    self.cap.release()
                    self.cap = None
                    self.count += 1
                    self.mode = "image"
                    continue
                self.frame += 1
                paths.append(path)
                imgs.append(frame)
                infos.append(f"video {self.count + 1}/{self.nf} frame {self.frame}/{self.frames} {path}: ")
            else:
                im = imread(path)  # BGR, unicode-safe (utils/patches.py)
                self.count += 1
                if im is None:
                    raise FileNotFoundError(f"image read failure {path}")
                paths.append(path)
                imgs.append(im)
                infos.append(f"image {self.count}/{self.nf} {path}: ")
        return paths, imgs, infos


class LoadTensor:
    """Single-batch loader for pre-normalized NHWC float arrays (RGB, 0-1).

    Accepts (B, H, W, 3) or (H, W, 3), checks stride divisibility, rescales
    0-255 inputs with a warning. The predictor feeds it to the network
    without letterboxing.
    """

    def __init__(self, im0, stride: int = 32):
        im0 = np.asarray(im0)
        if im0.ndim == 3:
            im0 = im0[None]
        if im0.ndim != 4 or im0.shape[-1] != 3:
            raise ValueError(f"tensor sources must be (B, H, W, 3) NHWC float arrays; got shape {im0.shape}")
        if im0.shape[1] % stride or im0.shape[2] % stride:
            raise ValueError(f"tensor source H/W must be divisible by stride {stride}; got {im0.shape[1:3]}")
        if im0.max() > 1.0 + np.finfo(np.float32).eps:
            LOGGER.warning(f"tensor inputs should be normalized 0.0-1.0 but max value is {im0.max():.3g}; dividing by 255")
            im0 = im0.astype(np.float32) / 255.0
        self.im0 = im0.astype(np.float32)
        self.bs = im0.shape[0]
        self.mode = "image"
        self.paths = [f"image{i}.jpg" for i in range(self.bs)]

    def __len__(self):
        return 1

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == 1:
            raise StopIteration
        self.count += 1
        return self.paths, self.im0, [""] * self.bs


class LoadPilAndNumpy:
    """Single-batch loader for in-memory PIL/numpy images."""

    def __init__(self, imgs):
        if not isinstance(imgs, (list, tuple)):
            imgs = [imgs]
        self.paths = [getattr(im, "filename", "") or f"image{i}.jpg" for i, im in enumerate(imgs)]
        self.imgs = [self._to_bgr(im) for im in imgs]
        self.mode = "image"
        self.bs = len(self.imgs)

    @staticmethod
    def _to_bgr(im):
        if not isinstance(im, np.ndarray):  # PIL
            arr = np.asarray(im.convert("RGB"))
            return np.ascontiguousarray(arr[..., ::-1])
        return im

    def __len__(self):
        return 1

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == 1:
            raise StopIteration
        self.count = 1
        return self.paths, self.imgs, [""] * self.bs


class LoadScreenshots:
    """Continuous screen-capture loader ('screen' source). Requires `mss`."""

    def __init__(self, source="screen"):
        import mss  # optional dependency

        parts = source.split()
        self.screen = int(parts[1]) if len(parts) > 1 else 0
        self.sct = mss.mss()
        self.mode = "stream"
        self.bs = 1
        self.frame = 0
        mon = self.sct.monitors[self.screen]
        self.monitor = {k: mon[k] for k in ("left", "top", "width", "height")}

    def __iter__(self):
        return self

    def __next__(self):
        im = np.asarray(self.sct.grab(self.monitor))[..., :3]
        self.frame += 1
        return [str(self.screen)], [np.ascontiguousarray(im)], [f"screen {self.screen}: "]


class LoadStreams:
    """Threaded multi-stream loader for webcams / RTSP / HTTP video feeds."""

    def __init__(self, sources="0", vid_stride: int = 1, buffer: bool = False):
        import cv2

        self.buffer = buffer
        self.vid_stride = vid_stride
        self.running = True
        self.mode = "stream"
        if isinstance(sources, str) and sources.endswith(".streams") and Path(sources).is_file():
            sources = [s.strip() for s in Path(sources).read_text().splitlines() if s.strip()]
        sources = [sources] if isinstance(sources, str) else list(sources)
        self.sources = sources
        n = len(sources)
        self.bs = n
        self.imgs: List[List[np.ndarray]] = [[] for _ in range(n)]
        self.shape = [None] * n
        self.caps = []
        self.threads = []
        self.frames = [0] * n
        for i, s in enumerate(sources):
            src = int(s) if str(s).isnumeric() else s
            cap = cv2.VideoCapture(src)
            if not cap.isOpened():
                raise ConnectionError(f"failed to open stream {s}")
            self.caps.append(cap)
            self.frames[i] = max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0) or float("inf")
            ok, im = cap.read()
            if not ok or im is None:
                raise ConnectionError(f"failed to read from stream {s}")
            self.imgs[i].append(im)
            self.shape[i] = im.shape
            t = threading.Thread(target=self._update, args=(i, cap, src), daemon=True)
            t.start()
            self.threads.append(t)

    def _update(self, i, cap, src):
        n = 0
        while self.running and cap.isOpened():
            if len(self.imgs[i]) < 30:
                n += 1
                cap.grab()
                if n % self.vid_stride == 0:
                    ok, im = cap.retrieve()
                    if not ok:
                        im = np.zeros(self.shape[i], np.uint8)
                        cap.open(src)  # re-open unresponsive stream
                    if self.buffer:
                        self.imgs[i].append(im)
                    else:
                        self.imgs[i] = [im]
            else:
                time.sleep(0.01)

    def close(self):
        self.running = False
        for t in self.threads:
            if t.is_alive():
                t.join(timeout=5)
        for cap in self.caps:
            cap.release()

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        self.count += 1
        images = []
        for i in range(self.bs):
            while not self.imgs[i]:
                if not self.threads[i].is_alive():
                    self.close()
                    raise StopIteration
                time.sleep(1 / 60)
            if self.buffer:
                images.append(self.imgs[i].pop(0))
            else:
                images.append(self.imgs[i][-1])
                self.imgs[i].clear()
        return [str(s) for s in self.sources], images, [""] * self.bs

    def __len__(self):
        return self.bs


def autocast_list(source):
    """Flatten a mixed list of sources into PIL/numpy images."""
    out = []
    for im in source if isinstance(source, (list, tuple)) else [source]:
        if isinstance(im, (str, Path)):
            arr = imread(str(im))
            if arr is None:  # imread returns None instead of raising
                raise FileNotFoundError(f"image read failure: {im}")
            out.append(arr)
        else:
            out.append(im)
    return out
