"""Source dispatch and the host prefetcher (port of yololite_tpu/data/build.py, predict part)."""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from yololite_tpu_torch.data.loaders import (
    IMG_FORMATS,
    VID_FORMATS,
    LoadImagesAndVideos,
    LoadPilAndNumpy,
    LoadScreenshots,
    LoadStreams,
    LoadTensor,
    SourceTypes,
    autocast_list,
)


def check_source(source):
    """Classify a source -> (source, stream, screenshot, from_img, in_memory, tensor)."""
    webcam, screenshot, from_img, in_memory, tensor = False, False, False, False, False
    if isinstance(source, (str, int, Path)):
        s = str(source)
        is_file = s.rpartition(".")[-1].lower() in (IMG_FORMATS | VID_FORMATS)
        is_url = s.lower().startswith(("https://", "http://", "rtsp://", "rtmp://", "tcp://"))
        webcam = s.isnumeric() or s.endswith(".streams") or (is_url and not is_file)
        screenshot = s.lower().startswith("screen")
    elif isinstance(source, (list, tuple)):
        if not all(isinstance(x, (str, Path)) for x in source):
            source = autocast_list(source)
            from_img = True
    elif isinstance(source, np.ndarray):
        # a batched float array is a pre-normalized NHWC tensor source
        if source.ndim == 4 and np.issubdtype(source.dtype, np.floating):
            tensor = True
        elif source.ndim == 4:
            source = list(source)  # uint8 (B,H,W,3) batch -> list of HWC images
            from_img = True
        else:
            from_img = True
    elif type(source).__module__.startswith("torch"):  # a torch tensor: NHWC float, as a numpy float source
        source = source.detach().cpu().numpy()
        tensor = True
    else:  # PIL image or anything array-like
        from_img = True
    return source, webcam, screenshot, from_img, in_memory, tensor


def load_inference_source(source, batch: int = 1, vid_stride: int = 1, buffer: bool = False):
    """Build the right loader for the given source; attaches .source_type flags."""
    source, stream, screenshot, from_img, _, tensor = check_source(source)
    if tensor:
        dataset = LoadTensor(source)
    elif stream:
        dataset = LoadStreams(source, vid_stride=vid_stride, buffer=buffer)
    elif screenshot:
        dataset = LoadScreenshots(source)
    elif from_img:
        dataset = LoadPilAndNumpy(source)
    else:
        dataset = LoadImagesAndVideos(source, batch=batch, vid_stride=vid_stride)
    dataset.source_type = SourceTypes(stream=stream, screenshot=screenshot, from_img=from_img, tensor=tensor)
    return dataset


class Prefetcher:
    """Background-thread batch prefetcher (double buffering of the host feed)."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread: Optional[threading.Thread] = None

    def _work(self):
        try:
            for item in self.iterable:
                self.q.put(item)
        except BaseException as e:  # surfaced in the consumer, not swallowed
            self.q.put(e)
        finally:
            self.q.put(self._DONE)

    def __iter__(self):
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()
        while True:
            item = self.q.get()
            if item is self._DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
