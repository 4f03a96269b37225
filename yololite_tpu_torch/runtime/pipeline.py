"""Sustained-inference serving pipeline: double-buffered host -> device streaming (port of
yololite_tpu/runtime/pipeline.py).

Submission does not block while the buffers have room: a host thread
letterboxes each batch (cv2), writes it, padded to the predictor's batch
size, into a page-locked buffer and starts its copy on the card's copy
stream (data/build.py `Upload`); a dispatch thread waits for that copy on
its own stream, runs the predictor's `infer` on its device and copies the
detections back, so a batch's copy runs while the batch before is
inferred. The results wait in completion order.
Per-batch latency, submission to detections on the host, is recorded. A
stage's exception is raised by `results()`; the stages go on draining their
queues, so `submit` and `close` never block on a dead stage.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch.data.build import PinnedRing, Upload
from yololite_tpu_torch.ops.letterbox import preprocess_batch


@dataclass
class PipelineStats:
    latencies_ms: List[float] = field(default_factory=list)
    submitted: int = 0
    completed: int = 0

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latencies_ms, q)) if self.latencies_ms else float("nan")

    def summary(self) -> Dict[str, float]:
        return {
            "completed": self.completed,
            "p50_ms": self.percentile(50),
            "p90_ms": self.percentile(90),
            "p99_ms": self.percentile(99),
            "throughput_img_s": None,
        }


class InferencePipeline:
    """Two stages, [host preprocess] -> [device infer], with `depth` batches buffered between them.

    Built on a set-up DetectionPredictor; `submit` returns a ticket id and
    `results()` yields (ticket, detections (n, max_det, 6) ndarray) in
    completion order.
    """

    def __init__(self, predictor, imgsz: Optional[int] = None, depth: int = 2):
        self.predictor = predictor
        self.imgsz = imgsz or (predictor.args.imgsz if isinstance(predictor.args.imgsz, int)
                               else predictor.args.imgsz[0])
        self.batch = int(predictor.args.batch)
        self._pre_q: queue.Queue = queue.Queue(maxsize=depth)
        self._disp_q: queue.Queue = queue.Queue(maxsize=depth)
        self._out_q: queue.Queue = queue.Queue()
        self.stats = PipelineStats()
        self._stop = object()
        self._threads: List[threading.Thread] = []
        self._started = False
        self.upload = Upload(predictor.device, PinnedRing(predictor.device))

    # ---- stage workers ----

    def _stage(self, images):
        """Letterbox the frames into a host buffer of the ring, zero images after them up to the batch size, and
        start its copy to the device."""
        im = preprocess_batch(images, imgsz=self.imgsz)
        n = im.shape[0]
        shape = (max(n, self.batch), *im.shape[1:])
        buf = self.upload.ring.take(int(np.prod(shape)) * im.itemsize)
        x = buf.view(shape, im.dtype)
        x[:n] = im
        x[n:] = 0
        return self.upload.stage({"x": x}, held=[buf]), n

    def _preprocess_worker(self):
        failed = None
        while True:
            item = self._pre_q.get()
            if item is self._stop:
                self._disp_q.put(self._stop)
                return
            if failed is not None:  # drain, so that submit never blocks on a dead stage
                continue
            try:
                ticket, images, t0 = item
                staged, n = self._stage(images)
                self._disp_q.put((ticket, staged, n, t0))
            except BaseException as e:  # raised by results()
                failed = e
                self._disp_q.put(e)

    def _dispatch_worker(self):
        p = self.predictor
        failed = None
        while True:
            item = self._disp_q.get()
            if item is self._stop:
                self._out_q.put(self._stop)
                return
            if failed is not None:  # drain
                continue
            if isinstance(item, BaseException):
                failed = item
                self._out_q.put(item)
                continue
            try:
                ticket, staged, n, t0 = item
                x = self.upload.hand_over(staged)["x"]
                dets = p.infer(x).cpu().numpy()[:n]  # the copy back waits for the card
                self.stats.latencies_ms.append((time.perf_counter() - t0) * 1e3)
                self.stats.completed += n
                self._out_q.put((ticket, dets))
            except BaseException as e:  # raised by results()
                failed = e
                self._out_q.put(e)

    # ---- API ----

    def start(self):
        if self._started:
            return self
        self.predictor.imgsz = (self.imgsz, self.imgsz)
        if not self.predictor.done_warmup:
            self.predictor.warmup(self.batch)
        for fn in (self._preprocess_worker, self._dispatch_worker):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def submit(self, images: List[np.ndarray]) -> int:
        """Submit a batch of BGR uint8 frames; blocks only while `depth` batches wait for preprocessing."""
        ticket = self.stats.submitted
        self.stats.submitted += len(images)
        self._pre_q.put((ticket, images, time.perf_counter()))
        return ticket

    def results(self):
        """Yield (ticket, dets) in completion order until close() has drained the stages; a stage's exception is
        raised here."""
        while True:
            item = self._out_q.get()
            if item is self._stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        self._pre_q.put(self._stop)
        for t in self._threads:
            t.join(timeout=30)
        self._started = False

    def summary(self, wall_s: Optional[float] = None) -> Dict:
        s = self.stats.summary()
        if wall_s:
            s["throughput_img_s"] = self.stats.completed / wall_s
        return s
