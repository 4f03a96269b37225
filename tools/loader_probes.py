#!/usr/bin/env python3
"""What caps the train loader's threads: numpy's reversed copies, cv2's own thread pool, the planning thread.

    python3 tools/loader_probes.py --data DIR [--images N]

On this repository's yololite_tpu_torch, three probes on the host (no card
is needed; the output names the host's CPU count and, where nvidia-smi
answers, the card's name and power limit):
  - copies: ms an image (640 x 640 x 3 uint8, one thread, median of 20) of
    numpy's contiguous copy of `img[..., ::-1]` and of `np.fliplr(img)`
    against cv2's `cvtColor(BGR2RGB)` and `flip(img, 1)`, checked equal;
  - cv2's pool: ms an image of the HSV step (`data/augment.py _hsv_pixels`)
    on 8 threads at once, with cv2's own pool at its default and off, and
    the train loader alone at 8 workers (mosaic, batch 16 at 640, N
    synthetic PNGs written under --data once, third pass) with cv2's pool
    left on (the loader's `cv2.setNumThreads(0)` made a no-op) and as the
    loader sets it;
  - the plan: each batch's `dataset.plan` calls inside the loader, wall and
    the planning thread's CPU ms (medians over two passes), at 0 workers
    (one thread does everything) and at 8.
Prints one JSON object last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def per_image_ms(fn, n=20) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def threaded_ms(fn, k=8, n=40) -> float:
    """Wall ms per call of k threads each calling fn n times at once; a thread's exception is raised here."""
    errors = []

    def run():
        try:
            for _ in range(n):
                fn()
        except Exception as e:  # re-raised below, on the caller's thread
            errors.append(e)

    ts = [threading.Thread(target=run) for _ in range(k)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return (time.perf_counter() - t0) / (k * n) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="the dataset's directory (written here if absent)")
    ap.add_argument("--images", type=int, default=64, help="train images, a multiple of 4")
    args = ap.parse_args()
    import cv2

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data import augment as A
    from yololite_tpu_torch.data import dataset as D
    from yololite_tpu_torch.data.utils import check_det_dataset

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "no card"
    host = f"{card}, host {os.cpu_count()} CPUs"
    out = {"host": host}
    cv2_threads = cv2.getNumThreads()

    img = np.random.default_rng(0).integers(0, 256, (640, 640, 3), dtype=np.uint8)
    if not (np.array_equal(np.ascontiguousarray(img[..., ::-1]), cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            and np.array_equal(np.fliplr(img), cv2.flip(img, 1))):
        raise AssertionError("cv2's channel swap or flip differs from numpy's")
    out["copies_ms"] = {
        "numpy img[..., ::-1]": per_image_ms(lambda: np.ascontiguousarray(img[..., ::-1])),
        "cv2 BGR2RGB": per_image_ms(lambda: cv2.cvtColor(img, cv2.COLOR_BGR2RGB)),
        "numpy fliplr": per_image_ms(lambda: np.ascontiguousarray(np.fliplr(img))),
        "cv2 flip": per_image_ms(lambda: cv2.flip(img, 1)),
    }
    print(f"copies, ms an image on one thread: {out['copies_ms']}; on {host}", flush=True)

    gains = np.array([1.01, 0.8, 1.2])
    hsv = lambda: A._hsv_pixels(gains, img.copy())
    out["hsv_8_threads_ms"] = {"cv2 pool on": threaded_ms(hsv)}
    cv2.setNumThreads(0)
    out["hsv_8_threads_ms"]["cv2 pool off"] = threaded_ms(hsv)
    cv2.setNumThreads(cv2_threads)

    root = Path(args.data)
    if not (root / "data.yaml").exists():
        shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
        smoke.write_val_dataset(root, shapes * (args.images // 4), seed=20, split="train")
        smoke.write_val_dataset(root, shapes[:1] * 4, seed=21, split="val")
    data = root / "data.yaml"
    hyp = get_cfg(overrides={"data": str(data), "imgsz": 640, "batch": 16, "mode": "train"})
    dinfo = check_det_dataset(str(data))

    class Timed(D.DataLoader):
        """Times each batch's plans on the planning thread (wall and that thread's CPU)."""

        def _start_batch(self, chunk, pool, alloc):
            t0, c0 = time.perf_counter(), time.thread_time()
            items = [self.dataset.plan(i) for i in chunk]
            self.plan_ms.append(((time.perf_counter() - t0) * 1e3, (time.thread_time() - c0) * 1e3))
            planned = iter(items)
            self.dataset.plan = lambda i: next(planned)
            try:
                return super()._start_batch(chunk, pool, alloc)
            finally:
                del self.dataset.plan

    def loader_rate(workers):
        loader = Timed(D.build_yolo_dataset(hyp, dinfo["train"], 16, dinfo, mode="train"), batch_size=16,
                       shuffle=True, workers=workers, seed=0)
        loader.plan_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            n = sum(len(b["img"]) for b in loader)
        return n / (time.perf_counter() - t0), np.median(np.array(loader.plan_ms), 0).tolist()

    real = cv2.setNumThreads
    cv2.setNumThreads = lambda n: None
    try:
        on, _ = loader_rate(8)
    finally:
        cv2.setNumThreads = real
    off, plan8 = loader_rate(8)
    cv2.setNumThreads(cv2_threads)
    _, plan0 = loader_rate(0)
    out["loader_w8_img_s"] = {"cv2 pool on": on, "cv2 pool off": off}
    out["plan_ms_a_batch"] = {"workers 0": plan0, "workers 8": plan8}
    print(f"cv2's pool: HSV on 8 threads, ms an image {out['hsv_8_threads_ms']}; the train loader alone at 8 "
          f"workers (third pass), img/s {out['loader_w8_img_s']}; on {host}", flush=True)
    print(f"the plan, a batch of 16 (wall, planning thread's CPU) ms, medians: {out['plan_ms_a_batch']}; on {host}",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
