#!/usr/bin/env python3
"""Predict at batch 32 with the source read on a thread of its own or on the feed's, in turns on one card.

    python3 tools/feed_probe.py [--rounds N] [--calls N]

The predictor reads its source on a `Prefetcher` thread and stages each
batch on its `DeviceFeed` thread behind it (engine/predictor.py). This
probe times yolo11n fp32 at 640, batch 32, graphed (two untimed calls
first), on a folder of 128 480x640 JPEG frames and on 32 in-memory frames,
in --rounds rounds of the two forms in turns: the predictor as it is, and
with the source read on the feed's own thread (the Prefetcher taken out).
For each it prints img/s over --calls calls, the feed thread's ms a batch
in the predictor's stage (stacking into the page-locked buffer), and the
consumer's ms a batch waiting on the feed. Needs a CUDA card; prints the
card's name and power limit with every line.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    import cv2
    import numpy as np
    import torch

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine import predictor as P
    from yololite_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the numbers are the card's")
    cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.TemporaryDirectory()
    folder = Path(tmp.name) / "frames"
    folder.mkdir()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
    for i in range(128):
        cv2.imwrite(str(folder / f"f{i:03d}.jpg"), frames[i % 32])

    stage_s = []
    stage = P.DetectionPredictor._stage

    def timed_stage(self, item, take, is_tensor):
        t0 = time.perf_counter()
        try:
            return stage(self, item, take, is_tensor)
        finally:
            stage_s.append(time.perf_counter() - t0)

    P.DetectionPredictor._stage = timed_stage
    prefetcher = P.Prefetcher
    forms = {"as it is (the source read on a Prefetcher thread)": prefetcher,
             "the source read on the feed's thread": lambda source, depth=2: source}
    model = YOLOLite("yolo11n.yaml")
    kw = dict(conf=1e-7, imgsz=640, batch=32, save=False, verbose=False)
    res = {}
    for r in range(args.rounds):
        for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            P.Prefetcher = forms[name]
            for src, n, tag in ((str(folder), 128, "a folder of 128 JPEG frames"), (frames, 32, "32 in-memory frames")):
                for _ in range(2):
                    model.predict(src, **kw)
                stage_s.clear()
                waits = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    model.predict(src, **kw)
                    waits.append(model.predictor.last_feed.wait_s)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                res.setdefault((tag, name), []).append(
                    f"{args.calls * n / dt:.1f} img/s (stage {np.mean(stage_s) * 1e3:.1f} ms a batch, the consumer "
                    f"waiting {np.mean(waits) * 1e3 / (n // 32):.1f} ms a batch)")
    P.Prefetcher = prefetcher
    for (tag, name), rows in res.items():
        print(f"feed probe: {tag}, batch 32, {name}: " + "; ".join(rows) + f"; on {card}", flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
