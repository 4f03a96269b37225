#!/usr/bin/env python3
"""Where one yolo11n predict call of the PyTorch port spends its time on a CUDA card.

    python3 tools/torch_predict_profile.py [--reps 5] [--trace DIR]

For fp32 at batch 1 and 32 and bf16 at batch 32 (synthetic 480x640 uint8
frames, imgsz 640, init(0) weights, conf 1e-7, the device letterbox path) it
prints one JSON line each:

  call_ms      host-clock ms per `YOLOLite.predict` call, mean of --reps calls
  stack_ms     host-clock ms of np.stack of the frames
  upload_ms    host-clock ms of their copy to the card, synchronised
  device_ms    ms per call in which the card ran a kernel or a copy (union of
               the intervals torch.profiler records on the device)
  idle_share   1 - device_ms / call_ms
  launches     device kernels and copies per call
  top          the kernels with the most device time per call, ms

With --trace DIR it also writes each configuration's Chrome trace there.
Needs a CUDA card, and exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def busy_ms(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", type=Path, default=None)
    opt = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_predict_profile: no CUDA card is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from yololite_tpu_torch import YOLOLite

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    model = YOLOLite("yolo11n.yaml")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]

    for half, bs in ((False, 1), (False, 32), (True, 32)):
        src = frames[:bs]
        kw = dict(conf=1e-7, imgsz=640, batch=bs, half=half, save=False, verbose=False)
        model.predict(src, **kw)  # set up and warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(opt.reps):
            model.predict(src, **kw)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / opt.reps

        stack = upload = 0.0
        for _ in range(opt.reps):
            t0 = time.perf_counter()
            batch = np.stack(src)
            t1 = time.perf_counter()
            torch.from_numpy(batch).cuda()
            torch.cuda.synchronize()
            stack, upload = stack + t1 - t0, upload + time.perf_counter() - t1

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(opt.reps):
                model.predict(src, **kw)
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not on_device:
            raise RuntimeError("torch.profiler recorded no device activity")
        by_name = defaultdict(float)
        for e in on_device:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / opt.reps
        device_ms = busy_ms((e.time_range.start, e.time_range.end) for e in on_device) / opt.reps
        name = f"{'bf16' if half else 'fp32'}_b{bs}"
        if opt.trace:
            opt.trace.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(opt.trace / f"torch_predict_{name}.json"))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "config": name, "card": card, "call_ms": call_ms,
            "stack_ms": stack * 1e3 / opt.reps, "upload_ms": upload * 1e3 / opt.reps,
            "device_ms": device_ms, "idle_share": 1 - device_ms / call_ms,
            "launches": len(on_device) / opt.reps,
            "top": [[n[:80], ms] for n, ms in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
