#!/usr/bin/env python3
"""The epoch loop and predict of this tree against another's, in turns on one card: ms a step, img/s.

    python3 tools/feed_timing.py --other DIR [--data DIR] [--images N] [--epochs N] [--calls N] [--pairs N]
                                 [--out FILE]

Each turn is a process of its own that imports one tree's yololite_tpu_torch
(this tree's or DIR's, for example the parent commit unpacked by `git
archive` under the gitignored `_archive/`), in --pairs pairs, the first
DIR then this, the next this then DIR, and so on. A turn builds the tree's
kernels, then
  - trains yolo11n (init(0), class biases -6) through `DetectionTrainer.train`
    at 640, batch 16, mosaic, no val and no save, for --epochs epochs in fp32
    (graphed) and in bf16 (graphed), on N synthetic PNGs of four shapes
    (`chip_smoke.write_val_dataset`, written under --data, by default a
    temporary directory, once and shared by the turns): each epoch's loop as
    `_train_epochs` runs it, with no sync a step (`train_seconds`: the batch
    loop, ending in its loss items' copy to the host), as ms a step and
    img/s;
  - predicts at batch 32, fp32 at 640, graphed (two untimed calls first):
    32 in-memory 480x640 frames (one batch a call) and a folder of 128 480x640
    JPEG frames (four batches a call), img/s over --calls calls each.
Where the tree has the feed (data/build.py `DeviceFeed`), the last epoch's
hand-over ms a step is reported too (the copies' device times are
`chip_smoke.py`'s, from its torch.profiler traces). The numbers are
the card's and the host's: the output names the card, its power limit and
the host's CPU count. Prints each turn's JSON line and, last, one JSON object
of all turns, which --out also receives.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def turn(tree: Path, data: Path, epochs: int, calls: int) -> dict:
    """One tree's numbers, in this process."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import yololite_tpu_torch
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.trainer import DetectionTrainer
    from yololite_tpu_torch.ops import cuda_build

    if Path(yololite_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported yololite_tpu_torch from {yololite_tpu_torch.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the numbers are the card's")
    cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))
    out = {"tree": str(tree), "train": {}, "predict": {}}
    n_images = len(list((data.parent / "images" / "train").iterdir()))
    for dtype in ("fp32", "bf16"):
        m = YOLOLite("yolo11n.yaml")
        with torch.no_grad():
            for seq in m.model.detect.cv3:
                seq[2].bias.fill_(-6.0)
        tr = DetectionTrainer(overrides={"data": str(data), "imgsz": 640, "batch": 16, "epochs": epochs, "val": False,
                                         "save": False, "amp": dtype == "bf16", "plots": False,
                                         "project": str(data.parent / "runs"), "name": f"{dtype}_{tree.name}"})
        tr.set_model(m.model)
        tr.train()
        steps = len(tr.train_loader)
        row = {"ms_a_step": [s * 1e3 / steps for s in tr.train_seconds],
               "img_s": [n_images / s for s in tr.train_seconds]}
        feed = getattr(tr, "last_feed", None)
        if feed is not None:
            row["handover_ms_a_step"] = feed.upload.handover_s * 1e3 / max(feed.upload.batches, 1)
        out["train"][dtype] = row
        del tr, m
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
    folder = data.parent / "frames"
    model = YOLOLite("yolo11n.yaml")
    kw = dict(conf=1e-7, imgsz=640, batch=32, save=False, verbose=False)
    for name, src, n in (("32 in-memory frames", frames, 32), ("a folder of 128 JPEG frames", str(folder), 128)):
        for _ in range(2):
            model.predict(src, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            model.predict(src, **kw)
        torch.cuda.synchronize()
        out["predict"][name] = calls * n / (time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other tree, timed in turns with this one")
    ap.add_argument("--data", type=Path, default=None, help="the dataset's directory (written there if absent)")
    ap.add_argument("--images", type=int, default=128,
                    help="train images, a multiple of 4 (128: all held in the loader's image buffer at batch 16)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--calls", type=int, default=5, help="timed predict calls a source")
    ap.add_argument("--out", default=None)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)  # one tree's turn, in a process of its own
    args = ap.parse_args()
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.data / "data.yaml", args.epochs, args.calls)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    tmp = tempfile.TemporaryDirectory()
    data = (args.data or Path(tmp.name)).resolve()
    if not (data / "data.yaml").exists():
        import cv2
        import numpy as np

        smoke = _smoke()
        shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
        smoke.write_val_dataset(data, shapes * (args.images // 4), seed=20, split="train")
        smoke.write_val_dataset(data, shapes, seed=21, split="val")
        rng = np.random.default_rng(0)
        (data / "frames").mkdir(exist_ok=True)
        frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
        for i in range(128):
            cv2.imwrite(str(data / "frames" / f"f{i:03d}.jpg"), frames[i % 32])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    host = f"{card}, host {os.cpu_count()} CPUs"
    trees = {"other": args.other.resolve(), "this": REPO}
    turns = []
    order = [side for k in range(args.pairs) for side in (("other", "this") if k % 2 == 0 else ("this", "other"))]
    for side in order:
        got = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", str(trees[side]), "--data",
                              str(data), "--epochs", str(args.epochs), "--calls", str(args.calls)],
                             capture_output=True, text=True)
        if got.returncode:
            sys.stderr.write(got.stderr[-4000:])
            raise RuntimeError(f"the {side} tree's turn failed ({got.returncode})")
        row = json.loads(got.stdout.strip().splitlines()[-1])
        row["side"] = side
        turns.append(row)
        tr = row["train"]
        print(f"{side} ({trees[side].name}): train ms a step by epoch fp32 "
              f"{', '.join(f'{x:.1f}' for x in tr['fp32']['ms_a_step'])}, bf16 "
              f"{', '.join(f'{x:.1f}' for x in tr['bf16']['ms_a_step'])}; last epoch img/s fp32 "
              f"{tr['fp32']['img_s'][-1]:.1f}, bf16 {tr['bf16']['img_s'][-1]:.1f}; hand-over ms a step fp32 "
              f"{tr['fp32'].get('handover_ms_a_step', 'n/a')}, bf16 {tr['bf16'].get('handover_ms_a_step', 'n/a')}; "
              f"predict img/s at batch 32: " + ", ".join(f"{k} {v:.1f}" for k, v in row["predict"].items())
              + f"; on {host}", flush=True)
    result = {"host": host, "images": args.images, "epochs": args.epochs, "turns": turns}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
