#!/usr/bin/env python3
"""The host loaders alone, of one tree: train (mosaic) and val img/s by workers, on synthetic PNGs at 640.

    python3 tools/loader_timing.py [--tree DIR] [--data DIR] [--images N] [--workers 0 8] [--out FILE]

With DIR's (default: this repository's) yololite_tpu_torch, builds the
train loader (mosaic, perspective, HSV, flips: the default recipe; batch 16
at 640, shuffled with seed 0) and the rect val loader (batch 16) on N
synthetic PNGs of four shapes (`chip_smoke.write_val_dataset`, written under
--data once and reused), and for each `workers` times two passes of each:
the first decodes every image (the train buffer filling, as a first epoch
does), the second finds the train images in the buffer. No card is needed;
the numbers are the host's, so the output names the host's CPU count and,
where nvidia-smi answers, the card's name and power limit.

A process imports one package, so to compare two trees run this once per
tree in one call, in turns (A, B, B, A), with the same --data, for example
with the parent commit unpacked by `git archive` under the gitignored
`_archive/`. Prints one JSON object last, and writes it to --out if given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO), help="the tree whose yololite_tpu_torch loaders are timed")
    ap.add_argument("--data", required=True, help="the dataset's directory (written here if absent)")
    ap.add_argument("--images", type=int, default=64, help="train and val images, a multiple of 4")
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 8])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import yololite_tpu_torch
    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data.dataset import DataLoader, YOLODataset, build_dataloader, build_yolo_dataset
    from yololite_tpu_torch.data.utils import check_det_dataset

    if Path(yololite_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported yololite_tpu_torch from {yololite_tpu_torch.__file__}, not from {tree}")
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "no card"
    host = f"{card}, host {os.cpu_count()} CPUs"
    root = Path(args.data)
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
    if not (root / "data.yaml").exists():
        smoke.write_val_dataset(root, shapes * (args.images // 4), seed=20, split="train")
        smoke.write_val_dataset(root, shapes * (args.images // 4), seed=15, split="val")
    data = root / "data.yaml"
    hyp = get_cfg(overrides={"data": str(data), "imgsz": 640, "batch": 16, "mode": "train"})
    dinfo = check_det_dataset(str(data))
    out = {"host": host, "tree": str(tree), "images": args.images, "train": {}, "val": {}}
    for workers in args.workers:
        loader = build_dataloader(build_yolo_dataset(hyp, dinfo["train"], 16, dinfo, mode="train"), 16, workers,
                                  shuffle=True, seed=0)
        val = DataLoader(YOLODataset(str(root / "images" / "val"), imgsz=640, batch_size=16, rect=True,
                                     data=dinfo), batch_size=16, workers=workers)
        for name, ld in (("train", loader), ("val", val)):
            rates = []
            for _ in range(2):
                t0 = time.perf_counter()
                n = sum(len(b["img"]) for b in ld)
                rates.append(n / (time.perf_counter() - t0))
            out[name][str(workers)] = rates
            print(f"{name} loader alone, workers {workers}: {rates[0]:.1f} img/s first pass, {rates[1]:.1f} second; "
                  f"{tree.name}, on {host}", flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
