#!/usr/bin/env python3
"""The train step's apply on the card, of one tree: its device time, its device kernels and the warmup's enqueue.

    python3 tools/apply_timing.py [--tree DIR] [--out FILE]

Builds DIR's (default: this repository's) kernels, then, with this
repository's chip_smoke.py helpers on DIR's package, trains yolo11n at 640,
batch 16, fp32 on 64 synthetic PNGs (`chip_smoke.write_val_dataset`, init(0)
weights) through `DetectionTrainer`:
  - the apply alone (clip, optimizer, zeroing, EMA) at a fixed lr and
    momentum, after a grad step, by CUDA events around it (median of 10):
    replayed from its graph, and eagerly (`graphs.eager()`);
  - the device kernels one eager apply launches (torch.profiler);
  - 12 iterations of the warmup ramp (`_schedule(ni, 100, 0)`: lr and
    momentum move every iteration) in the unfused form (nbs 64: a grad
    graph, then the apply) and in the fused form (nbs 16: accumulate 1),
    each step's host enqueue (a sync before the step, the host clock until
    the step's calls return; a tree from before the feed of
    data/build.py uploads its batch in that time) and how each graph call ran (eager, captured or
    replayed: `chip_smoke.record_graph_calls`).
A process imports one package, so to compare two trees on one card run this
once per tree in one call, in turns (A, B, B, A), for example with the parent
commit unpacked by `git archive` under the gitignored `_archive/`. Prints the
card and one JSON object last, and writes the object to --out if given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def warmup_steps(smoke, trainer_cls, overrides: dict, model, n: int = 12) -> dict:
    """n warmup iterations of a fresh trainer on its own loader: each step's host enqueue (ms) and each graph call's
    kind and how it ran."""
    import torch

    tr = trainer_cls(overrides=overrides)
    tr.set_model(model)
    tr._setup_train()
    calls = smoke.record_graph_calls(tr)
    enqueue, last, ni = [], -1, 0
    # a tree with the feed hands the step device tensors; one before it uploads in `_train_batch`, inside the time
    fed = (lambda: (b for b, _ in tr.feed(tr.train_loader))) if hasattr(tr, "feed") else lambda: tr.train_loader
    while ni < n:
        for b in fed():
            if ni == n:
                break
            tr.accumulate, lr_vec, momentum = tr._schedule(ni, 100, 0)
            apply = tr.fused or ni - last >= tr.accumulate
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._train_batch(b, apply, lr_vec, momentum)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            last = ni if apply else last
            ni += 1
    kinds = {}
    for key, how in calls:
        kinds.setdefault(key[0], []).append(how)
    return {"enqueue_ms": enqueue, "calls": kinds, "fused": tr.fused}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO), help="the tree whose yololite_tpu_torch is built and timed")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("apply_timing: no CUDA card is visible", file=sys.stderr)
        return 2
    import yololite_tpu_torch
    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.engine.predictor import fp32_convs
    from yololite_tpu_torch.engine.trainer import DetectionTrainer
    from yololite_tpu_torch.models.model import DetectionModel
    from yololite_tpu_torch.ops import cuda_build

    if Path(yololite_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported yololite_tpu_torch from {yololite_tpu_torch.__file__}, not from {tree}")
    card = smoke.card_line()
    print(f"card: {card}; tree {tree}", flush=True)
    cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
    smoke.write_val_dataset(root / "ds", shapes * 16, seed=20, split="train")
    data = smoke.write_val_dataset(root / "ds", shapes * 4, seed=21, split="val")
    base = {"data": str(data), "imgsz": 640, "batch": 16, "val": False, "save": False, "plots": False,
            "project": str(root / "runs"), "optimizer": "AdamW", "lr0": 0.001, "amp": False}
    model = DetectionModel("yolo11n.yaml", nc=80).init(0)

    st = DetectionTrainer(overrides={**base, "name": "apply"})
    st.set_model(model)
    st._setup_train()
    batch = next(iter(st.train_loader))
    images = torch.from_numpy(batch["img"]).cuda()
    targets = st._targets(batch)
    lr = np.full(3, 1e-4, np.float32)
    with fp32_convs(images.device):
        replayed = smoke.event_ms(lambda: st._grad_step(images, targets), lambda _: st._apply_step(lr, 0.9))
        with graphs.eager():
            eager = smoke.event_ms(lambda: st._grad_step(images, targets), lambda _: st._apply_step(lr, 0.9))
            st._grad_step(images, targets)
            kernels = smoke.device_kernels(lambda: st._apply_step(lr, 0.9))
    out = {"card": card, "tree": str(tree), "apply_replayed_ms": replayed, "apply_eager_ms": eager,
           "apply_device_kernels": kernels,
           "warmup_unfused": warmup_steps(smoke, DetectionTrainer, {**base, "nbs": 64, "name": "unfused"}, model),
           "warmup_fused": warmup_steps(smoke, DetectionTrainer, {**base, "nbs": 16, "name": "fused"}, model)}
    for form in ("unfused", "fused"):
        w = out[f"warmup_{form}"]
        print(f"warmup {form} (fused {w['fused']}): host enqueue a step "
              f"{', '.join(f'{e:.1f}' for e in w['enqueue_ms'])} ms; graph calls by kind {w['calls']}", flush=True)
    print(f"apply alone (clip, optimizer, zeroing, EMA; yolo11n fp32): {replayed:.4f} ms replayed, {eager:.4f} ms "
          f"eager (CUDA events, median of 10); {kernels} device kernels eagerly, on {card}", flush=True)
    tmp.cleanup()
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
