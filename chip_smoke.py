#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yololite_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. build: compiles every kernel source in yololite_tpu_torch/csrc/ with
     nvcc, all at once, and prints the build time and ptxas's report;
  2. kernel: holds each kernel against its plain PyTorch version on the card
     (bit-equal keep masks for greedy_nms_keep, boxes in, over crowded random
     scenes and alternating suppression chains, ragged K and K = 1024
     included) and times both;
  3. slice: YOLOLite("yolo11n.yaml") with init(0) predicts synthetic 480x640
     uint8 batches at imgsz 640 and conf 1e-7, in fp32 (TF32 off) and bf16, at
     batch 1 and 32; checks shapes, finiteness, that the kernel ran, that the
     kernel and the plain keep give the same detections on each batch's Detect
     maps, times letterbox, forward and nms_from_feats each alone on that
     batch, and checks that the card agrees with the CPU on a small input; on
     the exact keep's recorded fp32 inputs, checks that one call of it
     launches the kernel once and allocates nothing but the keep mask.
Prints the card's name and power limit, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, an FMA counted as 2 ops
IOU_OPS = 14  # fp32 ops of one IoU test: 4 min/max, 2 sub, 2 clamp, 1 mul, 2 add/sub, 1 add of eps, 1 div, 1 compare
AREA_OPS = 3  # fp32 ops of one box's area: 2 sub, 1 mul


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def keep_bound_ms(kept, k: int, b: int):
    """Least time for the keep mask from boxes on these inputs, and what bounds it ("bytes" or "operations").

    Bytes: 16 of boxes and 1 of valid read, 1 of keep written, per candidate.
    Operations: only a kept row suppresses, so the data needs the IoU of each
    kept row's pairs right of the diagonal (IOU_OPS each) and every box's
    area once (AREA_OPS). The formula has no FMA, so at one op per fp32
    instruction the card's rate is half of FP32_OPS_PER_S and this bound is
    about 2x low.
    """
    kept_i = kept.nonzero()[:, 1]
    pairs = float((k - 1 - kept_i).sum().item())
    by_bytes = b * k * (16 + 1 + 1) / HBM_BYTES_PER_S
    by_ops = (pairs * IOU_OPS + b * k * AREA_OPS) / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def scenes(b: int, k: int, seed: int, chain: bool):
    """Boxes (B, K, 4) and valid (B, K) on the card: crowded random boxes, or alternating chains."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if chain:  # box i overlaps i+1 (IoU 9/17) and i+2 only a little (5/21): keeps alternate
        x = np.arange(k, dtype=np.float32) * 4.0
        boxes = np.stack([x, np.zeros(k), x + 13.0, np.full(k, 10.0)], 1).astype(np.float32)
        boxes = np.broadcast_to(boxes, (b, k, 4)).copy()
        valid = rng.uniform(size=(b, k)) > 0.05  # holes flip the parity after them
    else:
        c = rng.uniform(20, 600, (b, k, 2))
        wh = rng.uniform(10, 120, (b, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        valid = rng.uniform(size=(b, k)) > 0.1
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def match_sets(a, b, box_tol=0.05, score_rtol=1e-3) -> int:
    """Rows of a (N, 6) with an unused partner in b: same class, box within box_tol px, score within rtol."""
    import numpy as np

    used = np.zeros(len(b), bool)
    n = 0
    for row in a:
        ok = (b[:, 5] == row[5]) & ~used & (np.abs(b[:, :4] - row[:4]).max(1) < box_tol) & (
            np.abs(b[:, 4] - row[4]) <= score_rtol * abs(row[4]))
        hit = np.flatnonzero(ok)
        if len(hit):
            used[hit[0]] = True
            n += 1
    return n


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this script runs only on the card", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import yololite_tpu_torch

    if Path(yololite_tpu_torch.__file__).resolve().parents[1] != repo:
        raise RuntimeError(f"imported yololite_tpu_torch from {yololite_tpu_torch.__file__}, not from {repo}")
    if any(m.split(".")[0] in ("jax", "yololite_tpu") for m in sys.modules):
        raise RuntimeError("the port imported jax or yololite_tpu")
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.ops import cuda_build, nms
    from yololite_tpu_torch.ops.kernels import greedy_nms_keep, greedy_nms_keep_plain

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build ----
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = cuda_build.build(sources)
    log(f"build: {len(sources)} kernel source(s) {sources} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        report = path.with_suffix(".log")
        if report.exists():
            log(f"  {name}: {' | '.join(line.strip() for line in report.read_text().splitlines() if line.strip())}")

    # ---- 2. kernel: greedy_nms_keep against its plain version ----
    ks, bs_ = (1, 63, 64, 65, 128, 256, 300, 512, 1024), (1, 16, 128)
    checks = 0
    for chain in (False, True):
        for k in ks:
            for b in bs_:
                boxes, valid = scenes(b, k, seed=k * 1000 + b, chain=chain)
                for thr in (0.45, 0.7) if not chain else (0.4,):
                    got = greedy_nms_keep(boxes, valid, thr)
                    want = greedy_nms_keep_plain(boxes, valid, thr)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"greedy_nms_keep != plain at B={b} K={k} thr={thr} chain={chain}: "
                                             f"{int((got != want).sum())} entries differ")
                    checks += 1
    log(f"kernel: greedy_nms_keep bit-equal to its plain version in {checks} checks: every K in {ks} x B in {bs_}, "
        "crowded scenes (thr 0.45, 0.7) and alternating chains (thr 0.4)")
    for b, k in ((32, 512), (1, 512), (16, 512), (128, 300), (32, 1024)):
        boxes, valid = scenes(b, k, seed=7, chain=False)
        bound, bound_by = keep_bound_ms(greedy_nms_keep_plain(boxes, valid, 0.45), k, b)
        ms = cuda_ms(lambda: greedy_nms_keep(boxes, valid, 0.45), 100)
        plain = cuda_ms(lambda: greedy_nms_keep_plain(boxes, valid, 0.45), 10)
        log(f"kernel: greedy_nms_keep B={b} K={k} (crowded scene): {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bound:.5f} ms ({bound_by}), on {card}")

    # ---- 3. slice: yolo11n predict at 640 through the facade ----
    from yololite_tpu_torch.engine.predictor import fp32_convs
    from yololite_tpu_torch.ops.kernels import device_letterbox

    model = YOLOLite("yolo11n.yaml")  # init(0) on the card
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
    main_inputs = {}  # (half, batch) -> the first boxes, valid and threshold the main path gave the exact keep
    exact_keep = nms._exact_keep

    def recording_keep(boxes, valid, thr):  # records the exact keep's inputs once per configuration, then runs it
        if config not in main_inputs:
            main_inputs[config] = (boxes.clone(), valid.clone(), thr)
        return exact_keep(boxes, valid, thr)

    launches = 0
    for half in (False, True):
        for bs in (1, 32):
            config = (half, bs)
            src = frames[:bs]
            kw = dict(conf=1e-7, imgsz=640, batch=bs, half=half, save=False, verbose=False)
            model.predict(src, **kw)  # set up and warm up this configuration
            greedy_nms_keep.launches = 0
            nms._exact_keep = recording_keep
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reps = 5
                for _ in range(reps):
                    results = model.predict(src, **kw)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / reps
            finally:
                nms._exact_keep = exact_keep
            n = greedy_nms_keep.launches
            if n != reps:  # one exact keep of K = 512 per predict call
                raise AssertionError(f"greedy_nms_keep launched {n} times in {reps} predict calls")
            launches += n
            if len(results) != bs:
                raise AssertionError(f"{len(results)} results for {bs} images")
            for r in results:
                d = r.boxes.data
                if d.ndim != 2 or d.shape[1] != 6 or not len(d) or not np.isfinite(d).all():
                    raise AssertionError(f"bad detections: shape {d.shape}, finite {np.isfinite(d).all()}")
                if (d[:, :4] < 0).any() or (d[:, [0, 2]] > 640).any() or (d[:, [1, 3]] > 480).any():
                    raise AssertionError("boxes outside the 480x640 frame")
            dtype = "bf16" if half else "fp32"
            log(f"slice: yolo11n {dtype} batch {bs} at 640: {dt * 1e3:.2f} ms/batch, "
                f"{bs / dt:.1f} img/s, {sum(len(r) for r in results) / bs:.1f} detections/img, "
                f"{n} kernel launches in {reps} calls, on {card}")

            pred = model.predictor
            raw = torch.from_numpy(np.stack(src)).cuda().flip(-1)
            dets = pred.infer_uint8(raw, 640)
            if tuple(dets.shape) != (bs, pred.max_det, 6) or not torch.isfinite(dets).all():
                raise AssertionError(f"predict tensor {tuple(dets.shape)} not finite or not (B, max_det, 6)")
            # on this batch's Detect maps: the kernel against the plain keep inside nms_from_feats,
            # then each stage of the predict graph timed alone
            with torch.inference_mode(), fp32_convs(raw.device):
                x = device_letterbox(raw, 640, pred.dtype)
                feats = pred._forward(x)
                args = (feats, model.model.strides, model.model.nc, model.model.reg_max)
                kw_nms = dict(conf_thres=pred.conf, iou_thres=pred.iou, max_det=pred.max_det,
                              max_cand=pred.pred_max_cand, half=pred.half)
                with_kernel = nms.nms_from_feats(*args, **kw_nms)
                nms.greedy_nms_keep = greedy_nms_keep_plain
                try:
                    with_plain = nms.nms_from_feats(*args, **kw_nms)
                finally:
                    nms.greedy_nms_keep = greedy_nms_keep
                if not torch.equal(with_kernel, with_plain):
                    raise AssertionError("nms_from_feats differs between the kernel and the plain keep")
                log(f"slice: nms_from_feats through the kernel == through the plain keep "
                    f"({dtype}, batch {bs}, {int((with_kernel[..., 4] > 0).sum())} detections)")
                t_lb = cuda_ms(lambda: device_letterbox(raw, 640, pred.dtype), 10)
                t_fw = cuda_ms(lambda: pred._forward(x), 10)
                t_nms = cuda_ms(lambda: nms.nms_from_feats(*args, **kw_nms), 10)
            busy = t_lb + t_fw + t_nms
            log(f"slice: stages alone ({dtype}, batch {bs}): letterbox {t_lb:.3f} ms, forward {t_fw:.3f} ms, "
                f"nms_from_feats {t_nms:.3f} ms; their sum is {busy / (dt * 1e3):.1%} of the "
                f"{dt * 1e3:.2f} ms predict call, on {card}")

    # the card against the CPU on a small input (fp32, same weights and frames)
    small = [f[::3, ::3].copy() for f in frames[:2]]
    kw = dict(conf=1e-7, imgsz=160, batch=2, save=False, verbose=False)
    on_card = model.predict(small, **kw)
    on_cpu = YOLOLite("yolo11n.yaml", device="cpu").predict(small, **kw)
    for a, b in zip(on_cpu, on_card):
        da, db = a.boxes.data, b.boxes.data
        if len(da) != len(db) or match_sets(da, db) != len(da):
            raise AssertionError(f"card and CPU disagree at imgsz 160: {len(da)} vs {len(db)} detections, "
                                 f"{match_sets(da, db)} matched")
    log(f"slice: card == CPU on 2 images at imgsz 160 ({[len(r) for r in on_card]} detections)")

    # ---- kernels line: timed on the main path's own inputs (fp32, batch 32; batch 1 logged) ----
    for config in ((False, 1), (False, 32)):
        shifted, valid, thr = main_inputs[config]
        b, k = valid.shape
        # the exact keep alone on these inputs: one launch, and no allocation but the (B, K) keep mask
        first = greedy_nms_keep.launches
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        exact_keep(shifted, valid, thr)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        if greedy_nms_keep.launches - first != 1 or extra > -(-b * k // 512) * 512:
            raise AssertionError(f"the exact keep at B={b} K={k} made {greedy_nms_keep.launches - first} launches "
                                 f"and allocated {extra} bytes, not 1 launch and the {b * k}-byte keep mask")
        log(f"stage: _exact_keep B={b} K={k}: 1 kernel launch, {extra} bytes allocated (the keep mask)")
        boxes = shifted.float().contiguous()
        got, want = greedy_nms_keep(boxes, valid, thr), greedy_nms_keep_plain(boxes, valid, thr)
        err = float((got.int() - want.int()).abs().max().item())
        if err != 0:
            raise AssertionError(f"greedy_nms_keep differs from its plain version on the main path's inputs {config}")
        bound, bound_by = keep_bound_ms(want, k, b)
        ms = cuda_ms(lambda: greedy_nms_keep(boxes, valid, thr), 100)
        plain = cuda_ms(lambda: greedy_nms_keep_plain(boxes, valid, thr), 20)
        log(f"kernel: greedy_nms_keep B={b} K={k} (the main path's fp32 inputs, {int(want.sum())} kept): "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({bound_by}), on {card}")
    entry = {
        "name": "greedy_nms_keep",
        "route": "cuda",
        "source": "yololite_tpu_torch/csrc/greedy_nms_keep.cu",
        "replaces": "yololite_tpu/ops/pallas_kernels.py:51",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no PyTorch call computes greedy NMS
        "shape": [b, k],
    }
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
