#!/usr/bin/env python3
"""K4 (csrc/blocked_nms.cu) on the card: device time on val's inputs and on crowded scenes, against another tree's K4.

    python3 tools/k4_timing.py [--other DIR ...] [--sweep] [--phases] [--out FILE]

Inputs, each at iou 0.7 and max_det 300: val's first fp32 batch as
chip_smoke.py's val phase makes it (yolo11n init(0), the 64-image synthetic
set, rect batch 16, the K = 8,192 multi-label candidates of nms_from_feats),
and chip_smoke.py's crowded scene (`k4_scene(7, B, 8192, "crowded")`) at B 16,
8 (a mesh shard) and 1. Each library's output is held bit for bit to K4's
plain version; each is timed by device time (`chip_smoke.graph_ms`: a CUDA
graph of 20 launches, replayed 5 times, the median) in turns (others, this,
this, others reversed), beside the bound (`chip_smoke.k4_bound_ms`) and the
plain version's time. K1 at B 32 / K 512 (chip_smoke.py's crowded scene,
seed 7) is timed in the same call. --other builds each DIR's
yololite_tpu_torch/csrc/blocked_nms.cu (for example an unpacked parent
commit) with the same flags; its times are keyed by DIR's name.
--sweep times this tree's K4 at every cluster size, 1 to 16
(`blocked_nms_finalize_ex`), each with cudaOccupancyMaxActiveClusters.
--phases builds this tree's K4 again with -DK4_PHASE_CLOCKS and reports, for
image 0 of each input at the default cluster size and step, thread 0's SM
cycles (clock64) in each phase of the walk, summed over the steps, by rank:
init (start-up barrier), load, cross pass, phase A (own rows), wait at the
barrier after A, phase B (rank 0's warp), wait after B, compaction.
Prints one JSON object, and writes it to --out if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


PHASES = ("init", "load", "cross", "A", "A wait", "B", "B wait", "compact")


def build_other(src: Path, out_dir: Path, *flags: str) -> Path:
    """nvcc of a blocked_nms.cu (with its own headers) into out_dir, with the port's flags and `flags`."""
    from yololite_tpu_torch.ops import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libblocked_nms-other.so"
    log = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{log.stdout}{log.stderr}")
    return lib


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.blocked_nms_finalize.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.blocked_nms_finalize.restype = ctypes.c_int
    return lib


def launcher(lib: ctypes.CDLL, args, thr: float, max_det: int, cluster=None):
    """A function that launches lib's K4 on args into a fresh output (at a cluster size through
    blocked_nms_finalize_ex) and returns the output."""
    import torch

    shifted, boxes, vals, cls, valid = args
    b, k = valid.shape
    dev = shifted.device

    def run():
        out = torch.empty((b, max_det, 6), dtype=torch.float32, device=dev)
        ws = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in (shifted, boxes, vals, cls, valid, out, ws)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster is None:
            rc = lib.blocked_nms_finalize(*ptrs, b, k, thr, max_det, dev.index or 0, stream)
        else:
            rc = lib.blocked_nms_finalize_ex(*ptrs, b, k, thr, max_det, cluster, dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"K4 launch failed with CUDA error {rc}")
        return out

    return run


def phase_clocks(lib: ctypes.CDLL, args, thr: float, max_det: int, n_ranks: int) -> dict:
    """One launch of a -DK4_PHASE_CLOCKS build: {"steps", "cycles", rank 0's cycles by phase, "A max": the
    slowest rank's phase A}."""
    import torch

    b, k = args[4].shape
    out = torch.empty((b, max_det, 6), dtype=torch.float32, device=args[0].device)
    clocks = torch.zeros((b, k, 4), dtype=torch.float32, device=args[0].device)
    ptrs = [t.data_ptr() for t in (*args, out, clocks)]
    rc = lib.blocked_nms_finalize(*ptrs, b, k, thr, max_det, args[0].device.index or 0,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed with CUDA error {rc}")
    rows = clocks.view(-1).view(torch.int64)[:10 * n_ranks].view(n_ranks, 10).tolist()
    return {"steps": rows[0][8], "cycles": rows[0][9], **dict(zip(PHASES, rows[0][:8])),
            "A max": max(r[3] for r in rows)}


def val_inputs(root: Path):
    """K4's arguments in val's first fp32 batch, as chip_smoke.py's val phase captures them."""
    import torch

    import chip_smoke
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.data.dataset import DataLoader, YOLODataset
    from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs, inference_net
    from yololite_tpu_torch.engine.validator import VAL_MAX_CAND
    from yololite_tpu_torch.ops import nms

    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)] * 16
    chip_smoke.write_val_dataset(root / "val64", shapes, seed=15)
    model = YOLOLite("yolo11n.yaml")
    ds = YOLODataset(str(root / "val64" / "images" / "val"), imgsz=640, batch_size=16, rect=True,
                     data={"names": {i: str(i) for i in range(80)}})
    first = next(iter(DataLoader(ds, batch_size=16, workers=2)))
    net = inference_net(model.model, torch.device("cuda"), half=False)
    im = torch.from_numpy(first["img"]).cuda()
    captured = []
    real = nms.blocked_nms_finalize
    nms.blocked_nms_finalize = lambda *a: captured.append(a) or real(*a)
    try:
        with torch.inference_mode(), fp32_convs(im.device):
            feats = [f.float() for f in forward_nhwc(net, im.float() * (1.0 / 255.0))]
            nms.nms_from_feats(feats, model.model.strides, model.model.nc, model.model.reg_max, conf_thres=1e-7,
                               iou_thres=0.7, max_det=300, max_cand=VAL_MAX_CAND, multi_label=True)
    finally:
        nms.blocked_nms_finalize = real
    a = captured[0]
    return tuple(t.clone() for t in a[:5]), a[5], a[6]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="+", default=[],
                    help="other trees whose csrc/blocked_nms.cu is timed beside this one's")
    ap.add_argument("--sweep", action="store_true", help="time this tree's K4 at every cluster size")
    ap.add_argument("--phases", action="store_true", help="SM cycles by phase of the walk (-DK4_PHASE_CLOCKS)")
    ap.add_argument("--out", type=Path, help="also write the JSON object to this file")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_timing: no CUDA card is visible", file=sys.stderr)
        return 2
    import chip_smoke
    from yololite_tpu_torch.ops import cuda_build
    from yololite_tpu_torch.ops.kernels import _blocked_lib, blocked_nms_plan, greedy_nms_keep, greedy_nms_keep_plain

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    libs = {"this": bind(cuda_build.build(["blocked_nms", "greedy_nms_keep"])["blocked_nms"])}
    others = {d.name: bind(build_other(d / "yololite_tpu_torch" / "csrc" / "blocked_nms.cu", Path(tmp.name) / d.name))
              for d in opt.other}
    libs = {**others, **libs}
    if opt.phases:
        clocked = bind(build_other(cuda_build.CSRC / "blocked_nms.cu", Path(tmp.name) / "clocks", "-DK4_PHASE_CLOCKS"))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    report = cuda_build.library_path("blocked_nms").with_suffix(".log")
    print("ptxas (this tree's K4): " + " | ".join(ln.strip() for ln in report.read_text().splitlines() if ln.strip()))

    inputs = {"val's fp32 inputs": val_inputs(Path(tmp.name))}
    for b in (16, 8, 1):
        inputs[f"crowded B{b}"] = (chip_smoke.k4_scene(7, b, 8192, "crowded"), 0.7, 300)
    result = {"card": card, "inputs": {}}
    for what, (args, thr, max_det) in inputs.items():
        want = chip_smoke.k4_plain(*args, thr, max_det)
        runs = {name: launcher(lib, args, thr, max_det) for name, lib in libs.items()}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not chip_smoke.same_bits(got, want):
                raise AssertionError(f"{name}'s K4 differs from the plain version on {what}")
        order = [*others, "this", "this", *reversed(others)] if others else ["this", "this"]
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(chip_smoke.graph_ms(runs[name]))
        bound, bound_by = chip_smoke.k4_bound_ms(args[0], args[2], args[4], thr, max_det)
        plain = chip_smoke.cuda_ms(lambda: chip_smoke.k4_plain(*args, thr, max_det), 5, warmup=1)
        b, k = args[4].shape
        row = {"shape": [b, k, max_det], "rows_out": int((want[..., 4] > 0).sum()), "ms": times,
               "bound_ms": bound, "bound_by": bound_by, "plain_ms": plain}
        if hasattr(libs["this"], "blocked_nms_plan"):
            row["plan"] = blocked_nms_plan(b, k)
        if opt.sweep and hasattr(libs["this"], "blocked_nms_finalize_ex"):
            row["sweep"] = {}
            for cluster in range(1, 17):
                run = launcher(_blocked_lib(), args, thr, max_det, cluster)
                if not chip_smoke.same_bits(run(), want):
                    raise AssertionError(f"K4 at cluster {cluster} differs on {what}")
                active = blocked_nms_plan(b, k, cluster=cluster)["max_active_clusters"]
                row["sweep"][f"C{cluster}"] = [chip_smoke.graph_ms(run), active]
        if opt.phases:
            row["phases"] = phase_clocks(clocked, args, thr, max_det, row["plan"]["cluster"])
        result["inputs"][what] = row
        print(f"K4 {what} {row['shape']}: " + ", ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
                                                       for n, ts in times.items()) +
              f"; bound {bound:.5f} ms ({bound_by}); plain {plain:.3f} ms; {row['rows_out']} rows out"
              + (f"; plan {json.dumps(row['plan'])}" if "plan" in row else "")
              + (f"; sweep [ms, max active clusters] {json.dumps(row['sweep'])}" if "sweep" in row else "")
              + (f"; SM cycles by phase (image 0, rank 0) {json.dumps(row['phases'])}" if "phases" in row else "")
              + f", on {card}", flush=True)

    boxes, valid = chip_smoke.scenes(32, 512, seed=7, chain=False)
    if not torch.equal(greedy_nms_keep(boxes, valid, 0.45), greedy_nms_keep_plain(boxes, valid, 0.45)):
        raise AssertionError("K1 differs from its plain version at B 32 / K 512")
    k1 = [chip_smoke.graph_ms(lambda: greedy_nms_keep(boxes, valid, 0.45)) for _ in range(2)]
    result["k1_b32_k512_ms"] = k1
    print(f"K1 B=32 K=512 (crowded scene, thr 0.45): {' '.join(f'{t:.4f}' for t in k1)} ms, on {card}")
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
