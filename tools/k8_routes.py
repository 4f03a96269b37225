#!/usr/bin/env python3
"""K8's int8 convs on the card: this tree's design against another tree's (the parent, unpacked under _archive/).

    python3 tools/k8_routes.py --other _archive/parent [--models n m] [--batches 32 1] [--predict]
    python3 tools/k8_routes.py --other _archive/variant --pick gemm1x1 [--models n m] [--batches 32 1]

Builds the other tree's csrc/int8_conv.cu beside this tree's (nvcc, the same flags), records every quantized conv
of one int8 forward of yolo11n (init(0)) and yolo11m at 640, and times each conv through this tree's `int8_conv`
and through the other library as the other tree's wrapper called it (its copy of an input that it could not read
in place included), device time by `chip_smoke.graph_ms`, in turns: other, this, this, other (the mean of each
pair). Both outputs must equal the plain version. Prints sums by kind and writes each conv's row to
chiprun_out/k8_routes_<model>_b<batch>.tsv. With --pick (a route of `int8_conv_pick`), only the convs this tree can
run on that route, each tree's library on it (the other tree's must take a pixel pitch) and this tree's route 1
beside them, in turns: other, this, route 1, route 1, this, other; each row also gives both trees' plans of the
route (blocks an SM, A sets, whole table). With --predict, each tree runs `chip_smoke.int8_vs_bf16` (int8 and bf16
predict, graphed, in turns) at batch 32 in its own process, the trees in turns: other, this, this, other. Every line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_other(tree: Path) -> ctypes.CDLL:
    """The other tree's K8 library, built with this tree's nvcc flags into its own csrc/build; ptxas's report goes to
    chiprun_out/k8_routes_other_build.log."""
    from yololite_tpu_torch.ops import cuda_build

    src = tree / "yololite_tpu_torch" / "csrc" / "int8_conv.cu"
    out = tree / "yololite_tpu_torch" / "csrc" / "build" / "libint8_conv-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                          capture_output=True, text=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k8_routes_other_build.log").write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    pitch = re.search(r'extern "C" int int8_conv\([^)]*int cin, int pitch', src.read_text()) is not None
    n_int = 15 if pitch else 14
    conv_args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                                                                  ctypes.c_int, ctypes.c_void_p]
    lib.int8_conv.argtypes = conv_args
    lib.int8_conv.restype = ctypes.c_int
    if pitch:  # the entry points of this tree's signatures
        lib.int8_conv_pick.argtypes = conv_args + [ctypes.c_int]
        lib.int8_conv_pick.restype = ctypes.c_int
        lib.int8_conv_plan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_float, ctypes.c_int,
                                                                                 ctypes.c_int,
                                                                                 ctypes.POINTER(ctypes.c_int)]
        lib.int8_conv_plan.restype = ctypes.c_int
    lib.int8_conv_table.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.int8_conv_table_bytes.restype = ctypes.c_int
    lib.takes_pitch = pitch
    lib.tables = {}
    return lib


def other_conv(lib, x, w, scale, bias, stride, pad, groups, act, sout, sin, pick="plan"):
    """One conv through the other library, as the other tree's `int8_conv` called it (`pick`: through its
    int8_conv_pick on that route)."""
    import torch

    from yololite_tpu_torch.ops.kernels import PICKS, X_TYPES, _conv_out_hw, x_pitch

    pitch = x_pitch(x)
    if pitch is None or not lib.takes_pitch and pitch != x.shape[1]:
        x = x.contiguous(memory_format=torch.channels_last)  # the other wrapper's copy
        pitch = x.shape[1]
    b, cin, h, wd = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = _conv_out_hw(h, wd, kh, kw, stride, pad)
    out = torch.empty((b, cout, ho, wo), dtype=torch.int8 if sout > 0 else torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    stream = torch.cuda.current_stream().cuda_stream
    table = None
    if sout > 0:
        key = (act, float(sout))
        if key not in lib.tables:
            t = torch.zeros(lib.int8_conv_table_bytes(), dtype=torch.uint8, device=x.device)
            assert lib.int8_conv_table(t.data_ptr(), act, sout, x.device.index, stream) == 0
            lib.tables[key] = t
        table = lib.tables[key].data_ptr()
    dims = (b, h, wd, cin, pitch) if lib.takes_pitch else (b, h, wd, cin)
    args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), *dims, ho, wo, cout, kh,
            kw, stride, pad, groups, act, X_TYPES[x.dtype], float(sout), float(sin), table, x.device.index, stream)
    rc = lib.int8_conv(*args) if pick == "plan" else lib.int8_conv_pick(*args, PICKS[pick])
    if rc != 0:
        raise RuntimeError(f"the other tree's int8_conv failed: {rc}")
    return out


def other_plan(lib, x, w, out, groups, stride, padding, pick) -> dict:
    """The other library's plan of a route (its int8_conv_plan, of this tree's signature)."""
    import torch

    from yololite_tpu_torch.ops.kernels import PICKS, X_TYPES, x_pitch

    b, cin, h, wd = x.shape
    cout, kh, kw, _ = w.shape
    plan = (ctypes.c_int * 10)()
    rc = lib.int8_conv_plan(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, cin, x_pitch(x), out.shape[2],
                            out.shape[3], cout, kh, kw, stride, padding, groups, X_TYPES[x.dtype],
                            1.0 if out.dtype == torch.int8 else 0.0, PICKS[pick], x.device.index, plan)
    if rc != 0:
        raise RuntimeError(f"the other tree's int8_conv_plan failed: {rc}")
    return {"blocks_per_sm": plan[7], "a_sets": plan[5], "whole_table": bool(plan[8])}


def plan_cols(q: dict) -> str:
    return f"{q['blocks_per_sm']}/{q['a_sets']}/{int(q['whole_table'])}"


def conv_table(card: str, lib, model_name: str, src: str, frames, n_convs: int, batch: int,
               pick: str = "plan") -> dict:
    """Every quantized conv of one int8 forward, this tree against the other, in turns; sums by kind. With a `pick`,
    the convs this tree can run on that route, both trees on it and this tree's route 1 beside them."""
    import numpy as np
    import torch

    import chip_smoke
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.models import modules as M
    from yololite_tpu_torch.ops.kernels import _int8_conv_launch, int8_conv, int8_conv_plain, int8_conv_plan, x_pitch

    model = YOLOLite(src)
    kw = dict(conf=1e-7, imgsz=640, batch=32, save=False, verbose=False, int8=True)
    for _ in range(2):
        model.predict(frames, **kw)
    calls = []
    hooks = [m.register_forward_hook(lambda mod, i, y: calls.append((mod, i[0], i[1], y)))
             for m in model.predictor.net.modules() if isinstance(m, M.QConv)]
    try:
        raw = torch.from_numpy(np.stack(frames[:batch])).cuda().flip(-1)
        with graphs.eager():
            model.predictor.infer_uint8(raw, 640)
    finally:
        for h in hooks:
            h.remove()
    assert len(calls) == n_convs, len(calls)
    sums, rows, n = {}, [], 0
    keys = ("other", "this") + (("route 1",) if pick != "plan" else ())
    with torch.inference_mode():
        for mod, x, act, y in calls:
            args = (x, mod.weight, mod.scale, mod.bias, mod.stride, mod.padding, mod.groups, act, mod.sout or 0.0,
                    mod.sin_value)
            plan = int8_conv_plan(x, mod.weight, y, mod.groups, mod.stride, mod.padding, pick=pick)
            if plan["route"] is None:
                continue
            n += 1
            want = int8_conv_plain(*args)
            fns = {"other": lambda: other_conv(lib, *args, pick=pick),
                   "this": lambda: int8_conv(*args) if pick == "plan" else _int8_conv_launch(*args, pick=pick),
                   "route 1": lambda: _int8_conv_launch(*args, pick="gemm")}
            for k in keys:
                if not torch.equal(fns[k](), want):
                    raise AssertionError(f"{model_name}: a conv of {tuple(x.shape)} differs from its plain version "
                                         f"({k})")
            times = {k: [] for k in keys}
            for k in (*keys, *keys[::-1]):
                times[k].append(chip_smoke.graph_ms(fns[k]))
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            kind = chip_smoke.conv_kind(x, mod)
            bound, _ = chip_smoke.int8_conv_bound_ms(tuple(x.shape), x.element_size(), tuple(mod.weight.shape),
                                                     tuple(y.shape), y.element_size())
            s = sums.setdefault(kind, {"n": 0, "bound": 0.0, **dict.fromkeys(keys, 0.0)})
            s["n"] += 1
            s["bound"] += bound
            for k in keys:
                s[k] += ms[k]
            row = [kind, tuple(x.shape), x.dtype, x_pitch(x), tuple(mod.weight.shape), f"s{mod.stride}", y.dtype,
                   plan["route"], *(f"{ms[k]:.4f}" for k in keys), f"{bound:.4f}"]
            if pick != "plan":
                row += [plan_cols(other_plan(lib, x, mod.weight, y, mod.groups, mod.stride, mod.padding, pick)),
                        plan_cols(plan)]
            rows.append("\t".join(str(v) for v in row))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = "" if pick == "plan" else f"_{pick}"
    head = ["kind", "x", "x dtype", "pitch", "w", "stride", "out dtype", f"route ({pick})", *(f"{k} ms" for k in keys),
            "bound ms"] + (["other plan (blocks an SM/A sets/whole table)", "this plan"] if pick != "plan" else [])
    (out / f"k8_routes_{model_name}_b{batch}{tag}.tsv").write_text("\t".join(head) + "\n" + "\n".join(rows) + "\n")
    total = {k: sum(v[k] for v in sums.values()) for k in (*keys, "bound")}
    what = f"all {n_convs} convs" if pick == "plan" else f"the {n} convs that {pick} can run, on {pick}"
    print(f"k8_routes: {model_name} batch {batch}: {what}: "
          + ", ".join(f"{k} {total[k]:.4f} ms" for k in keys)
          + f" (this x{total['other'] / total['this']:.3f} of other), bound {total['bound']:.4f} ms; by kind: "
          + "; ".join(f"{k} ({v['n']}) " + ", ".join(f"{t} {v[t]:.4f}" for t in keys) + f", bound {v['bound']:.4f}"
                      for k, v in sorted(sums.items())) + f"; on {card}", flush=True)
    return {"total": total, "by_kind": sums}


PREDICT = """
import json, os, sys
sys.path.insert(0, os.getcwd())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import numpy as np, torch
import chip_smoke
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.ops import cuda_build
cuda_build.build(["int8_conv", "greedy_nms_keep", "select_decode", "letterbox"])
card = chip_smoke.card_line()
rng = np.random.default_rng(0)
frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
pt = os.path.join(sys.argv[1], "yolo11n.pt")
torch.save({"model": DetectionModel("yolo11n.yaml").init(0), "train_args": {"imgsz": 640}, "epoch": -1}, pt)
out = {}
for name, src, n in (("yolo11n", pt, 76), ("yolo11m", "yolo11m.yaml", 101)):
    med = chip_smoke.int8_vs_bf16(card, src, frames, 32, n, name)[0]
    out[name] = {k: v * 1e3 for k, v in med.items()}
print("RESULT " + json.dumps(out), flush=True)
"""


def predict_turns(other: Path, scratch: Path) -> None:
    """int8 against bf16 predict of each tree in its own process, in turns: other, this, this, other."""
    results = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        cwd = other if tree == "other" else ROOT
        proc = subprocess.run([sys.executable, "-c", PREDICT, str(scratch)], cwd=cwd, capture_output=True, text=True,
                              timeout=900)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not line:
            raise RuntimeError(f"{tree} tree's predict run failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        results[tree].append(json.loads(line[0][7:]))
    for name in ("yolo11n", "yolo11m"):
        for tree in ("other", "this"):
            runs = results[tree]
            print(f"k8_routes: predict {name} batch 32, {tree} tree, graphed medians of turns: int8 "
                  f"{', '.join(f'{r[name]['int8']:.2f}' for r in runs)} ms, bf16 "
                  f"{', '.join(f'{r[name]['bf16']:.2f}' for r in runs)} ms, int8 x"
                  + ", ".join(f"{r[name]['bf16'] / r[name]['int8']:.3f}" for r in runs) + " of bf16", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other tree's root (the parent, unpacked)")
    ap.add_argument("--models", nargs="+", default=["n", "m"], choices=["n", "m"])
    ap.add_argument("--batches", nargs="+", type=int, default=[32, 1])
    ap.add_argument("--predict", action="store_true", help="also int8 vs bf16 predict of each tree, in turns")
    ap.add_argument("--pick", default="plan", choices=["plan", "gemm", "gemm1x1"],
                    help="time both trees on this route of int8_conv_pick, with this tree's route 1 beside them")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k8_routes: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from yololite_tpu_torch.models.model import DetectionModel
    from yololite_tpu_torch.ops import cuda_build

    cuda_build.build(["int8_conv", "greedy_nms_keep", "select_decode", "letterbox"])
    card = chip_smoke.card_line()
    other = Path(args.other).resolve()
    lib = build_other(other)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
    scratch = ROOT / "chiprun_out"
    scratch.mkdir(exist_ok=True)
    pt = scratch / "yolo11n.pt"
    torch.save({"model": DetectionModel("yolo11n.yaml").init(0), "train_args": {"imgsz": 640}, "epoch": -1}, str(pt))
    for key in args.models:
        name, src, n = ("yolo11n", str(pt), 76) if key == "n" else ("yolo11m", "yolo11m.yaml", 101)
        for batch in args.batches:
            conv_table(card, lib, name, src, frames, n, batch, args.pick)
        torch.cuda.empty_cache()
    if args.predict:
        predict_turns(other, scratch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
