#!/usr/bin/env python3
"""K3 (csrc/select_decode.cu) on the card: each route's device time, and each of its kernels' time under torch.profiler.

    python3 tools/k3_profile.py [--out FILE]

Inputs are chip_smoke.py's synthetic maps (`k3_maps`, seed 0, class logits
3 N(0, 1) - 4, conf 1e-7): predict's shape (B 32 at 640, K 512,
single-label) with fp32 NCHW-view maps and bf16 channels-last maps (the
layouts predict's fp32 and bf16 nets give); val's (B 16 at a 384x672 rect,
K 8,192, multi-label, 423,360 entries an image) with fp32 maps in both
layouts and bf16 channels-last maps (the half net's, scored in fp32); and
val's shape on the sparse scene (`k3_maps` "sparse", conf 0.001: some 2,600
entries an image pass, the rest are -1 fillers) and on the bunched one
(`k3_maps` "bunched", bf16 maps, conf 0.001: class logits near -6 on bf16's
grid, so that a key is shared by some thousand entries). For each, every route that
can take it (`select_decode_pick`: the route the shapes pick and, on long
rows, the passes route and the cluster route on the same inputs), in turns
(each route, then the routes reversed): the device time (`chip_smoke.graph_ms`:
a CUDA graph of 20 calls, replayed, the median of each turn), the route's
plan (`select_decode_plan`: kernels a call, cluster size) and the device time
of each kernel the call launched over 10 calls (torch.profiler's
key_averages), per call, largest first.

Prints one JSON object last, and writes it to --out if given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def cases():
    """name: (select_decode's arguments), as k3_numbers takes them."""
    import numpy as np
    import torch

    from chip_smoke import K3_S640, k3_maps

    rng = np.random.default_rng(0)
    rect = ((48, 84), (24, 42), (12, 21))
    s = [8, 16, 32]
    return {
        "predict fp32 NCHW B32 K512": (k3_maps(rng, 32, K3_S640, 80, torch.float32, "nchw", "random"), s, 80, 16,
                                       1e-7, 512, None, False, False, False),
        "predict bf16 NHWC B32 K512": (k3_maps(rng, 32, K3_S640, 80, torch.bfloat16, "nhwc", "random"), s, 80, 16,
                                       1e-7, 512, None, True, False, False),
        "val fp32 NHWC B16 K8192": (k3_maps(rng, 16, rect, 80, torch.float32, "nhwc", "random"), s, 80, 16, 1e-7,
                                    8192, None, False, True, False),
        "val bf16 NHWC B16 K8192": (k3_maps(rng, 16, rect, 80, torch.bfloat16, "nhwc", "random"), s, 80, 16, 1e-7,
                                    8192, None, False, True, False),
        "val fp32 NCHW B16 K8192": (k3_maps(rng, 16, rect, 80, torch.float32, "nchw", "random"), s, 80, 16, 1e-7,
                                    8192, None, False, True, False),
        "val-sparse fp32 NHWC B16 K8192": (k3_maps(rng, 16, rect, 80, torch.float32, "nhwc", "sparse"), s, 80, 16,
                                           0.001, 8192, None, False, True, False),
        "val-bunched bf16 NHWC B16 K8192": (k3_maps(rng, 16, rect, 80, torch.bfloat16, "nhwc", "bunched"), s, 80,
                                            16, 0.001, 8192, None, False, True, False),
    }


def by_kernel(fn, calls: int = 10):
    """[(kernel, device us a call, launches a call)] of fn under torch.profiler, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / calls, e.count / calls) for e in prof.key_averages() if e.device_time_total]
    return sorted(rows, key=lambda r: -r[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the JSON result here too")
    opt = ap.parse_args()
    import torch

    from chip_smoke import card_line, graph_ms
    from yololite_tpu_torch.ops import cuda_build
    from yololite_tpu_torch.ops.kernels import _select_decode_launch, select_decode_plan

    if not torch.cuda.is_available():
        print("k3_profile: no CUDA card is visible", file=sys.stderr)
        return 2
    cuda_build.build(["select_decode"])
    card = card_line()
    print(f"card: {card}", flush=True)
    result = {"card": card, "cases": {}}
    inputs = cases()
    for name, args in inputs.items():
        feats, _, nc, reg_max, _, k, _, _, ml = args[:9]
        picked = select_decode_plan(feats, nc, reg_max, k, ml)["route"]
        routes = [picked] if picked == "finish" else [
            r for r in ("cluster", "passes") if select_decode_plan(feats, nc, reg_max, k, ml, route=r)["route"]]
        fns = {r: (lambda r=r: _select_decode_launch(*args, route=r)) for r in routes}
        turns = {r: [] for r in routes}
        for r in routes + routes[::-1]:
            turns[r].append(graph_ms(fns[r]))
        entry = {}
        for r in routes:
            plan = select_decode_plan(feats, nc, reg_max, k, ml, route=r)
            kernels = by_kernel(fns[r])
            entry[plan["route"]] = {"ms": turns[r], "kernels_a_call": plan["launches"], "cluster": plan["cluster"],
                                    "by_kernel": [(key[:110], us, n) for key, us, n in kernels]}
            print(f"{name}: route {plan['route']} {' '.join(f'{t:.4f}' for t in turns[r])} ms device (graph "
                  f"replay), {plan['launches']} kernels a call"
                  + (f", clusters of {plan['cluster']} CTAs" if plan["cluster"] else ""), flush=True)
            for key, us, n in kernels:
                print(f"  {us:9.1f} us  x{n:4.1f}  {key[:110]}", flush=True)
        result["cases"][name] = entry
    text = json.dumps(result)
    if opt.out:
        Path(opt.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
