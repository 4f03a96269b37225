#!/usr/bin/env python3
"""K3 (csrc/select_decode.cu) on the card: its device time, and each of its kernels' time under torch.profiler.

    python3 tools/k3_profile.py

Inputs are chip_smoke.py's synthetic maps (`k3_maps`, seed 0, class logits
3 N(0, 1) - 4, conf 1e-7): predict's shape (B 32 at 640, K 512,
single-label) with fp32 NCHW-view maps and bf16 channels-last maps (the
layouts predict's fp32 and bf16 nets give), and val's (B 16 at a 384x672
rect, K 8,192, multi-label, fp32) in both layouts. For each, the op's
device time (`chip_smoke.graph_ms`: a CUDA graph of 20 calls, replayed,
the median), its route (`select_decode_plan`: predict's rows take the
finish route, the score pass and the finishing CTAs; val's the passes) and
the device time of each kernel the op launched over 10 calls
(torch.profiler's key_averages), per call, largest first.
"""

from __future__ import annotations

import sys
from pathlib import Path


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import K3_S640, card_line, graph_ms, k3_maps
    from yololite_tpu_torch.ops import cuda_build
    from yololite_tpu_torch.ops.kernels import select_decode, select_decode_plan

    if not torch.cuda.is_available():
        print("k3_profile: no CUDA card is visible", file=sys.stderr)
        return 2
    cuda_build.build(["select_decode"])
    print(f"card: {card_line()}", flush=True)
    rng = np.random.default_rng(0)
    rect = ((48, 84), (24, 42), (12, 21))
    cases = {  # name: (maps, conf, K, half, multi_label)
        "predict fp32 NCHW B32 K512": (k3_maps(rng, 32, K3_S640, 80, torch.float32, "nchw", "random"), 1e-7, 512,
                                       False, False),
        "predict bf16 NHWC B32 K512": (k3_maps(rng, 32, K3_S640, 80, torch.bfloat16, "nhwc", "random"), 1e-7, 512,
                                       True, False),
        "val fp32 NHWC B16 K8192": (k3_maps(rng, 16, rect, 80, torch.float32, "nhwc", "random"), 1e-7, 8192, False,
                                    True),
        "val fp32 NCHW B16 K8192": (k3_maps(rng, 16, rect, 80, torch.float32, "nchw", "random"), 1e-7, 8192, False,
                                    True),
    }
    for name, (feats, conf, k, half, ml) in cases.items():
        fn = lambda: select_decode(feats, [8, 16, 32], 80, 16, conf, k, None, half, ml, False)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        plan = select_decode_plan(feats, 80, 16, k, ml)
        print(f"{name}: {graph_ms(fn):.4f} ms device (graph replay), route {plan['route']}, {plan['launches']} "
              f"kernels a call, score pass {plan['score']}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 10, e.count / 10) for e in prof.key_averages() if e.device_time_total]
        for key, us, n in sorted(rows, key=lambda r: -r[1]):
            print(f"  {us:9.1f} us  x{n:4.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
