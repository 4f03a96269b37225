#!/usr/bin/env python3
"""The loss-tail kernels (K5, K6a, K6b, K7, K9) on the card: ptxas's report and device times, warm and cold, of one tree.

    python3 tools/loss_tail_timing.py [--tree DIR] [--what all|tail|k9] [--out FILE]

Builds DIR's (default: this repository's) yololite_tpu_torch/csrc/dfl.cu,
bce_sum.cu, topk_rows.cu and compact_rows.cu with the port's flags, prints
ptxas's registers, stack frame and spills for each kernel of the four
(`chip_smoke.loss_tail_build_report`), then times the kernels with this
repository's chip_smoke.py on DIR's package: `loss_tail_numbers` (--what
tail or all) times every loss-tail kernel warm (a CUDA graph of 20 calls on
one input set) and cold (the calls rotating over input sets that span more
than 100 MB), beside its bound, its plain version and the library call (for
K5 a softmax then a matmul, two calls), at B 16, A 8,400, fp32 and bf16 (K7
at M 32 and 64, and at M 32 with A 2,100 and 33,600, a streamed row);
`compact_rows_numbers` (--what k9 or all) times K9's forward and backward
the same way at B 16, A 8,400, K 320 on the assigner's masks, with the
launch floor where DIR's package has it (an empty kernel on the forward's
grid), then counts the device kernels of one forward call (torch.profiler,
the first profile of the process). A process imports one package, so to
compare two trees on one card run this once per tree in one call, in turns
(A, B, B, A), for example with the parent commit unpacked by `git archive`
under the gitignored `_archive/`.
Prints the card and one JSON object last, and writes the object to --out if
given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO), help="the tree whose yololite_tpu_torch is built and timed")
    ap.add_argument("--what", default="all", choices=("all", "tail", "k9"),
                    help="time the loss tail (K5-K7), K9, or both")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("loss_tail_timing: no CUDA card is visible", file=sys.stderr)
        return 2
    import yololite_tpu_torch
    from yololite_tpu_torch.ops import cuda_build

    if Path(yololite_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported yololite_tpu_torch from {yololite_tpu_torch.__file__}, not from {tree}")
    card = smoke.card_line()
    smoke.log(f"card: {card}; tree {tree}")
    libs = cuda_build.build(["dfl", "bce_sum", "topk_rows", "compact_rows"])
    report = {name: smoke.loss_tail_build_report(libs[name]) for name in libs}
    for name, text in report.items():
        smoke.log(f"ptxas {name}: {text}")
    numbers = {}
    if args.what in ("all", "tail"):
        numbers.update(smoke.loss_tail_numbers(card))
    if args.what in ("all", "k9"):
        numbers.update(smoke.compact_rows_numbers(card))
        fg, k = smoke.compact_mask(16, 640, 32, "assigner", seed=31)
        x = smoke.compact_layout("map", 16, fg.shape[1], torch.float32, seed=32)
        numbers["compact_rows"]["kernels_a_call"] = kernels = smoke.compact_kernels_a_call(x, fg, k)
        smoke.log(f"kernel: compact_rows: {kernels} device kernel(s) a forward call (torch.profiler), on {card}")
    result = {"tree": str(tree), "card": card, "ptxas": report, "numbers": numbers}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
