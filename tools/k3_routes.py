#!/usr/bin/env python3
"""K3's two long-row routes, cluster and passes, of one tree on chip_smoke.py's scenes, on the card.

    python3 tools/k3_routes.py [--tree DIR] [--label NAME] [--scenes ID ...] [--out FILE]

The scenes are rows of this checkout's `chip_smoke.K3_CASES`, their maps made
by its `k3_args` (a seed of the scene's name), so that two trees, e.g. this
one and its parent unpacked with `git archive` under `_archive/`, are timed
on the same inputs: run one process a tree, in turns (A, B, B, A). The
kernels and wrappers are the tree's (`--tree`, default this checkout): its
`ops/kernels.py _select_decode_launch(..., route=...)`, which runs a named
route through the library's `select_decode_pick`. Each route's outputs are
held to the tree's plain version (`chip_smoke.k3_check`), then timed by
device time (`chip_smoke.graph_ms`: a CUDA graph of 20 calls replayed) in
turns, cluster, passes, passes, cluster. One JSON object a scene is printed
and appended to --out if given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCENES = ("val-fp32", "val-bf16-maps", "val-sparse", "val-bunched", "crowded-bin", "val-b72", "val-b136")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(REPO), help="the checkout whose kernels run (default: this one)")
    ap.add_argument("--label", default="this", help="the tree's name in the output")
    ap.add_argument("--scenes", nargs="+", default=list(SCENES), help="ids of chip_smoke.K3_CASES")
    ap.add_argument("--out", help="append one JSON line a scene here")
    opt = ap.parse_args()
    spec = importlib.util.spec_from_file_location("k3_scenes", REPO / "chip_smoke.py")
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)  # this checkout's scenes, whichever tree's kernels run
    sys.path.insert(0, str(Path(opt.tree).resolve()))
    import torch

    from yololite_tpu_torch.ops import cuda_build
    from yololite_tpu_torch.ops.kernels import _select_decode_launch, select_decode_plain, select_decode_plan

    if not torch.cuda.is_available():
        print("k3_routes: no CUDA card is visible", file=sys.stderr)
        return 2
    cuda_build.build(["select_decode"])
    card = scenes.card_line()
    for name in opt.scenes:
        args = scenes.k3_args(next(c for c in scenes.K3_CASES if c[0] == name))
        want = select_decode_plain(*args)
        for r in ("cluster", "passes"):
            scenes.k3_check(_select_decode_launch(*args, route=r)[0], want, f"{opt.label} {name} ({r} route)")
        ms = {"cluster": [], "passes": []}
        for r in ("cluster", "passes", "passes", "cluster"):
            ms[r].append(scenes.graph_ms(lambda: _select_decode_launch(*args, route=r)))
        plan = select_decode_plan(args[0], args[2], args[3], args[5], args[8], route="cluster")
        row = {"tree": opt.label, "scene": name, "card": card, "ms": ms, "cluster": plan["cluster"],
               "planned": select_decode_plan(args[0], args[2], args[3], args[5], args[8])["route"]}
        print(json.dumps(row), flush=True)
        if opt.out:
            with open(opt.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del args, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
