#!/usr/bin/env python3
"""How exact is the port's fp32 train step? Each variant's gradients against the float64 step.

    python3 tools/train_step_precision.py [--imgsz 640] [--batch 16] [--device cuda] [--seeds 0 1 2]

yolo11n with init(seed) weights, one SGD step (accumulate 1) on the first
batch of a synthetic 64-image dataset (chip_smoke.py's phase-5 images), the
loader shuffled with seed. Variants: the trainer's own fp32 step (it makes
the batch NCHW-contiguous on the CPU, and on the card when amp is off), the
same step with the channels-last batch the trainer once fed the card, and 2
gloo ranks of half the batch each (cross-rank BN) on the
same device. Prints, for each, the four leaves whose gradient lies farthest
from the float64 step's in relative L2 (a leaf whose float64 gradient is
below 1e-5 of the largest leaf's is measured against that floor), the mean
time of 5 more steps (seed 0 only; the device synchronized around each),
and how many of the SPPF max-pools' picks (row 9, three chained 5x5 pools)
differ from the float64 step's. With --force-picks, each variant runs again
with its SPPF pools taking the float64 step's picks: if its distance then
falls to the others', a near-tie in those pools, not the fp32 sums, set it.
"""

from __future__ import annotations

import argparse
import copy
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def picked_rank_step(rank: int, world: int, device, ov, model, batch, lr, momentum, force):
    """A rank function for parallel.mesh.launch: data_parallel_step with SPPF's picks recorded (or forced to
    `force`, this rank's rows of it); returns the step's output and the picks."""
    from chip_smoke import patched_pool
    from yololite_tpu_torch.engine.trainer import data_parallel_step
    from yololite_tpu_torch.models.modules import SPPF

    per = batch["img"].shape[0] // world
    record = []
    SPPF._pool = patched_pool(record, force, slice(rank * per, (rank + 1) * per))
    out = data_parallel_step(rank, world, device, ov, model, [batch], lr, momentum)
    return out, record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--force-picks", action="store_true")
    a = ap.parse_args()

    import torch

    import chip_smoke as cs
    from chip_smoke import patched_pool
    from yololite_tpu_torch.engine import trainer as T
    from yololite_tpu_torch.engine.predictor import forward_nhwc
    from yololite_tpu_torch.models.model import DetectionModel
    from yololite_tpu_torch.models.modules import SPPF
    from yololite_tpu_torch.parallel.mesh import launch

    dev = torch.device(a.device if a.device != "cuda" else "cuda:0")
    if dev.type == "cuda":
        print(f"card: {cs.card_line()}", flush=True)
    root = Path(tempfile.mkdtemp())
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
    cs.write_val_dataset(root / "ds", shapes * 16, seed=20, split="train")
    data = cs.write_val_dataset(root / "ds", shapes * 4, seed=21, split="val")
    ov = {"data": str(data), "imgsz": a.imgsz, "batch": a.batch, "nbs": a.batch, "val": False, "save": False,
          "optimizer": "SGD", "amp": False, "project": str(root / "runs"), "name": "p", "workers": 2}
    own, own_pool = T.DetectionTrainer._forward, SPPF._pool

    def channels_last(self, images):
        return forward_nhwc(self.model, images.float() * (1.0 / 255.0))

    def one_process(model, batch, fwd, timed, force=None):
        record = []
        T.DetectionTrainer._forward, SPPF._pool = fwd, patched_pool(record, force)
        try:
            return T.data_parallel_step(0, 1, dev, ov, model, [batch], [100.0] * 3, 0.9, timed), record
        finally:
            T.DetectionTrainer._forward, SPPF._pool = own, own_pool

    for seed in a.seeds:
        batch = cs.seeded_batch(ov, data, seed)
        model = DetectionModel("yolo11n.yaml").init(seed)
        timed = 5 if seed == a.seeds[0] else 0

        tr = T.DetectionTrainer(overrides=ov, device=dev)
        tr.set_model(model)
        tr._setup_train()
        targets = tr._targets(batch)
        m64 = copy.deepcopy(tr.model).double().train()
        x64 = (torch.from_numpy(batch["img"]).double() / 255.0).to(dev)
        picks64 = []
        SPPF._pool = patched_pool(picks64)
        try:
            total, _, _ = tr.loss_fn.forward(forward_nhwc(m64, x64.permute(0, 3, 1, 2).contiguous()
                                                          .permute(0, 2, 3, 1)),
                                             {k: v.double() if v.is_floating_point() else v
                                              for k, v in targets.items()})
        finally:
            SPPF._pool = own_pool
        total.backward()
        g64 = {k: p.grad.detach().cpu() for k, p in m64.named_parameters()}
        floor = 1e-5 * max(float(g.norm()) for g in g64.values())

        out = {"fp32, the trainer's": one_process(model, batch, own, timed),
               "fp32, a channels-last batch": one_process(model, batch, channels_last, timed)}
        args = (ov, model, batch, [100.0] * 3, 0.9)
        out["fp32, 2 gloo ranks"] = launch(picked_rank_step, [str(dev)] * 2, "gloo", args=(*args, None))[0]
        if a.force_picks:
            out["fp32, the trainer's, float64's picks"] = one_process(model, batch, own, 0, picks64)
            out["fp32, a channels-last batch, float64's picks"] = one_process(model, batch, channels_last, 0,
                                                                              picks64)
            out["fp32, 2 gloo ranks, float64's picks"] = launch(picked_rank_step, [str(dev)] * 2, "gloo",
                                                                args=(*args, picks64))
            ranks = out["fp32, 2 gloo ranks, float64's picks"]
            out["fp32, 2 gloo ranks, float64's picks"] = (ranks[0][0], [])
        for name, (o, picks) in out.items():
            ref = [r[: len(p)] for r, p in zip(picks64, picks)]  # the ranks record rank 0's rows only
            flips = sum(int((p != r).sum()) for p, r in zip(picks, ref)) if picks else None
            errs = sorted(((float((o["grads"][k].double() - g).norm()) / max(float(g.norm()), floor), k)
                           for k, g in g64.items()), reverse=True)[:4]
            step = f"; step {o['step_s'] * 1e3:.2f} ms" if "step_s" in o else ""
            what = "not recorded (forced)" if flips is None else f"{flips} of {sum(p.numel() for p in picks)}"
            print(f"seed {seed}, {name} at {a.imgsz}, batch {a.batch}: gradient rel L2 to float64, worst "
                  f"{', '.join(f'{e:.2e} ({k})' for e, k in errs)}; SPPF picks differing from float64's: "
                  f"{what}{step}", flush=True)


if __name__ == "__main__":
    main()
