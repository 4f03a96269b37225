#!/usr/bin/env python3
"""How exact is the port's fp32 train step? Each variant's gradients against the float64 step.

    python3 tools/train_step_precision.py [--imgsz 640] [--batch 16] [--device cuda]

yolo11n with init(0) weights, one SGD step (accumulate 1) on the first
seeded loader batch of a synthetic 64-image dataset (chip_smoke.py's phase-5
images). Variants: the trainer's own fp32 step (on the card the batch stays
channels-last; on the CPU the trainer makes it NCHW-contiguous), the same
step with an NCHW-contiguous batch, and 2 gloo ranks of half the batch each
(cross-rank BN) on the same device. Prints, for each, the four leaves
whose gradient lies farthest from the float64 step's in relative L2 (a leaf
whose float64 gradient is below 1e-5 of the largest leaf's is measured
against that floor), and the mean time of 5 more steps (the device
synchronized around each).
"""

from __future__ import annotations

import argparse
import copy
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    import torch

    import chip_smoke as cs
    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
    from yololite_tpu_torch.data.utils import check_det_dataset
    from yololite_tpu_torch.engine import trainer as T
    from yololite_tpu_torch.engine.predictor import forward_nhwc
    from yololite_tpu_torch.models.model import DetectionModel
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
    hyp = get_cfg(overrides={**ov, "mode": "train"})
    dinfo = check_det_dataset(str(data))
    batch = next(iter(build_dataloader(build_yolo_dataset(hyp, dinfo["train"], a.batch, dinfo, mode="train"),
                                       a.batch, 0, shuffle=True, seed=0)))
    model = DetectionModel("yolo11n.yaml").init(0)
    args = (ov, model, [batch], [100.0] * 3, 0.9, 5)

    own = T.DetectionTrainer._forward

    def nchw(self, images):
        x = (images.float() * (1.0 / 255.0)).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        return forward_nhwc(self.model, x)

    out = {"fp32, the trainer's": T.data_parallel_step(0, 1, dev, *args)}
    T.DetectionTrainer._forward = nchw
    try:
        out["fp32, an NCHW batch"] = T.data_parallel_step(0, 1, dev, *args)
    finally:
        T.DetectionTrainer._forward = own
    out["fp32, 2 gloo ranks"] = launch(T.data_parallel_step, [str(dev)] * 2, "gloo", args=args)[0]

    tr = T.DetectionTrainer(overrides=ov, device=dev)
    tr.set_model(model)
    tr._setup_train()
    targets = tr._targets(batch)
    m64 = copy.deepcopy(tr.model).double().train()
    x64 = (torch.from_numpy(batch["img"]).double() / 255.0).to(dev)
    total, _, _ = tr.loss_fn.forward(forward_nhwc(m64, x64.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)),
                                     {k: v.double() if v.is_floating_point() else v for k, v in targets.items()})
    total.backward()
    g64 = {k: p.grad.detach().cpu() for k, p in m64.named_parameters()}
    floor = 1e-5 * max(float(g.norm()) for g in g64.values())
    for name, o in out.items():
        errs = sorted(((float((o["grads"][k].double() - g).norm()) / max(float(g.norm()), floor), k)
                       for k, g in g64.items()), reverse=True)[:4]
        print(f"{name} at {a.imgsz}, batch {a.batch}: gradient rel L2 to float64, worst "
              f"{', '.join(f'{e:.2e} ({k})' for e, k in errs)}; step {o['step_s'] * 1e3:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
