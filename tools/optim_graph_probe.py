#!/usr/bin/env python3
"""Which torch.optim forms a CUDA graph can capture on the card, and what an optimizer step costs in each.

    python3 tools/optim_graph_probe.py

For each variant, in a process of its own (a failed capture leaves the
process's CUDA state unusable): yolo11n's 255 trainable parameters in the
port's three groups (engine/optim.py group_params; weight decay 5e-4 on
the weights), a 0-d device tensor as each group's lr, random gradients from
one seed. Two identical optimizers take one eager step; one is then captured
as a CUDA graph, and graph replays are held bit for bit against eager steps
of the other. Prints per variant: captured or the error, equal or not, the
device ms of a replay and of an eager step (CUDA events, 20 steps), and the
host ms to enqueue an eager step. The variants: AdamW foreach capturable
with float betas (the port's form on the card), AdamW single-tensor
capturable with a device betas[0], AdamW foreach capturable with device
betas, SGD fused with a tensor lr (the port's form), SGD foreach with a
tensor lr, RMSprop, NAdam, RAdam and Adamax foreach capturable.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

VARIANTS = ("adamw_foreach_float_betas", "adamw_single_tensor_beta1", "adamw_foreach_tensor_betas", "sgd_fused",
            "sgd_foreach_tensor_lr", "rmsprop", "nadam", "radam", "adamax")


def build(variant: str):
    import torch

    from yololite_tpu_torch.engine.optim import group_params
    from yololite_tpu_torch.models.model import DetectionModel

    m = DetectionModel("yolo11n.yaml").init(0).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for p in m.parameters():
        p.grad = torch.randn(p.shape, device="cuda", generator=gen) * 1e-2
    T = lambda v: torch.full((), v, dtype=torch.float32, device="cuda")
    groups = [{"params": g, "lr": T(1e-3), "weight_decay": wd} for g, wd in zip(group_params(m), (0.0, 5e-4, 0.0))]
    O = torch.optim
    if variant == "adamw_foreach_float_betas":
        opt = O.AdamW(groups, betas=(0.9, 0.999), capturable=True, foreach=True)
    elif variant == "adamw_single_tensor_beta1":
        opt = O.AdamW(groups, betas=(0.9, 0.999), capturable=True, foreach=False)
        for g in opt.param_groups:  # the constructor takes both betas as floats or both as tensors
            g["betas"] = (T(0.9), 0.999)
    elif variant == "adamw_foreach_tensor_betas":
        opt = O.AdamW(groups, betas=(T(0.9), T(0.999)), capturable=True, foreach=True)
    elif variant == "sgd_fused":
        opt = O.SGD(groups, momentum=0.9, nesterov=True, fused=True)
    elif variant == "sgd_foreach_tensor_lr":
        opt = O.SGD(groups, momentum=0.9, nesterov=True, foreach=True)
    elif variant == "rmsprop":
        opt = O.RMSprop(groups, alpha=0.99, eps=1e-8, momentum=0.9, capturable=True, foreach=True)
    else:
        opt = {"nadam": O.NAdam, "radam": O.RAdam, "adamax": O.Adamax}[variant](groups, capturable=True, foreach=True)
    return m, opt


def run(variant: str) -> str:
    import torch

    (m, opt), (m2, opt2) = build(variant), build(variant)
    opt.step()
    opt2.step()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                opt.step()
            finally:
                graph.capture_end()
    except Exception as e:  # the probe's answer for this variant
        return f"{variant}: not captured ({type(e).__name__}: {str(e).splitlines()[0][:160]})"
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
        opt2.step()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(20):
        graph.replay()
    ev[1].record()
    for _ in range(20):
        opt2.step()
    ev[2].record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        opt2.step()
    host = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    n = sum(len(g["params"]) for g in opt.param_groups)
    return (f"{variant}: captured, {n} parameters, replay == eager step bit for bit: {equal}; device "
            f"{ev[0].elapsed_time(ev[1]) / 20:.3f} ms a replay, {ev[1].elapsed_time(ev[2]) / 20:.3f} ms an eager "
            f"step; host {host:.3f} ms to enqueue an eager step")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("optim_graph_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} on {card}", flush=True)
    for v in VARIANTS:
        out = subprocess.run([sys.executable, __file__, v], capture_output=True, text=True, timeout=300,
                             cwd=Path(__file__).resolve().parents[1])
        print(out.stdout.strip() or f"{v}: failed: {out.stderr.strip().splitlines()[-1:]}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        print(run(sys.argv[1]))
    else:
        sys.exit(main())
