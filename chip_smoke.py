#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yololite_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. build: compiles every kernel source in yololite_tpu_torch/csrc/ with
     nvcc, all at once, and prints the build time and ptxas's report (for
     K8, K4 and the loss tail's dfl, bce_sum, topk_rows and compact_rows:
     registers, stack frame and spills per kernel; for K8 the count of
     warpgroup MMA instructions in its SASS, which must not be 0);
  2. kernel: holds each kernel against its plain PyTorch version on the card
     (bit-equal keep masks for greedy_nms_keep, boxes in, over crowded random
     scenes and alternating suppression chains, ragged K and K = 1024
     included; blocked_nms_finalize (K4) bit-equal, NaN rows included, on
     crowded, spread, first-block-only, all-invalid, NaN, disjoint (max_det
     reached on a step's last candidate) and near-threshold (IoUs within a
     few ulps of it) scenes at B up to 40 and K 1,025 to 8,192, max_det 1, 300
     and K) and times both, K4 on the crowded scene at B 16, 8 and 1 with its
     bound, cluster size, step and cudaOccupancyMaxActiveClusters; select_decode
     (K3) against its plain version on the 36 scenes of K3_CASES (vals, bidx,
     cls, valid bit for bit, boxes within 1e-6 relative: K = 1 to 20,000,
     K >= N, K = N, all gated out, all equal, the K-th score in a bin of ties,
     a threshold that is not a bf16 value, class masks, NaN maps, NCHW views
     and channels-last maps, B 1 to 136, rows of 16,384 and 16,385 entries,
     fewer than K entries passing the gate, K at the cluster route's most and
     one past it, a first-digit bin more crowded than a cluster CTA's list
     holds, keys that a thousand entries share), each down the route
     K3_ROUTES names (finish: the score pass and the finishing CTAs; cluster:
     the score pass and a thread-block cluster an image; passes), and the
     other long-row route (select_decode_pick) wherever it can take the
     shapes;
     device_letterbox (K2) in 32 checks (no resize bit for bit, a resize
     within 1e-5; fp32, bf16, bgr, both layouts) and timed at B 32, 480x640
     and 720x1280 -> 640 beside its bound and F.interpolate; the loss tail:
     K5 (dfl_expectation), K6a (dfl_ce_mean), K6b (bce_sum) forward and
     backward on the (B, A, 144) maps' strided slices at (B, A) in
     LOSS_TAIL_SHAPES and LOSS_TAIL_EDGE_SHAPES (row counts off the kernels'
     tiles), fp32 and bf16, also through the layouts that take K6a's and
     K6b's scalar routes, with NaN, +-inf and -0.0 logits, and in fp64, bit
     for bit (K6b's sum within BCE_SUM_RTOL, bit for bit its terms added in
     the kernel's order, and the same on both routes), each layout down the
     route LOSS_TAIL_ROUTES names (K5's and K6a's plan, K6b's), and K7
     (topk_rows) on the metrics of TOPK_CASES (the assigner's, all-zero rows,
     more than k entries equal to the k-th, NaN, +-inf and -0.0 / 0.0 ties;
     k 1 to 32; the vector and scalar routes, every register tile and a
     streamed row), values and indices bit for bit, each down the route
     topk_rows_plan gives; each also the same bits on a second call and in a
     CUDA graph replay; K9 (compact_rows, the compact box/DFL form's
     foreground gather) forward (rows, idx, pos) and backward bit for bit on
     the assigner's masks (COMPACT_CASES: imgsz 640 with M 16-256, at B 1
     and with a ragged share of K, 320 and 1,280) and on masks with no
     foreground row, exactly K and more than K, fp32 and bf16 on the maps'
     box slice, at 640 / M 32 also on a contiguous tensor, down the scalar
     route and in fp64, a second call and a graph replay the same bits; one
     device kernel a forward call (torch.profiler); K10 (optim_apply, the
     train step's apply: clip, update, zeroing, EMA) for all 7 rules on
     yolo11n's tensors over 2 applies with lr and momentum moving and on odd
     tensors (1, 7, 13, 4,097 elements, 4 bytes off 16): every tensor bit for
     bit given its clip factor, the norm within 1e-6 of the plain version's, a
     second run the same bits; K10 timed cold and warm at yolo11n (AdamW, SGD)
     beside its bound, its plain version, torch.optim's fused AdamW and SGD
     and the parent's whole apply as a graph, with each form's device kernels
     an apply;
  3. slice: YOLOLite("yolo11n.yaml") with init(0) predicts synthetic 480x640
     uint8 batches at imgsz 640 and conf 1e-7, in fp32 (TF32 off) and bf16, at
     batch 1 and 32; each call replays a CUDA graph of the step (the first
     set-up call runs eagerly, the second captures); checks shapes,
     finiteness, that the kernel ran once a call (counted at each replay),
     that the graphed call's detections and step tensor equal the eager
     call's bit for bit, times both and the device's idle share of a graphed
     call (torch.profiler); predicts a stream of frames at 12 sizes at batch
     1 (sizes seen once stay eager, repeated ones replay) against eager, with
     the calls replayed, the graphs held (at most graphs.MAX_GRAPHS) and the
     graph pool's bytes; checks that the
     kernel and the plain keep give the same detections on each batch's
     Detect maps, times letterbox, forward (on both input layouts at batch
     32) and nms_from_feats each alone on that batch, K3 on batch 32's maps
     beside its plain version, bound and torch.topk, nms_from_feats with K3
     and with its plain version, checks that K2 and K3 launch once a call,
     and checks that the card agrees with the CPU on a small
     input; on the exact keep's recorded fp32 inputs, checks that one call
     of it launches the kernel once and allocates nothing but the keep mask;
  4. val: writes a 64-image synthetic YOLO dataset (PNGs of four shapes, so
     rect batching gives four buckets) and runs YOLOLite("yolo11n.yaml").val
     at imgsz 640, batch 16, rect, conf 1e-7, in fp32 (TF32 off) and bf16:
     checks the metrics and predictions.json; runs val through the facade
     (each bucket shape seen once: all eager), one validator three times (its
     second run captures, its third replays) and eagerly, with equal
     metrics, K4 once per batch and K1 never; reports the graphs, the share
     of calls replayed and the graph pool's reserved bytes; runs val of a
     256-image set of mixed frame sizes through the facade, graphed and
     eagerly, with the share of its batches that replay; profiles a replayed
     run; on one val
     batch checks nms_from_feats through K4 against its plain version and
     times it, with its peak memory, beside the path before K4 (the blocked keep
     with K1 and plain cross passes); times K4 on val's own inputs against
     its plain version, with its bound; checks that the card agrees with the
     CPU on 4 images at imgsz 160;
  5. train: writes 64 train and 16 val PNGs; (a) holds the train graphs to
     the eager steps in deterministic mode: 10 steps at 640, batch 16 from
     the same start, all in the warmup's ramp, AdamW fp32 and bf16 (grad and
     apply graphs) and SGD at nbs 16 (the fused graph), each key's calls from
     its third replayed: loss items,
     fg_mask, weights, BN statistics, optimizer moments and EMA bit for bit
     (or within a second eager run's spread, the op named); one step at 640,
     batch 16, fp32 and bf16, with the loss-tail kernels against the same
     step with their plain versions (`plain_loss`, K9's included): fg_mask
     equal, loss items within rtol 1e-5, every gradient bit for bit (each
     gradient's relative L2 to a .tsv file as the record), the compact
     box/DFL form's launches (K9 once a step); the compact step against the
     dense one (COMPACT_BOX_LOSS off) on the same batch: fg_mask equal, items
     within rtol 1e-5, every gradient and d loss / d maps equal in value, the
     rows K9 left out +0.0; the end2end loss's two compact heads against the
     plain versions (K9 twice); the loss's device time by op in both forms
     and the graphed step in both forms, fp32 and bf16; (b) trains
     YOLOLite("yolo11n.yaml") at imgsz 640, batch 16, 3 epochs, mosaic,
     default hyperparameters (AdamW by 'auto'), graphed in fp32 (TF32 off)
     and with amp (bf16), and eagerly in fp32: epoch-loop img/s, the step
     graphs' captures and replays (at least 10 of the 12 warmup applies
     replayed) and the pool's bytes; the fused form (nbs 16) in fp32 and bf16,
     its fused steps replayed from a key's third; (c) checks that each
     epoch's EMA val launched K4 once per batch and K1 never, replays every
     batch in its third epoch and gives the metrics of an eager val of the
     same EMA; finite loss items, last.npz, best.npz and results.csv;
     predicts from best.npz; resumes last.npz for a fourth epoch and checks
     the optimizer's restored moments; checks the kernel against the plain
     keep in one EMA val batch; holds the one-process fp32 SGD step at 640,
     batch 16 to the float64 step at 1e-3 relative L2 on every gradient, on
     three seeds (model init and loader; the trainer's NCHW batch, and the
     channels-last batch it fed the card before measured and timed beside
     it); times the epoch loop, the host
     loader alone,
     one step's stages alone (forward, loss with TAL, backward, clip +
     optimizer + EMA, the whole step graphed and eager) with its peak memory
     graphed and eager, an epoch loop's third pass taken apart (blocked on
     the feed, the hand-over, host enqueue, the card; the pass's captures
     and first sights; from a fourth pass under torch.profiler, the
     batches' copies: ms and GB/s on the card, and the share of each that
     kernels overlapped) graphed and eager, the device's idle share over 2
     epochs (torch.profiler) graphed and eager, with the host-to-device
     copies by the source memory's kind (no batch from pageable memory) and
     their overlap with kernels, and one epoch with the EMA val the same
     way; the warm graphed loop as `_train_epochs` runs it (no sync a
     step), fp32 and bf16, two passes under torch.profiler: ms a step, the
     copies by kind, their ms and their overlap with kernels; times K5, K6a and K6b forward and
     backward at B 16, A 8,400, fp32 and bf16, K7 at M 32 and 64, and K9
     forward and backward at M 32 (K 320) on the assigner's masks, each warm
     (one input set) and cold (input sets in turn, more than 100 MB), beside
     its plain version, bound and a library call (K9's forward also beside
     an empty kernel on its grid, the launch floor); checks one step on the
     card against the CPU at imgsz 160;
  6. serving: (a) writes two upstream-format .pt files from init(0) and
     init(1) models (a plain one and a 2-member nn.ModuleList ensemble),
     loads them through the stub unpickler (weights bit-equal), predicts 32
     frames at 640, batch 32, conf 1e-7 with each (graphed after two set-up
     calls), checks that K1 ran and
     that its keep equals the plain keep on the inputs an eager run gave it;
     (b) predict(int8=True) beside bf16 predict at 640, both graphed: yolo11n
     at batch 1 and, in turns (bf16, int8, int8, bf16) of 5 calls with their
     medians, at batch 32, then one eager turn of each for the record; K8
     launches 76 times a forward and no quantize runs
     outside it; K8 equal to its plain version on every output of the 76
     quantized convs of one forward at batch 32 and at batch 1, with no input
     copied (int8_conv.copies 0: the channel-split halves read in place),
     timed by device time (a CUDA graph of 20 launches replayed) through
     int8_conv, with each conv's bound and the route plan() picks, each 1x1
     conv on both routes that can run it (route 1 and gemm1x1: equal
     outputs, timed in turns), sums by kind (stem, 3x3, 1x1, depthwise)
     against their bounds, the 1x1 convs on gemm1x1 and route 1, and
     torch._int_mm on each 1x1 product as a yardstick (columns of the per-conv table
     k8_<model>_convs.tsv); the same checks at yolo11m (init(0), 101
     quantized convs);
     (c) export at 640, batch 8, fp32 and int8, reloaded and bit-equal to
     the in-process graph; (d) InferencePipeline at batch 8, 640, 32
     submissions, graphed, eagerly and graphed again: p50/p90/p99 ms, img/s,
     detections equal to the predictor's infer; (e) embed on the card
     against the CPU, rtol 1e-3.
  7. zoo: YOLOv10-N (cfg/dicts.py YOLOV10N: SCDown, PSA, C2fCIB with
     RepVGGDW, the end2end head) and GELAN-T (GELAN_T: ELAN1, AConv,
     RepNCSPELAN4, SPPELAN) at full width with init(0) weights: (a) predict
     the 32 frames at 640, conf 1e-7, in fp32 and bf16, YOLOv10-N at batch 1
     and 32 (the one2one top-k, no K1), GELAN-T at batch 32 (K1 once a call,
     nms_from_feats through K1 equal to the plain keep), with the stage
     split; (b) val of the phase-4 set at batch 16, rect (GELAN-T: K4 once
     per batch); (c) YOLOv10-N trains 1 epoch at 640, batch 16 on the
     phase-5 images, amp off and on, and predicts from last.npz; (d) an
     upstream-format .pt of YOLOv10-N loads bit-equal and predicts the same;
     (e) int8=True raises NotImplementedError without touching K8; (f) each
     model on the card against the CPU at imgsz 160: predict, val, one SGD
     step.
  8. parallel: (a) yolo11n over a mesh of two replicas on cuda:0: predict
     the 32 frames at batch 32 (two shards, K1 once in each) and the first
     31 at batch 31 (a tail that runs unsharded), each replica's step a graph
     of its own, detections equal to one device's; val of the phase-4 set at
     batch 16 (K4 once per shard), every metric within 1e-6 of one device's;
     (b) the
     data-parallel train step at 640, global batch 16: two gloo ranks on
     cuda:0 (8 rows each, cross-rank BN) against the one-process step
     (fg_mask equal, loss items 1e-4) and a float64 step on the card
     (gradients and each weight's and BN statistic's update 1e-3 relative
     L2), with both steps' times and the gradient all_reduce's; one NCCL
     rank the same way; the gradients of 2 gloo ranks against float64 again
     on two more seeds; then YOLOLite.train for 1 epoch on the phase-5
     images on two gloo ranks against one process (loss items 1e-3; rank 0's
     EMA val and final val launch K4); (c) rotated ops on the card against
     the CPU on 2,000 random OBBs: batch_probiou, nms_rotated, the rotated
     assigner at B 16, A 8,400, M 32; (d) the deformable decoder at
     RT-DETR-L's widths (d 256, 8 heads, 3 levels, 4 points, 300 queries,
     6 layers, batch 8) on the card against the CPU, relative L2 1e-4;
     rank 0 fed its batches from page-locked buffers.
  9. feed (run after phase 4): predict (batch 1, 32, and a folder of 128
     JPEG frames at batch 32), val (32 PNGs, batch 16, rect) and
     InferencePipeline (batch 8), each warm under torch.profiler: the
     host-to-device copies by the source memory's kind, failing on any
     batch copied from pageable memory; the hand-over's host ms, each
     batch's copy ms and GB/s, and the share of each batch's copy that
     kernels overlapped. Every window that counts copies begins and ends
     with a pad (`htod_profile`).
The kernels line's launches count the runs of the main paths (a replayed
graph adds the launches its capture recorded): for K5, K6a, K6b, K9 (and
their backwards), K7 and K10, phase 5 (b)'s graphed train runs in fp32 and
bf16, its fused runs and the resume, each of which must launch every one of them; predict, train's reload,
serving, the zoo's GELAN-T predict and phase 8's mesh predict for K1; val,
train's EMA vals and final vals, the zoo's GELAN-T val and phase 8's mesh val
and rank 0 for K4; the int8 predict calls (yolo11n and yolo11m) for K8; all
of K1's and K4's paths, the int8 calls and the pipeline for K3 (not the
ensembles, whose members are decoded whole); every infer_uint8 call (or
mesh shard) of those paths for K2. Phases 4-8 also check K3 once per val
batch, EMA-val batch and export run, and K2 once per uint8 predict call.
Prints the card's name and power limit, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, an FMA counted as 2 ops
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense, a multiply-add counted as 2 ops
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


def k4_scene(seed: int, b: int, k: int, case: str):
    """Score-sorted K4 inputs on the card: shifted, boxes, vals, cls, valid. Scores fall from 1 to -0.1 (the last
    rows valid with a score <= 0: kept, never emitted). case: "crowded", "spread" (the first block alone keeps
    hundreds), "first-block" (nothing valid past 1024), "invalid", "nan" (NaN coordinates in every 7th box),
    "disjoint" (no overlaps, all valid: the r-th row out is candidate r, so a max_det of 256, 512 or 1024 is reached
    on a step's last candidate), "near-threshold" (pairs whose IoU lies within a few ulps of 0.5, one class)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    c = rng.uniform(20, 6000.0 if case == "spread" else 600.0, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if case == "nan":
        boxes[:, ::7, rng.integers(0, 4)] = np.nan
    elif case == "disjoint":
        x0 = np.arange(k, dtype=np.float32) * 200.0
        boxes = np.stack([np.broadcast_to(x0, (b, k)), np.zeros((b, k)), x0 + wh[..., 0], wh[..., 1]], -1)
    elif case == "near-threshold":
        boxes = near_threshold_boxes(rng, b, k, 0.5)
    boxes = np.ascontiguousarray(boxes, np.float32)
    vals = np.broadcast_to(np.linspace(1.0, -0.1, k, dtype=np.float32), (b, k)).copy()
    cls = rng.integers(0, 3, (b, k)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.1
    if case == "first-block":
        valid[:, 1024:] = False
    elif case == "invalid":
        valid[:] = False
    elif case in ("disjoint", "near-threshold"):
        cls[:] = 0.0
        valid[:] = True
    t = lambda a: torch.from_numpy(a).cuda()
    boxes, vals, cls, valid = t(boxes), t(vals), t(cls), t(valid)
    return boxes + cls[..., None] * 7680, boxes, vals, cls, valid


K3_S640 = ((80, 80), (40, 40), (20, 20))  # yolo11's levels at 640
K3_RECT = ((48, 80), (24, 40), (12, 20))  # a rect batch's (384 x 640)
K3_TINY = ((8, 10), (4, 5), (2, 3))  # fewer entries than K
K3_CLUSTER_MAX_K = 8192  # csrc/select_decode.cu kClusterMaxK: the cluster route's most candidates an image
K3_CLUSTER_MAX_B = 66  # the most clusters of 2 CTAs an H100 holds at once: past it the shapes pick the passes route


def k3_maps(rng, b, shapes, nc, dtype, layout, scene):
    """Per-level (B, H, W, 64 + nc) maps on the card: NHWC views of NCHW tensors ("nchw", as the float nets give
    them) or NHWC-contiguous ("nhwc", channels-last nets). Scenes: "random" logits, "equal" (every class logit
    -2: all scores tie), "ties" (every class logit -2 but for one anchor in 40 with random ones: the K-th largest
    score of predict's K 512 lies in a bin of ties), "nan" (NaN class and box logits on a few anchors), "sparse"
    (class logits 3 N(0, 1) - 14.4: a share 0.0062 of the entries passes conf 0.001, some 2,500 of an image's
    403,200 at val's rect shape; the rest are -1 fillers, one key), "crowd" (class logits 0.01 N(0, 1) + 0.3: every
    score within 0.574 +- 0.01, in one first-digit bin, more than a cluster CTA's tie list holds), "bunched" (class
    logits 0.5 N(0, 1) - 6, as a net whose class biases start at -6 gives them: in bf16 maps some hundred distinct
    values above the gate, so that a key is shared by up to some thousand entries of a row)."""
    import numpy as np
    import torch

    out = []
    for h, w in shapes:
        a = rng.standard_normal((b, 64 + nc, h, w)).astype(np.float32)
        a[:, 64:] = a[:, 64:] * {"sparse": 3.0, "crowd": 0.01, "bunched": 0.5}.get(scene, 3.0) + {
            "sparse": -14.4, "crowd": 0.3, "bunched": -6.0}.get(scene, -4.0)
        if scene in ("equal", "ties"):
            keep = rng.uniform(size=(b, 1, h, w)) < (0.025 if scene == "ties" else 0.0)
            a[:, 64:] = np.where(keep, a[:, 64:], -2.0)
        elif scene == "nan":
            a[0, 64:, 1, 1] = np.nan
            a[-1, 64 + nc - 1, 2, 3] = np.nan
            a[0, 5, 3, 2] = np.nan
        t = torch.from_numpy(a).cuda().to(dtype)
        out.append(t.permute(0, 2, 3, 1) if layout == "nchw" else t.permute(0, 2, 3, 1).contiguous())
    return out


# (id, B, levels, nc, K, multi_label, map dtype, half, layout, scene, conf, class mask, agnostic)
K3_CASES = [
    ("predict-fp32", 32, K3_S640, 80, 512, False, "fp32", False, "nchw", "random", 1e-7, False, False),
    ("predict-bf16", 32, K3_S640, 80, 512, False, "bf16", True, "nchw", "random", 1e-7, False, False),
    ("predict-fp32-nhwc", 32, K3_S640, 80, 300, False, "fp32", False, "nhwc", "random", 0.25, False, False),
    ("val-fp32", 16, K3_RECT, 80, 8192, True, "fp32", False, "nhwc", "random", 1e-7, False, False),
    ("val-bf16-maps", 16, K3_RECT, 80, 8192, True, "bf16", False, "nhwc", "random", 1e-7, False, True),
    ("val-bf16-half-nchw", 16, K3_S640, 80, 8192, True, "bf16", True, "nchw", "random", 0.001, False, False),
    ("k1", 1, K3_S640, 80, 1, True, "fp32", False, "nchw", "random", 1e-7, False, False),
    ("k300-b1", 1, K3_RECT, 80, 300, False, "fp32", False, "nchw", "random", 0.01, False, False),
    ("k10000", 2, K3_S640, 80, 10_000, True, "fp32", False, "nhwc", "random", 1e-7, False, False),
    ("k20000-global-sort", 2, K3_S640, 80, 20_000, True, "bf16", True, "nchw", "random", 1e-7, False, False),
    ("k-ge-n-single", 2, K3_TINY, 5, 10**6, False, "fp32", False, "nchw", "random", 0.3, False, False),
    ("k-ge-n-multi", 2, K3_TINY, 5, 10**6, True, "fp32", False, "nhwc", "random", 0.3, False, False),
    ("all-gated", 4, K3_RECT, 80, 1000, True, "fp32", False, "nchw", "random", 1.0, False, False),
    ("all-equal-multi", 4, K3_RECT, 80, 5000, True, "fp32", False, "nchw", "equal", 0.01, False, False),
    ("all-equal-single", 4, K3_RECT, 80, 700, False, "bf16", True, "nhwc", "equal", 0.01, False, False),
    ("thr-not-bf16", 8, K3_RECT, 80, 512, False, "bf16", True, "nchw", "random", 0.0123, False, False),
    ("thr-not-bf16-multi", 8, K3_RECT, 80, 8192, True, "bf16", True, "nhwc", "random", 0.3001, False, False),
    ("class-mask", 16, K3_RECT, 80, 512, False, "fp32", False, "nchw", "random", 0.01, True, False),
    ("class-mask-multi", 16, K3_RECT, 80, 8192, True, "bf16", False, "nhwc", "random", 1e-7, True, True),
    ("nan", 4, K3_RECT, 80, 512, False, "bf16", True, "nchw", "nan", 0.01, False, False),
    ("nan-multi", 4, K3_RECT, 80, 8192, True, "fp32", False, "nhwc", "nan", 1e-7, False, False),
    ("nc1-multi", 4, K3_RECT, 1, 600, True, "fp32", False, "nchw", "random", 0.01, False, False),
    ("predict-fp32-b1", 1, K3_S640, 80, 512, False, "fp32", False, "nchw", "random", 1e-7, False, False),
    ("finish-cap", 2, ((120, 128), (30, 34), (2, 2)), 80, 512, False, "fp32", False, "nchw", "random", 1e-7, False,
     False),
    ("finish-cap-plus-1", 2, ((120, 128), (32, 32), (1, 1)), 80, 512, False, "fp32", False, "nchw", "random", 1e-7,
     False, False),
    ("ties-at-k", 4, K3_S640, 80, 512, False, "bf16", True, "nhwc", "ties", 0.01, False, False),
    ("k-eq-n", 2, K3_RECT, 80, 5040, False, "fp32", False, "nchw", "random", 1e-7, False, False),
    # fewer than K pass (some 2,500 of 403,200 an image, `k3_maps`): the -1 fillers fill the K-th entry's bin
    ("val-sparse", 16, K3_RECT, 80, 8192, True, "fp32", False, "nhwc", "sparse", 0.001, False, False),
    ("cluster-cap", 2, K3_S640, 80, K3_CLUSTER_MAX_K, True, "fp32", False, "nhwc", "random", 1e-7, False, False),
    ("cluster-cap-plus-1", 2, K3_S640, 80, K3_CLUSTER_MAX_K + 1, True, "fp32", False, "nhwc", "random", 1e-7, False,
     False),
    ("val-b64", 64, K3_RECT, 80, 8192, True, "fp32", False, "nhwc", "random", 1e-7, False, False),  # many clusters
    # past K3_CLUSTER_MAX_B: the passes route; the cluster route (select_decode_pick) in clusters of one CTA, one
    # wave at B 72, two at B 136 (an H100 holds 132 at once)
    ("val-b72", 72, K3_RECT, 80, 8192, True, "fp32", False, "nhwc", "random", 1e-7, False, False),
    ("val-b136", 136, K3_RECT, 80, 8192, True, "fp32", False, "nhwc", "random", 1e-7, False, False),
    # keys that many entries share (bf16 logits near -6): buckets of the ordering digit that a CTA sorts
    ("val-bunched", 16, K3_RECT, 80, 8192, True, "bf16", False, "nhwc", "bunched", 0.001, False, False),
    ("single-b1-1280", 1, ((160, 160), (80, 80), (40, 40)), 80, 300, False, "fp32", False, "nchw", "random", 0.01,
     False, False),
    ("crowded-bin", 2, K3_S640, 80, 8192, True, "fp32", False, "nhwc", "crowd", 1e-7, False, False),  # list overflow
]
# the route csrc/select_decode.cu takes on each scene (`select_decode_plan`): "finish" (score pass, then a
# finishing CTA group an image) where an image's row holds at most 16,384 entries, else "cluster" (score pass,
# then a thread-block cluster an image) where K is at most K3_CLUSTER_MAX_K and either the box logits lie
# channel-contiguous ("nhwc") or K is under a quarter of the anchors, and the card holds the batch's clusters in
# clusters of 2 or more CTAs at once, else "passes" (whose dense decode reads NCHW planes coalesced, and which beats
# clusters of one CTA); finish-cap's rows hold exactly 16,384 anchors, finish-cap-plus-1's one more; cluster-cap's
# K is the cluster route's most, cluster-cap-plus-1's one more


def k3_route(case) -> str:
    _, b, levels, nc, k, ml, _, _, layout = case[:9]
    a = sum(h * w for h, w in levels)
    n = a * (nc if ml and nc > 1 else 1)
    k = min(k, n)
    if n <= 16384:
        return "finish"
    return "cluster" if k <= K3_CLUSTER_MAX_K and (layout == "nhwc" or 4 * k < a) and b <= K3_CLUSTER_MAX_B else (
        "passes")


K3_ROUTES = {c[0]: k3_route(c) for c in K3_CASES}


def k3_args(case):
    """select_decode's arguments for a K3_CASES row, maps made from a seed of the case's name."""
    import numpy as np
    import torch

    _, b, levels, nc, k, ml, dtype, half, layout, scene, conf, use_mask, agnostic = case
    rng = np.random.default_rng(sum(map(ord, case[0])))
    feats = k3_maps(rng, b, levels, nc, {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype], layout, scene)
    mask = torch.from_numpy(np.arange(nc) % 3 != 1).cuda() if use_mask else None
    return (feats, [8, 16, 32], nc, 16, conf, k, mask, half, ml, agnostic)


def near_threshold_boxes(rng, b: int, k: int, thr: float):
    """(B, K, 4) float32 boxes in pairs (A, B) 256 apart: A = [x, 0, x + w, ha], B = [x, 0, x + w, hb] with hb the
    float32 of ha * thr moved by -6 to 6 ulps, so iou(A, B) = hb / ha within a few ulps of thr."""
    import numpy as np

    n = (k + 1) // 2
    x0 = np.arange(n, dtype=np.float32) * 256.0
    w = rng.uniform(10, 100, (b, n)).astype(np.float32)
    ha = rng.uniform(10, 100, (b, n)).astype(np.float32)
    hb = (ha * np.float32(thr)).astype(np.float32)
    hb = (hb.view(np.int32) + rng.integers(-6, 7, (b, n)).astype(np.int32)).view(np.float32)
    x1 = (x0 + w).astype(np.float32)
    pair = np.stack([np.stack([np.broadcast_to(x0, (b, n)), np.zeros((b, n), np.float32), x1, h], -1)
                     for h in (ha, hb)], 2)  # (B, n, 2, 4)
    return pair.reshape(b, 2 * n, 4)[:, :k]


def same_bits(a, b) -> bool:
    """Equal bit for bit (NaN rows included, which torch.equal calls unequal)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


@contextlib.contextmanager
def plain_keep():
    """ops.nms's exact keep through its plain version inside the block: no K1 launch."""
    from yololite_tpu_torch.ops import nms
    from yololite_tpu_torch.ops.kernels import greedy_nms_keep_plain

    real = nms.greedy_nms_keep
    nms.greedy_nms_keep = greedy_nms_keep_plain
    try:
        yield
    finally:
        nms.greedy_nms_keep = real


def k4_plain(*args):
    """K4's plain version (`_blocked_keep` with the plain keep inside, then `_finalize`): no kernel launches."""
    from yololite_tpu_torch.ops.kernels import blocked_nms_finalize_plain

    with plain_keep():
        return blocked_nms_finalize_plain(*args)


def k4_bound_ms(shifted, vals, valid, thr: float, max_det: int):
    """Least time for K4 on these inputs, and what bounds it ("bytes" or "operations").

    The walk needs the candidates up to its stop: the max_det-th emitted row of
    an image, else its last candidate. Bytes: 41 a candidate read up to there
    (16 + 16 of boxes, 4 + 4 of score and class, 1 of valid), 24 an output row
    written. Operations: each kept row's IoU with the later candidates up to
    the stop (IOU_OPS each) and each candidate's area (AREA_OPS); about 2x low,
    as `keep_bound_ms` says.
    """
    import torch

    from yololite_tpu_torch.ops import nms

    with plain_keep():
        keep = nms._blocked_keep(shifted, valid, thr)
    b, k = valid.shape
    done = (keep & (vals > 0)).long().cumsum(1) >= max(max_det, 1)
    stop = torch.where(done.any(1), done.float().argmax(1), k - 1)  # (B,) the last candidate the walk needs
    idx = torch.arange(k, device=valid.device)
    kept = keep & (idx[None] <= stop[:, None])
    pairs = float(((stop[:, None] - idx[None]) * kept).sum().item())
    n = float((stop + 1).sum().item())
    by_bytes = (n * 41 + b * max_det * 24) / HBM_BYTES_PER_S
    by_ops = (pairs * IOU_OPS + n * AREA_OPS) / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def k4_numbers(card: str, args, thr: float, max_det: int, what: str) -> dict:
    """K4 against its plain version on these inputs (bit for bit), both timed, with the bound."""
    import torch

    from yololite_tpu_torch.ops.kernels import blocked_nms_finalize, blocked_nms_plan

    shifted, boxes, vals, cls, valid = args
    got = blocked_nms_finalize(*args, thr, max_det)
    want = k4_plain(*args, thr, max_det)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"blocked_nms_finalize differs from its plain version on {what}: "
                             f"{int((got != want).any(-1).sum())} rows")
    err = float((got - want).abs().nan_to_num(0.0).max().item()) if got.numel() else 0.0
    bound, bound_by = k4_bound_ms(shifted, vals, valid, thr, max_det)
    ms = graph_ms(lambda: blocked_nms_finalize(*args, thr, max_det))
    launch_ms = cuda_ms(lambda: blocked_nms_finalize(*args, thr, max_det), 50)
    plain = cuda_ms(lambda: k4_plain(*args, thr, max_det), 5, warmup=1)
    b, k = valid.shape
    plan = blocked_nms_plan(b, k, shifted.device)
    log(f"kernel: blocked_nms_finalize B={b} K={k} max_det {max_det} ({what}, {int((want[..., 4] > 0).sum())} rows "
        f"out): {ms:.4f} ms device (graph replay), {launch_ms:.4f} ms a call back to back, plain {plain:.3f} ms, "
        f"bound {bound:.5f} ms ({bound_by}); cluster C {plan['cluster']} CTAs of {plan['threads']} threads an "
        f"image, step S {plan['step']}, {plan['smem']} B of shared memory a CTA, cudaOccupancyMaxActiveClusters "
        f"{plan['max_active_clusters']}, on {card}")
    return {"ms": ms, "launch_ms": launch_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "shape": [b, k, max_det], "cluster": plan["cluster"], "step": plan["step"],
            "max_active_clusters": plan["max_active_clusters"]}


K3_SCORE_OPS = 4  # fp32 ops of one gated score: exp, add, divide, compare
K3_DFL_OPS = 6  # fp32 ops per box logit of a candidate's DFL decode: max, subtract, exp, multiply, two adds


def k3_bound_ms(args, bidx):
    """Least time for K3 on these inputs, and what bounds it ("bytes" or "operations").

    Bytes: every class logit read once, the 4 * reg_max box logits of each
    distinct candidate anchor (this run's bidx) read once, and 49 bytes
    written per candidate (vals 4, bidx 8, cls 4, boxes 16, shifted 16, valid
    1). Operations: K3_SCORE_OPS per class logit, K3_DFL_OPS per candidate
    box logit, at the card's fp32 rate.
    """
    import torch

    feats, _, nc, reg_max = args[:4]
    elt = feats[0].element_size()
    b, k = bidx.shape
    n_cls = sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats) * nc
    anchors = sum(int(torch.unique(bidx[i]).numel()) for i in range(b))
    by_bytes = (n_cls * elt + anchors * 4 * reg_max * elt + b * k * 49) / HBM_BYTES_PER_S
    by_ops = (n_cls * K3_SCORE_OPS + b * k * 4 * reg_max * K3_DFL_OPS) / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def gated_row(feats, nc: int, reg_max: int, conf: float, half: bool, multi_label: bool):
    """The plain version's gated score row (B, N), which its sort (and torch.topk, the yardstick) takes."""
    import torch

    b = feats[0].shape[0]
    rows = []
    for f in feats:
        s = torch.sigmoid(f[..., 4 * reg_max:] if half else f[..., 4 * reg_max:].float())
        rows.append(s.reshape(b, -1) if multi_label and nc > 1 else s.amax(-1).reshape(b, -1))
    s = torch.cat(rows, 1)
    return torch.where(s > conf, s, -1.0)


@contextlib.contextmanager
def plain_select():
    """ops.nms's steps 1-4 through K3's plain version inside the block: no K3 launch."""
    from yololite_tpu_torch.ops import nms
    from yololite_tpu_torch.ops.kernels import select_decode, select_decode_plain

    nms.select_decode = select_decode_plain
    try:
        yield
    finally:
        nms.select_decode = select_decode


def k3_check(got, want, what: str) -> bool:
    """K3's outputs against its plain version's: vals, bidx, cls and valid bit for bit, boxes and the class-offset
    boxes within 1e-6 relative (NaN where the plain version has NaN). Returns whether the boxes are bit-equal."""
    import torch

    for name, g, w in zip(("vals", "bidx", "cls", "boxes", "shifted", "valid"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"select_decode {what}: {name} {tuple(g.shape)} {g.dtype}, plain {tuple(w.shape)} "
                                 f"{w.dtype}")
        if name in ("boxes", "shifted"):
            nan = torch.isnan(w)
            if not torch.equal(torch.isnan(g), nan) or not bool(((g - w).abs() <= 1e-6 * w.abs()).logical_or(
                    nan).all()):
                raise AssertionError(f"select_decode {what}: {name} beyond 1e-6 relative of the plain version's, "
                                     f"max |diff| {float((g - w).abs().nan_to_num(0).max())}")
        elif not same_bits(g, w):
            raise AssertionError(f"select_decode {what}: {name} differs from the plain version's in "
                                 f"{int((g != w).sum())} entries")
    return same_bits(got[3], want[3]) and same_bits(got[4], want[4])


K3_MAIN_ROUTES = {}  # K3's launches on the main paths by the route taken, summed window by window (k3_tally)
K3_EMA_ROUTES = {}  # K3's long-row routes timed on phase 5's EMA val maps, by the train's dtype (k3_route_times)


def k3_zero():
    """K3's launch count and its counts by route to 0: where a window whose launches are read starts."""
    from yololite_tpu_torch.ops.kernels import select_decode

    select_decode.launches = 0
    select_decode.by_route.reset()


def k3_tally(n: int, what: str, routes=None, less=None, only=None, add=True) -> dict:
    """A window's K3 launches by route: `routes` (default: the counts since k3_zero) less `less` (launches made in
    the window only to compare). Fails unless they sum to n, the launches the window counted, and, with `only`,
    unless every one took that route. With `add`, a main-path window's: added to K3_MAIN_ROUTES."""
    from yololite_tpu_torch.ops.kernels import select_decode

    got = dict(select_decode.by_route.as_dict() if routes is None else routes)
    got = {r: v - (less or {}).get(r, 0) for r, v in got.items()}
    if sum(got.values()) != n or min(got.values()) < 0 or (only and any(v for r, v in got.items() if r != only)):
        raise AssertionError(f"{what}: K3 launches by route {got}, where {n} were counted"
                             + (f", all on the {only} route" if only else ""))
    if add:
        for r, v in got.items():
            K3_MAIN_ROUTES[r] = K3_MAIN_ROUTES.get(r, 0) + v
    return got


def k3_list_lengths(gated, k: int):
    """Per image, the entries at or above the first 11-bit digit of the K-th largest order key: the list the
    passes route compacts after its first digit, and what a finishing kernel would have to hold."""
    import torch

    u = gated.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    keys = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))
    bins = keys >> 21
    kth = torch.topk(bins, k, dim=1).values[:, -1:]
    return [int(v) for v in (bins >= kth).sum(1)]


def k3_score_bytes(args, plan) -> int:
    """Bytes K3's score pass moves: every class logit read, a 4-byte key an entry and (single-label) a 4-byte
    class an anchor written."""
    feats, _, nc = args[:3]
    ml = args[8] and nc > 1
    a = sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats)
    return a * nc * feats[0].element_size() + a * (nc if ml else 1) * 4 + (0 if ml else a * 4)


def k3_numbers(card: str, args, what: str) -> dict:
    """K3 against its plain version on these inputs (`k3_check`), both timed by device time (a CUDA graph of 20
    calls replayed), with the bound, its route (`select_decode_plan`), its score pass alone (device time and
    bytes a second: the part of K3 that `torch.topk` does not do) and torch.topk on the gated row as a yardstick
    (its tie order is not lax.top_k's: a yardstick only); on the passes route, the lists its first digit leaves."""
    import torch

    from yololite_tpu_torch.ops.kernels import _select_decode_launch, select_decode, select_decode_plain, \
        select_decode_plan

    got = select_decode(*args)
    want = select_decode_plain(*args)
    torch.cuda.synchronize()
    bits = k3_check(got, want, what)
    err = float((got[3] - want[3]).abs().nan_to_num(0.0).max().item()) if got[3].numel() else 0.0
    bound, bound_by = k3_bound_ms(args, want[1])
    ms = graph_ms(lambda: select_decode(*args))
    plain = graph_ms(lambda: select_decode_plain(*args), iters=5, reps=3)
    feats, _, nc, reg_max, conf, max_cand, _, half, ml = args[:9]
    plan = select_decode_plan(feats, nc, reg_max, max_cand, ml)
    score_ms = graph_ms(lambda: _select_decode_launch(*args, score_only=True))
    score_bytes = k3_score_bytes(args, plan)
    gated = gated_row(feats, nc, reg_max, conf, half, ml)
    k = got[0].shape[1]
    library = graph_ms(lambda: torch.topk(gated, k))
    lists = k3_list_lengths(gated, k) if plan["route"] == "passes" else []
    b = got[0].shape[0]
    log(f"kernel: select_decode B={b} K={k} {'multi' if ml else 'single'}-label {feats[0].dtype} maps "
        f"{'(half)' if half else ''} ({what}): {ms:.4f} ms device (graph replay), route {plan['route']} "
        f"({plan['launches']} kernels a call, score pass {plan['score']}"
        + (f", {plan['reps']} finishing CTAs an image, {plan['smem']} B of shared memory each" if plan["reps"] else "")
        + f"); the score pass alone {score_ms:.4f} ms ({score_bytes / score_ms / 1e9:.3f} TB/s of {score_bytes} "
        f"bytes), the rest {ms - score_ms:.4f} ms; plain {plain:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
        f"torch.topk on the gated row (B, {gated.shape[1]}) {library:.4f} ms (yardstick)"
        + (f"; the first digit's lists {min(lists)}-{max(lists)} entries an image (a finishing CTA holds 16,384)"
           if lists else "")
        + f"; vals, bidx, cls, valid bit-equal, boxes {'bit-equal' if bits else f'max |diff| {err:.3g}'}, on {card}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
            "max_abs_err": err, "boxes_bit_equal": bits, "shape": [b, k, int(gated.shape[1])], "route": plan["route"],
            "kernels_a_call": plan["launches"], "score_ms": score_ms, "score_tb_s": score_bytes / score_ms / 1e9,
            "list_lengths": [min(lists), max(lists)] if lists else None}


K3_SORT_STEP_READS = 16  # csrc/select_decode.cu kSortStepReads: a cluster CTA's count reads a thread a sort step costs


def k3_cluster_stats(args, plan) -> dict:
    """What the cluster route's select meets on these inputs, image by image: a model of its decisions on the
    plain version's gated rows (class mask None), in the kernel's row order (class-major for NCHW planes, multi-
    label), with the plan's cluster size, tie list and slack. Counts the images whose first digit decides ("done"),
    that take the shortcut (the K-th entry's bin holds one key: fewer than K pass), that order the first digit's
    group at once ("order") or run later digits ("digits": their most, "most_digits"), those in which some CTA's
    tie list overflows (it reads its key slice again, for each later digit and to collect), and those in which a
    CTA sorts its slots (its counts over the ordering digit's buckets, the squares of their sizes, would read more
    than K3_SORT_STEP_READS a thread for each step of the sort: "sorted"), with the largest bucket ("max_bucket")."""
    import torch

    feats, _, nc, reg_max, conf, max_cand, mask, half, ml = args[:9]
    if mask is not None:
        raise ValueError("k3_cluster_stats models no class mask")
    ml = ml and nc > 1
    gated = gated_row(feats, nc, reg_max, conf, half, ml)
    b, n = gated.shape
    k = min(max_cand, n)
    u = gated.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    keys = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))
    flat = torch.arange(n, device=keys.device)
    class_major = ml and feats[0].stride(3) > feats[0].stride(2)
    if class_major:  # level by level, class by class, anchor by anchor
        order, off = [], 0
        for f in feats:
            hw = f.shape[1] * f.shape[2]
            order.append(((off + torch.arange(hw, device=keys.device))[None, :] * nc
                          + torch.arange(nc, device=keys.device)[:, None]).reshape(-1))
            off += hw
        flat = torch.cat(order)
        keys = keys[:, flat]
    ib = max((n - 1).bit_length(), 1)
    lo0 = 32 + ib - 11
    comp = (keys << ib) | (n - 1 - flat)[None, :]
    c = plan["cluster"]
    per = -(-(-(-n // c)) // 8) * 8
    cta = torch.arange(n, device=keys.device) // per
    kth = torch.topk(comp, k, dim=1).values[:, -1]
    out = dict.fromkeys(("done", "shortcut", "order", "digits", "overflow", "sorted"), 0)
    out.update(images=b, most_digits=0, max_bucket=0, cluster=c, tie_cap=plan["tie_cap"], slack=plan["slack"])
    for i in range(b):
        row, ck = comp[i], int(kth[i])
        bins = row >> lo0
        b0 = ck >> lo0
        tie = bins == b0
        need0 = k - int((bins > b0).sum())
        n_tie = int(tie.sum())
        ties_by_cta = torch.zeros(c, dtype=torch.long, device=keys.device).scatter_add_(0, cta, tie.long())
        out["overflow"] += int(bool((ties_by_cta > plan["tie_cap"]).any()))
        tie_keys = keys[i][tie]
        one_key = int(tie_keys.min()) == int(tie_keys.max())
        if n_tie == need0:
            out["done"] += 1
            lowest, member = b0 << lo0, bins >= b0
        elif one_key and not class_major:
            out["shortcut"] += 1
            member = bins > b0
            lowest = int(row[member].min()) if bool(member.any()) else None
        elif k - need0 + n_tie <= k + plan["slack"]:
            out["order"] += 1
            lowest, member = b0 << lo0, bins >= b0
        else:
            out["digits"] += 1
            hi, digits = (ib if one_key else lo0), 0
            while True:
                lo = max(hi - 11, 0)
                digits += 1
                at = row >> lo >= ck >> lo
                if int(at.sum()) <= k + plan["slack"] or lo == 0:  # (a bin that decides leaves exactly K)
                    break
                hi = lo
            out["most_digits"] = max(out["most_digits"], digits)
            lowest, member = (ck >> lo) << lo, at
        if lowest is None:
            continue
        top = int(row.max())
        span = (top ^ lowest).bit_length() if top > lowest else 0
        dlo = max(span - 11, 0)
        digit = (row[member] >> dlo) & ((1 << (span - dlo)) - 1)
        if not digit.numel():
            continue
        cnt = torch.bincount(digit, minlength=1 << (span - dlo))  # the buckets, and each one's first place
        start = cnt.flip(0).cumsum(0).flip(0) - cnt
        group, rs = int(digit.numel()), -(-int(digit.numel()) // c)
        first = []
        for q in range(c):  # CTA q's slots: from the first bucket start at or past q RS
            at = (start >= q * rs).nonzero()
            first.append(min(int(start[at[-1, 0]]), group) if at.numel() else group)
        first.append(group)
        sorts = False
        for q in range(c):
            mine = (start >= first[q]) & (start < first[q + 1]) & (cnt > 0)
            slots, p2, lg = first[q + 1] - first[q], 1, 0
            while p2 < slots:
                p2, lg = p2 * 2, lg + 1
            steps = lg * (lg + 1) // 2 * -(-(p2 // 2) // 1024)
            sorts |= int((cnt[mine] ** 2).sum()) > K3_SORT_STEP_READS * 1024 * steps
        out["max_bucket"] = max(out["max_bucket"], int(cnt.max()))
        out["sorted"] += int(sorts)
    return out


def k3_route_times(card: str, args, what: str) -> dict:
    """K3 down each of its long-row routes (cluster and passes) that can take these inputs, through
    select_decode_pick: each held to the plain version (`k3_check`), then timed by device time (a CUDA graph of
    20 calls replayed) in turns, cluster, passes, passes, cluster. Returns {route: {"ms": [two turns],
    "kernels_a_call", "cluster" (CTAs an image, 0 but for the cluster route)}}, the cluster route's with its memset
    and score pass alone ("score_ms") and what its select meets on these inputs (`k3_cluster_stats`, "select")."""
    import torch

    from yololite_tpu_torch.ops.kernels import _select_decode_launch, select_decode_plain, select_decode_plan

    feats, _, nc, reg_max, _, max_cand, _, _, ml = args[:9]
    plans = {r: select_decode_plan(feats, nc, reg_max, max_cand, ml, route=r) for r in ("cluster", "passes")}
    plans = {r: p for r, p in plans.items() if p["route"]}
    want = select_decode_plain(*args)
    for r in plans:
        k3_check(_select_decode_launch(*args, route=r)[0], want, f"{what} ({r} route)")
    torch.cuda.synchronize()
    out = {r: {"ms": [], "kernels_a_call": p["launches"], "cluster": p["cluster"]} for r, p in plans.items()}
    for r in ("cluster", "passes", "passes", "cluster"):
        if r in out:
            out[r]["ms"].append(graph_ms(lambda: _select_decode_launch(*args, route=r)))
    b, k = want[0].shape
    stats = k3_cluster_stats(args, plans["cluster"]) if "cluster" in plans else None
    if stats:
        out["cluster"]["select"] = stats
        # the memset and the score pass alone: the rest of the cluster route's time is its cluster kernel's
        out["cluster"]["score_ms"] = graph_ms(lambda: _select_decode_launch(*args, score_only=True, route="cluster"))
    log(f"kernel: select_decode B={b} K={k} ({what}) by route, in turns (select_decode_pick; both equal to the plain "
        f"version): " + "; ".join(f"{r} {' '.join(f'{t:.4f}' for t in v['ms'])} ms device ({v['kernels_a_call']} "
                                   f"kernels a call" + (f", clusters of {v['cluster']} CTAs" if v["cluster"] else "")
                                   + ")" for r, v in out.items())
        + (f"; the cluster route's memset and score pass alone {out['cluster']['score_ms']:.4f} ms; the cluster "
           f"select's images (model, `k3_cluster_stats`): {stats}" if stats else "") + f", on {card}")
    return out


def k2_bound_ms(b: int, h0: int, w0: int, s: int, out_bytes: int):
    """Least time for K2 on this batch: each input byte read once, each output element written once (the few
    operations a pixel are far under the card's rate)."""
    return (b * h0 * w0 * 3 + b * s * s * 3 * out_bytes) / HBM_BYTES_PER_S * 1e3, "bytes"


def k2_numbers(card: str, raw, s: int, dtype, channels_last: bool, bgr: bool, what: str) -> dict:
    """K2 against its plain version on this batch (the pad and a frame without a resize bit for bit, a resize
    within 1e-5, TF32 off), both timed by device time, with the bound and F.interpolate (bilinear, half-pixel
    centres) of the resize alone as a yardstick."""
    import torch
    import torch.nn.functional as F

    from yololite_tpu_torch.ops.kernels import device_letterbox, device_letterbox_plain, letterbox_geometry

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h0, w0, _ = raw.shape
    got = device_letterbox(raw, s, dtype, bgr=bgr, channels_last=channels_last)
    want32 = device_letterbox_plain(raw, s, torch.float32, bgr)
    want = want32.to(dtype)
    torch.cuda.synchronize()
    new_h, new_w, top, left = letterbox_geometry(h0, w0, s)
    pad = torch.ones((s, s), dtype=torch.bool, device=raw.device)
    pad[top:top + new_h, left:left + new_w] = False
    resize = (new_h, new_w) != (h0, w0)
    err = float((got.float() - want32).abs().max().item())
    if not same_bits(got[:, pad], want[:, pad]) or (not resize and not same_bits(got.contiguous(), want)) or (
            err > (1e-5 if dtype == torch.float32 else 2.0 ** -9 + 1e-5)):
        raise AssertionError(f"device_letterbox {what}: differs from its plain version (max |diff| {err:.3g})")
    bound, bound_by = k2_bound_ms(b, h0, w0, s, got.element_size())
    ms = graph_ms(lambda: device_letterbox(raw, s, dtype, bgr=bgr, channels_last=channels_last))
    plain = graph_ms(lambda: device_letterbox_plain(raw, s, dtype, bgr), iters=5, reps=3)
    x = raw.permute(0, 3, 1, 2).float()
    library = graph_ms(lambda: F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False))
    log(f"kernel: device_letterbox B={b} {h0}x{w0} -> {s} ({'resize' if resize else 'no resize'}, {dtype}, "
        f"{'channels-last' if channels_last else 'NCHW'} out, bgr {bgr}; {what}): {ms:.4f} ms device (graph "
        f"replay), plain {plain:.4f} ms, bound {bound:.5f} ms ({bound_by}), F.interpolate of the resize alone "
        f"{library:.4f} ms (yardstick); pad {'and all ' if not resize else ''}bit-equal, max |diff| {err:.3g}, on "
        f"{card}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
            "max_abs_err": err, "shape": [b, h0, w0, s]}


# ---------------- the loss tail: K5, K6a, K6b (each with its backward) and K7 ----------------

LOSS_TAIL_SHAPES = ((16, 8400), (16, 2100), (3, 300))  # (B, A): the train step's at 640 and at 320, a small batch
# (B, M, A, k, kind of rows; `loss_tail_metrics`): the assigner's rows at 640 and 320, one2one's k 1, A <= k; all-zero
# rows, more than k entries equal to the k-th, NaN, +-inf and -0.0 / 0.0 ties; k 32; A not a multiple of 4 (K7's
# scalar route); A 33,600 (imgsz 1280: a row longer than K7's register tiles, streamed), with GT bumps (t0 raised)
TOPK_CASES = ((16, 32, 8400, 10, "assigner"), (16, 64, 8400, 10, "assigner"), (16, 16, 8400, 13, "assigner"),
              (16, 256, 2100, 10, "assigner"), (4, 16, 8400, 1, "assigner"), (2, 16, 5, 10, "assigner"),
              (4, 16, 8400, 10, "zeros"), (4, 16, 8400, 13, "ties"), (4, 16, 8400, 10, "special"),
              (4, 16, 8400, 32, "assigner"), (4, 16, 2101, 32, "special"), (4, 16, 8399, 10, "assigner"),
              (4, 16, 8399, 13, "ties"), (2, 8, 33600, 10, "assigner"), (2, 8, 33600, 32, "special"),
              (2, 8, 1000, 32, "ties"), (4, 16, 8400, 10, "boxes"), (2, 8, 33600, 13, "boxes"))
# K6b's sum against torch's: the same fp32 terms added in another order; readings 0 to 7.8e-8 relative on an H100
# (PERF.md), and one of the 134,400 rows of (16, 8400) left out would move the sum about 7e-6
BCE_SUM_RTOL = 1e-6
STEP_TURNS = ("compact", "dense", "dense", "compact") * 2  # the graphed step's turns in `graphed_step_forms`
AUTOGRAD_STEPS = 4  # profiled grad steps a form in `loss_tail_autograd`, the forms in turns
COLD_BYTES = 100e6  # the other input sets' bytes between two visits of one set in a cold timing (`cold_sets`)
LOSS_TAIL_OPS = {"dfl_expectation": 6, "dfl_expectation_backward": 12, "dfl_ce_mean": 8, "dfl_ce_backward": 12,
                 "bce_sum": 9, "bce_sum_backward": 6}  # fp32 operations a logit (expf and log1pf counted as one)


def loss_tail_inputs(b: int, a: int, dtype, seed: int):
    """The loss's inputs at (B, A) on the card: the (B, A, 144) Detect maps in dtype (the box and class logits are
    its column slices, row stride 144), every fifth anchor's side 1 far below its other sides (the underflow
    case); targets (B, A, 4) fp32 past both clips and at R - 1 - 0.01; labels (B, A, 80) in dtype, 1% nonzero (the
    amp path's bf16 target scores); the gradients g4 (B, A, 4) and g1 (B, A, 1) fp32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dict(device="cuda", generator=gen)
    maps = torch.randn(b, a, 144, **f32) * 3
    maps[:, ::5, 16:32] -= 100.0
    tgt = torch.rand(b, a, 4, **f32) * 17 - 1
    tgt[:, ::7, 1] = 15 - 0.01
    lab = torch.rand(b, a, 80, **f32) * (torch.rand(b, a, 80, **f32) > 0.99)
    return maps.to(dtype), tgt, lab.to(dtype), torch.randn(b, a, 4, **f32), torch.randn(b, a, 1, **f32)


def loss_tail_metrics(b: int, m: int, a: int, seed: int, kind: str = "assigner"):
    """(B, M, A) fp32 align metrics. "assigner", as the assigner makes them: zero outside a GT's anchors (90%), values
    on a grid of 1/64 (ties), the last quarter of the GT rows padding (all zero); "boxes": a GT's smooth bump,
    distinct values falling off from a peak over 400 anchors each side, zero elsewhere (the largest side by side, so
    a thread of K7 holds several: on a streamed row t0 is raised); "zeros": every row zero; "ties":
    values on a grid of 1/4, so more than k entries equal the k-th; "special": normal values, half of them zero,
    -0.0 among the zeros, NaN in every seventh column, +inf and -inf in some rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(b, m, a, device="cuda", generator=gen)
    if kind == "zeros":
        return torch.zeros_like(x)
    if kind == "boxes":
        peak = torch.randint(0, a, (b, m, 1), device="cuda", generator=gen)
        d = torch.arange(a, device="cuda") - peak
        return torch.exp(-(d / 200.0) ** 2) * (d.abs() < 400)
    if kind == "ties":
        return torch.floor(x * 4) / 4
    if kind == "special":
        x = torch.randn(b, m, a, device="cuda", generator=gen) * (x > 0.5)
        x[torch.rand(b, m, a, device="cuda", generator=gen) < 0.3] = -0.0
        x[..., ::7] = float("nan")
        x[:, :m // 2, 3::11] = float("inf")
        x[:, m // 2:, 5::13] = float("-inf")
        return x
    x = torch.floor(x * 64) / 64
    x = x * (torch.rand(b, m, a, device="cuda", generator=gen) > 0.9)
    x[:, 3 * m // 4:] = 0.0
    return x


def loss_tail_pairs(maps, tgt, lab, g4, g1) -> dict:
    """Each loss-tail kernel's call and its plain version's on these inputs, by wrapper name: (kernel, plain)."""
    return loss_tail_calls(maps[..., :64], maps[..., 64:], tgt, lab, g4, g1)


def loss_tail_calls(box, cls, tgt, lab, g4, g1) -> dict:
    """`loss_tail_pairs` on box and class logits given apart (any layout the kernels read)."""
    from yololite_tpu_torch.ops import loss_kernels as L

    g0 = g1.reshape(-1)[0]
    return {
        "dfl_expectation": (lambda: L.dfl_expectation(box, 16), lambda: L.dfl_expectation_plain(box, 16)),
        "dfl_expectation_backward": (lambda: L.dfl_expectation_backward(box, g4, 16),
                                     lambda: L.dfl_expectation_backward_plain(box, g4, 16)),
        "dfl_ce_mean": (lambda: L.dfl_ce_mean(box, tgt), lambda: L.dfl_ce_plain(box, tgt)),
        "dfl_ce_backward": (lambda: L.dfl_ce_backward(box, tgt, g1), lambda: L.dfl_ce_backward_plain(box, tgt, g1)),
        "bce_sum": (lambda: L.bce_sum(cls, lab), lambda: L.bce_sum_plain(cls, lab)),
        "bce_sum_backward": (lambda: L.bce_sum_backward(cls, lab, g0), lambda: L.bce_sum_backward_plain(cls, lab, g0)),
    }


# the layouts and values the redesigned K6a and K6b are held on besides the maps' slices (`loss_tail_case`): the
# same values where 16-byte loads cannot read them (maps of row stride 146 with the box slice one column in,
# labels of row stride 81), and NaN, +-inf and -0.0 logits in both slices
LOSS_TAIL_CASES = ("aligned", "scalar", "special")
LOSS_TAIL_ROUTES = {"aligned": ("lanes", "vector"), "scalar": ("lanes-scalar", "scalar"),
                    "special": ("lanes", "vector")}  # (K5's and K6a's route, one plan; K6b's) each case must take
# rows that are no multiple of K6a's 32 rows a block nor of K6b's chunk of 1,024 pieces, and one row
LOSS_TAIL_EDGE_SHAPES = ((1, 1), (1, 1001), (7, 333))


def loss_tail_case(case: str, maps, tgt, lab, g4, g1):
    """(box, cls, tgt, lab, g4, g1) of one of LOSS_TAIL_CASES from `loss_tail_inputs`' tensors."""
    import torch

    if case == "aligned":
        return maps[..., :64], maps[..., 64:], tgt, lab, g4, g1
    if case == "scalar":
        b, a, _ = maps.shape
        wide = torch.zeros(b, a, 146, dtype=maps.dtype, device=maps.device)
        wide[..., 1:65], wide[..., 66:] = maps[..., :64], maps[..., 64:]
        lab81 = torch.zeros(b, a, 81, dtype=lab.dtype, device=lab.device)
        lab81[..., 1:] = lab
        return wide[..., 1:65], wide[..., 66:], tgt, lab81[..., 1:], g4, g1
    special = maps.clone()
    rows = special.view(-1, 144)
    rows[::13, 3] = float("nan")
    rows[::17, 20] = float("inf")
    rows[::19, 40] = float("-inf")
    rows[::23, 50:54] = -0.0
    rows[::29, 32:48] = float("-inf")  # a whole side at -inf
    rows[::31, 70] = float("nan")
    rows[::37, 90] = float("inf")
    rows[::41, 100] = float("-inf")
    rows[::43, 120:124] = -0.0
    return special[..., :64], special[..., 64:], tgt, lab, g4, g1


def bce_sum_kernel_order(logits, labels):
    """K6b's sum taken in csrc/bce_sum.cu's order in plain torch (on the card, whose elementwise ops give the
    kernel's terms): the terms in row-major order cut into `bce_sum_plan`'s pieces; thread t of chunk c adds the
    terms of its pieces c * 1024 + i * 256 + t (i < 4) in order; each warp's shuffle-down tree, the block's 8 warps
    in order, then the partials the same way on one block of 512 threads. A term past the last is 0, which adds
    nothing: a sum that starts at +0.0 is never -0.0."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    plan = L.bce_sum_plan(logits, labels)
    g, blocks = plan["piece"], plan["blocks"]
    terms = L.sigmoid_bce(logits.float(), labels.float()).reshape(-1)
    padded = torch.zeros(max(blocks, 1) * L.BCE_CHUNK * g, dtype=torch.float32, device=terms.device)
    padded[:terms.numel()] = terms
    pieces = padded.view(-1, L.BCE_CHUNK // 256, 256, g)  # (chunk, i, thread, j)
    acc = torch.zeros(pieces.shape[0], 256, dtype=torch.float32, device=terms.device)
    for i in range(pieces.shape[1]):
        for j in range(g):
            acc = acc + pieces[:, i, :, j]

    def block(acc, threads):  # the shuffle-down tree in each warp, then the warps' sums in order
        lanes = acc.view(acc.shape[0], threads // 32, 32).clone()
        for o in (16, 8, 4, 2, 1):
            lanes[..., :o] = lanes[..., :o] + lanes[..., o:2 * o]
        s = lanes[:, 0, 0]
        for w in range(1, threads // 32):
            s = s + lanes[:, w, 0]
        return s

    partials = block(acc, 256) if blocks else torch.zeros(0, dtype=torch.float32, device=terms.device)
    per = torch.zeros(-(-max(partials.numel(), 1) // 512) * 512, dtype=torch.float32, device=terms.device)
    per[:partials.numel()] = partials
    acc = torch.zeros(1, 512, dtype=torch.float32, device=terms.device)
    for i in range(per.numel() // 512):
        acc = acc + per[i * 512:(i + 1) * 512]
    return block(acc, 512)[0]


def loss_tail_check(name: str, kernel, plain, what: str) -> float:
    """One loss-tail kernel against its plain version: bit for bit (K6b's sum within BCE_SUM_RTOL, or the same bits
    where the plain sum is not finite), a second call the same bits, and a CUDA graph of the call replayed the
    same bits. Returns max |kernel - plain| over the finite entries."""
    import torch

    got, want, again = kernel(), plain(), kernel()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel()
    graph.replay()
    torch.cuda.synchronize()
    got_t, want_t = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    again_t, cap_t = (again if isinstance(again, tuple) else (again,)), (captured if isinstance(captured, tuple)
                                                                         else (captured,))
    err = 0.0
    for g, w, a, c in zip(got_t, want_t, again_t, cap_t):
        if not (same_bits(g, a) and same_bits(g, c)):
            raise AssertionError(f"{name} ({what}): a second call or a graph replay gave other bits")
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} ({what}): {tuple(g.shape)} {g.dtype}, plain {tuple(w.shape)} {w.dtype}")
        if g.is_floating_point() and g.numel():
            d = (g.double() - w.double()).abs()
            err = max(err, float(d[torch.isfinite(d)].max()) if torch.isfinite(d).any() else 0.0)
        if name == "bce_sum" and bool(torch.isfinite(w)):
            if not bool((g.double() - w.double()).abs() <= BCE_SUM_RTOL * w.double().abs()):
                raise AssertionError(f"bce_sum ({what}): {float(g)} against the plain {float(w)}, beyond "
                                     f"{BCE_SUM_RTOL} relative")
        elif not same_bits(g, w):
            raise AssertionError(f"{name} ({what}): differs from its plain version in {int((g != w).sum())} of "
                                 f"{g.numel()} entries, max |diff| {err:.3g}")
    del graph
    return err


def loss_tail_case_checks(b: int, a: int, dtype, case: str, seed: int) -> dict:
    """Every loss-tail kernel of `loss_tail_calls` on one of LOSS_TAIL_CASES at (B, A) in dtype against its plain
    version (`loss_tail_check`); K5, K6a and K6b down the routes LOSS_TAIL_ROUTES names; K6b's sum also bit for bit
    equal to `bce_sum_kernel_order` and, in the scalar case, to the aligned layout's sum (the same pieces).
    Returns {"checks", "bce_rel" (K6b's relative error, None where the sum is not finite)}."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    inputs = list(loss_tail_inputs(b, a, dtype, seed=seed))
    if dtype == torch.float64:  # the float64 reference step's labels are fp32
        inputs[2] = inputs[2].float()
    box, cls, tgt, lab, g4, g1 = loss_tail_case(case, *inputs)
    what = f"B {b}, A {a}, {str(dtype).split('.')[-1]}, {case}"
    routes = (L.dfl_plan(box)["route"], L.bce_sum_plan(cls, lab)["route"])
    if routes != LOSS_TAIL_ROUTES[case]:
        raise AssertionError(f"loss tail ({what}): K5 and K6a, and K6b take routes {routes}, not "
                             f"{LOSS_TAIL_ROUTES[case]}")
    n, rel = 0, None
    for name, (kernel, plain) in loss_tail_calls(box, cls, tgt, lab, g4, g1).items():
        err = loss_tail_check(name, kernel, plain, what)
        n += 1
        if name != "bce_sum":
            continue
        got, want = kernel(), plain()
        if not same_bits(got, bce_sum_kernel_order(cls, lab)):
            raise AssertionError(f"bce_sum ({what}): {float(got)} is not the sum taken in the kernel's order")
        if case == "scalar" and not same_bits(got, L.bce_sum(inputs[0][..., 64:], inputs[2])):
            raise AssertionError(f"bce_sum ({what}): the {routes[1]} route's sum differs from the aligned layout's")
        if bool(torch.isfinite(want)):
            rel = err / abs(float(want))
    return {"checks": n, "bce_rel": rel}


def loss_tail_checks(card: str) -> dict:
    """Every loss-tail kernel against its plain version (`loss_tail_check`): at each (B, A) of LOSS_TAIL_SHAPES and
    LOSS_TAIL_EDGE_SHAPES in fp32 and bf16 on the maps' slices (row stride 144), at (16, 2100), (7, 333) and (1, 1)
    also in the scalar route's layouts and with NaN, +-inf and -0.0 logits, in fp64 at (2, 300) and (7, 333)
    (`loss_tail_case_checks`); K7 on each case of TOPK_CASES. Returns the smallest and largest relative errors of
    K6b's finite sums and the count of checks."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    n, bce_rel = 0, []
    runs = [(b, a, dtype, "aligned") for b, a in LOSS_TAIL_SHAPES + LOSS_TAIL_EDGE_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [(b, a, dtype, case) for b, a in ((16, 2100), (7, 333), (1, 1)) for dtype in (torch.float32, torch.bfloat16)
             for case in ("scalar", "special")]
    runs += [(b, a, torch.float64, case) for b, a in ((2, 300), (7, 333)) for case in ("aligned", "scalar")]
    for b, a, dtype, case in runs:
        got = loss_tail_case_checks(b, a, dtype, case, seed=b * a)
        n += got["checks"]
        if got["bce_rel"] is not None:
            bce_rel.append(got["bce_rel"])
    routes = [topk_case_check(*case, seed=sum(case[:4])) for case in TOPK_CASES]
    n += len(routes)
    log(f"kernel: the loss tail equal to its plain versions in {n} checks, each also bit-equal on a second call and "
        f"in a CUDA graph replay: K5 forward and backward, K6a forward and backward, K6b backward bit for bit at (B, "
        f"A) in {LOSS_TAIL_SHAPES + LOSS_TAIL_EDGE_SHAPES}, fp32 and bf16, logits read through a row stride of 144, "
        f"at (16, 2100), (7, 333), (1, 1) also through the scalar route's layouts (K5 and K6a "
        f"{LOSS_TAIL_ROUTES['scalar'][0]}"
        f", K6b {LOSS_TAIL_ROUTES['scalar'][1]}) and with NaN, +-inf and -0.0 logits, fp64 at (2, 300), (7, 333); "
        f"K6b's sum within {BCE_SUM_RTOL} relative (readings {min(bce_rel):.3g} to {max(bce_rel):.3g}), bit for bit "
        f"the sum in the kernel's order and the same on both routes; K7 values and indices bit for bit at (B, M, A, "
        f"k, rows) in {TOPK_CASES}, down the routes (route, values a thread) {routes}, on {card}")
    return {"checks": n, "bce_sum_rel_err": max(bce_rel), "bce_sum_rel_err_least": min(bce_rel)}


def topk_case_check(b: int, m: int, a: int, k: int, kind: str, seed: int, dtype=None) -> tuple:
    """K7 on `loss_tail_metrics(b, m, a, seed, kind)` in dtype (fp32 by default) against its plain version
    (`loss_tail_check`), down the route its layout allows (16-byte loads where A is a multiple of the values one
    carries) in the first register tile that holds A (a longer row streamed), one launch a call. Returns the plan's
    (route, values a thread holds)."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    x = loss_tail_metrics(b, m, a, seed, kind).to(dtype or torch.float32)
    plan = L.topk_rows_plan(x, k)
    fits = [i for i in L.TOPK_ITEMS if L.TOPK_THREADS * i >= a]
    want = ("vector" if a % (16 // x.element_size()) == 0 else "scalar", fits[0] if fits else 0)
    got = (plan["route"], plan["items"])
    what = f"B {b}, M {m}, A {a}, k {k}, {kind} rows, {x.dtype}"
    if got != want:
        raise AssertionError(f"topk_rows ({what}): the plan {got}, not {want}")
    before = L.topk_rows.launches
    loss_tail_check("topk_rows", lambda: L.topk_rows(x, k), lambda: L.topk_stable(x, k), what)
    if L.topk_rows.launches != before + 3:  # twice, and once in the capture
        raise AssertionError(f"topk_rows ({what}): {L.topk_rows.launches - before} launches for 3 calls")
    return got


def loss_tail_work(name: str, rows: int, es_x: int, es_y: int = 0, n: int = 0, k: int = 0):
    """(bytes, fp32 operations) of one loss-tail call on these shapes: each input byte read once and each output
    byte written once, LOSS_TAIL_OPS operations a logit. K5 and K6a read (rows, 64) logits of es_x bytes; K6b
    (rows, 80) logits and labels of es_x and es_y bytes; K7 (rows, n) metrics and writes (rows, k) values and int64
    indices."""
    if name == "topk_rows":
        return rows * (n * es_x + k * (es_x + 8)), rows * n
    if name.startswith("bce_sum"):
        logits = rows * 80
        by_bytes = logits * (es_x + es_y) + 4 + (logits * es_x if name.endswith("backward") else 0)
        return by_bytes, logits * LOSS_TAIL_OPS[name]
    logits = rows * 64
    by_bytes = logits * es_x + (logits * es_x if name.endswith("backward") else 0)
    by_bytes += rows * ({"dfl_expectation": 16, "dfl_expectation_backward": 16, "dfl_ce_mean": 16 + 4,
                         "dfl_ce_backward": 16 + 4}[name])
    return by_bytes, logits * LOSS_TAIL_OPS[name]


def loss_tail_bound_ms(name: str, rows: int, es_x: int, es_y: int = 0, n: int = 0, k: int = 0):
    """Least time of one loss-tail call on these shapes, and what bounds it: `loss_tail_work`'s bytes at the HBM
    rate against its operations at the fp32 rate."""
    by_bytes, ops = loss_tail_work(name, rows, es_x, es_y, n, k)
    t_bytes, t_ops = by_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cold_sets(touched_bytes: int) -> int:
    """Input sets a cold timing rotates through: enough that the other sets' bytes between two visits of one set
    exceed COLD_BYTES, twice the H100's 50 MB L2."""
    return max(2, -(-int(COLD_BYTES) // max(int(touched_bytes), 1)) + 1)


def cold_graph_ms(calls, iters: int = 20, reps: int = 5) -> float:
    """`graph_ms` of calls on distinct input sets taken in turn (see `cold_sets`): each call finds its inputs
    outside L2, as the train step's backward finds the maps its forward read long before."""
    turn = itertools.cycle(calls)
    return graph_ms(lambda: next(turn)(), iters=max(iters, len(calls)), reps=reps)


def loss_tail_numbers(card: str) -> dict:
    """The loss tail at the train step's shapes, by device time (a CUDA graph of 20 calls replayed): K5, K6a and
    K6b forward and backward at B 16, A 8,400 on the (B, A, 144) maps' slices, fp32 and bf16; K7 at B 16, k 10,
    A 8,400 with M 32 and 64, and with M 32 at A 2,100 (imgsz 320) and 33,600 (imgsz 1,280, a streamed row). Each
    kernel twice: warm (`graph_ms`, one input set, which L2 may hold across the calls) and cold (`cold_graph_ms`,
    input sets in turn); beside its plain version, its bound and, where one PyTorch call
    computes the same function, that call (a yardstick: F.binary_cross_entropy_with_logits for K6b,
    F.cross_entropy with the two-hot probabilities for K6a, torch.topk for K7, whose tie order is not
    lax.top_k's); K5, which no one call computes, beside two (`yardstick_ms`: a softmax over the 16 bins of a
    contiguous copy of the logits into fp32, then a matmul with the bin indices). Returns, by wrapper name and
    dtype, {ms, cold_ms, cold_sets, plain_ms, bound_ms, bound_by, library_ms, yardstick_ms, max_abs_err, shape}."""
    import torch
    import torch.nn.functional as F

    from yololite_tpu_torch.ops import loss_kernels as L

    b, a = 16, 8400
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname, es = str(dtype).split(".")[-1], dtype.itemsize
        n_sets = max(cold_sets(loss_tail_work(name, b * a, es, es)[0]) for name in LOSS_TAIL_OPS)
        sets = [loss_tail_inputs(b, a, dtype, seed=23 + i) for i in range(n_sets)]
        pairs = [loss_tail_pairs(*inputs) for inputs in sets]
        maps, tgt, lab = sets[0][:3]
        box, cls = maps[..., :64], maps[..., 64:]
        # the yardsticks' inputs, made before timing: (rows * 4, 16) logits and the two-hot probabilities of K6a
        x2 = box.float().reshape(-1, 16).contiguous()
        t = tgt.clamp(0, 15 - 0.01).reshape(-1)
        tl = t.long()
        probs = torch.zeros_like(x2).scatter_(1, tl[:, None], (tl + 1 - t)[:, None])
        probs.scatter_add_(1, (tl + 1).clamp(max=15)[:, None], (t - tl)[:, None])
        library = {"bce_sum": lambda: F.binary_cross_entropy_with_logits(cls, lab, reduction="sum"),
                   "dfl_ce_mean": lambda: F.cross_entropy(x2, probs, reduction="none")}
        xk, proj = box.reshape(-1, 16).contiguous(), torch.arange(16, dtype=torch.float32, device=box.device)
        yardstick = {"dfl_expectation": lambda: torch.softmax(xk, 1, dtype=torch.float32) @ proj}
        for name, (kernel, plain) in pairs[0].items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().nan_to_num(0.0).max())
            ms = graph_ms(kernel)
            n_cold = cold_sets(loss_tail_work(name, b * a, es, es)[0])
            cold = cold_graph_ms([p[name][0] for p in pairs[:n_cold]])
            plain_ms = graph_ms(plain, iters=5, reps=3)
            lib_ms = graph_ms(library[name]) if name in library else None
            yard_ms = graph_ms(yardstick[name]) if name in yardstick else None
            bound, bound_by = loss_tail_bound_ms(name, b * a, es, es)
            out.setdefault(name, {})[dname] = {"ms": ms, "cold_ms": cold, "cold_sets": n_cold, "plain_ms": plain_ms,
                                               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
                                               "yardstick_ms": yard_ms, "max_abs_err": err, "shape": [b, a, 144]}
            yard = f"softmax then matmul (two calls, a yardstick) {yard_ms:.4f} ms; " if yard_ms else ""
            log(f"kernel: {name} ({dname} logits, B {b}, A {a}, row stride 144): {ms:.4f} ms device warm (graph "
                f"replay, one input set), {cold:.4f} cold ({n_cold} sets in turn), {ms / bound:.2f}x and "
                f"{cold / bound:.2f}x its bound of {bound:.4f} ms ({bound_by}); plain {plain_ms:.4f} ms; "
                f"{'library ' + format(lib_ms, '.4f') + ' ms; ' if lib_ms is not None else ''}{yard}"
                f"max |kernel - plain| {err:.3g}, on {card}")
        del sets, pairs, maps, tgt, lab, box, cls, x2, probs, xk
    for m, n, key in ((32, a, "M32"), (64, a, "M64"), (32, 2100, "M32_A2100"), (32, 33600, "M32_A33600")):
        # imgsz 640, 320 (the smaller register tile) and 1,280 (a streamed row)
        n_cold = cold_sets(loss_tail_work("topk_rows", b * m, 4, n=n, k=10)[0])
        xs = [loss_tail_metrics(b, m, n, seed=24 + i) for i in range(n_cold)]
        x = xs[0]
        vk, ik = L.topk_rows(x, 10)
        vp, ip = L.topk_stable(x, 10)
        torch.cuda.synchronize()
        if not (same_bits(vk, vp) and same_bits(ik, ip)):
            raise AssertionError(f"topk_rows differs from its plain version at M {m}, A {n}")
        ms = graph_ms(lambda: L.topk_rows(x, 10))
        cold = cold_graph_ms([lambda xi=xi: L.topk_rows(xi, 10) for xi in xs])
        plain_ms = graph_ms(lambda: L.topk_stable(x, 10), iters=5, reps=3)
        lib_ms = graph_ms(lambda: torch.topk(x, 10))
        bound, bound_by = loss_tail_bound_ms("topk_rows", b * m, 4, n=n, k=10)
        out.setdefault("topk_rows", {})[key] = {"ms": ms, "cold_ms": cold, "cold_sets": n_cold,
                                                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                                                "library_ms": lib_ms, "max_abs_err": 0.0, "shape": [b, m, n, 10]}
        log(f"kernel: topk_rows (B {b}, M {m}, A {n}, k 10, fp32 metrics with ties): {ms:.4f} ms device warm (graph "
            f"replay), {cold:.4f} cold ({n_cold} sets in turn), {ms / bound:.2f}x and {cold / bound:.2f}x its bound "
            f"of {bound:.4f} ms ({bound_by}); plain (stable sort) {plain_ms:.4f} ms; torch.topk {lib_ms:.4f} ms "
            f"(another tie order: a yardstick); values and indices bit-equal, on {card}")
        del xs, x
    return out


# ---------------- K9: the compact box/DFL form's foreground gather ----------------

# (B, imgsz, M, mask): the assigner's masks at imgsz 640 (A 8,400) with M 16-256 (K 160-2,560; M 256 a share of 320
# positions, walked in two chunks), at 320 (A 2,100: fg's rows not 16-byte aligned) and 1,280 (A 33,600: three tiles);
# at 640 with B 1 (10 blocks) and M 20 (K 200 over 7 blocks: a ragged share); and at 640, M 32, no foreground row,
# exactly K of them in each image, and more than K (forced)
COMPACT_CASES = ((16, 640, 16, "assigner"), (16, 640, 32, "assigner"), (16, 640, 64, "assigner"),
                 (16, 640, 256, "assigner"), (16, 320, 32, "assigner"), (4, 1280, 32, "assigner"),
                 (1, 640, 32, "assigner"), (16, 640, 20, "assigner"),
                 (16, 640, 32, "none"), (16, 640, 32, "exactly_k"), (16, 640, 32, "over_k"))
# the layouts K9 is held on (`compact_layout`): the maps' box slice (row stride 144), a contiguous (B, A, 64) tensor,
# and the maps of row stride 146 with the box slice one column in (the scalar route, its backward's gradient too)
COMPACT_ROUTES = {"map": "vector", "contiguous": "vector", "scalar": "scalar"}


def assigner_fg(b: int, imgsz: int, m: int, seed: int):
    """The assigner's (B, A) foreground mask on the card at imgsz (A of its three levels) with M GT rows (the last
    quarter padding): GT boxes of 8 to imgsz / 4 + 8 px at random places, predicted boxes around each anchor, random
    class scores; the port's TaskAlignedAssigner (topk 10, 80 classes, K7 inside) as the loss runs it."""
    import torch

    from yololite_tpu_torch.ops.boxes import make_anchors
    from yololite_tpu_torch.utils.tal import TaskAlignedAssigner

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dict(device="cuda", generator=gen)
    anchors, strides = make_anchors([(imgsz // s, imgsz // s) for s in (8, 16, 32)], [8, 16, 32], 0.5, device="cuda")
    anc = anchors * strides
    a = anc.shape[0]
    c = torch.rand(b, m, 2, **f32) * imgsz
    wh = torch.rand(b, m, 2, **f32) * (imgsz / 4) + 8
    mask_gt = (torch.arange(m, device="cuda") < m - m // 4).float()[None, :, None].expand(b, m, 1).contiguous()
    gt = torch.cat([c - wh / 2, c + wh / 2], -1).clamp(0, imgsz) * mask_gt
    labels = torch.randint(0, 80, (b, m, 1), **f32).int()
    ext = torch.rand(b, a, 4, **f32) * 64 + 4
    boxes = torch.cat([anc - ext[..., :2], anc + ext[..., 2:]], -1)
    scores = torch.rand(b, a, 80, **f32)
    assigner = TaskAlignedAssigner(topk=10, num_classes=80, alpha=0.5, beta=6.0)
    return assigner(scores, boxes, anc, labels, gt, mask_gt)[3]


def compact_mask(b: int, imgsz: int, m: int, kind: str, seed: int):
    """(fg (B, A) bool, K = 10 * M) for one of COMPACT_CASES' masks."""
    import torch

    k = 10 * m
    if kind == "assigner":
        return assigner_fg(b, imgsz, m, seed), k
    a = sum((imgsz // s) ** 2 for s in (8, 16, 32))
    fg = torch.zeros(b, a, dtype=torch.bool, device="cuda")
    if kind != "none":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        n = k if kind == "exactly_k" else k + 1 + a // 10
        fg.scatter_(1, torch.rand(b, a, device="cuda", generator=gen).argsort(1)[:, :n], True)
    return fg, k


def compact_layout(layout: str, b: int, a: int, dtype, seed: int):
    """(x (B, A, 64) logits in dtype, a (B, A, 144)-sized maps' worth of values) in one of COMPACT_ROUTES' layouts,
    NaN, +-inf and -0.0 among the values (a gather copies bits)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    maps = (torch.randn(b, a, 144, device="cuda", generator=gen) * 3).to(dtype)
    rows = maps.view(-1, 144)
    rows[::13, 3], rows[::17, 20], rows[::19, 40], rows[::23, 50:54] = float("nan"), float("inf"), float("-inf"), -0.0
    if layout == "map":
        return maps[..., :64]
    if layout == "contiguous":
        return maps[..., :64].contiguous()
    wide = torch.zeros(b, a, 146, dtype=dtype, device="cuda")
    wide[..., 1:65] = maps[..., :64]
    return wide[..., 1:65]


def compact_gradient(b: int, k: int, dtype, seed: int, misaligned: bool):
    """The rows' gradient g (B, K, 64) in dtype, contiguous; 16-byte aligned or, `misaligned`, one element off (the
    backward's scalar route)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randn(b * k * 64 + 1, device="cuda", generator=gen).to(dtype)
    return (flat[1:] if misaligned else flat[:-1]).view(b, k, 64)


def compact_case_check(x, fg, k: int, g, route: str, what: str) -> None:
    """K9 on x, fg and k against its plain version (`loss_tail_check`: rows, idx and pos bit for bit, the same bits on
    a second call and in a CUDA graph replay), and its backward on g the same way; both down `route`, 3 launches
    each (two calls and one in the capture)."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    routes = (L.compact_rows_plan(x)["route"], L.compact_rows_plan(g)["route"])
    if routes != (route, route):
        raise AssertionError(f"compact_rows ({what}): routes {routes}, not {route}")
    op = torch.ops.yololite_tpu_torch.compact_rows
    before = (L.compact_rows.launches, L.compact_rows_backward.launches)
    loss_tail_check("compact_rows", lambda: op(x, fg, k), lambda: L.compact_rows_plain(x, fg, k), what)
    _, idx, pos = L.compact_rows_plain(x, fg, k)
    loss_tail_check("compact_rows_backward", lambda: L.compact_rows_backward(g, idx, pos),
                    lambda: L.compact_rows_backward_plain(g, idx, pos), what)
    after = (L.compact_rows.launches, L.compact_rows_backward.launches)
    if (after[0] - before[0], after[1] - before[1]) != (3, 3):
        raise AssertionError(f"compact_rows ({what}): {after[0] - before[0]} and {after[1] - before[1]} launches "
                             "for 3 calls each")


def compact_kernels_a_call(x, fg, k: int) -> int:
    """Device kernels (and copies) torch.profiler records under one `compact_rows` call on x, fg and k."""
    from yololite_tpu_torch.ops import loss_kernels as L

    L.compact_rows(x, fg, k)  # the library built and loaded outside the profile
    return profile_calls(lambda: L.compact_rows(x, fg, k), 1)[2]


def compact_floor_ms(b: int, k: int):
    """The launch floor beside K9's forward: `graph_ms` of an empty kernel on the forward's grid of (B, S) blocks of
    256 (csrc/compact_rows.cu `compact_rows_empty`, S from `compact_rows_shares`). None where the package timed has
    neither (a tree from before the one-launch forward, timed by tools/loss_tail_timing.py)."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    lib = L._compact_lib()
    if not hasattr(L, "compact_rows_shares") or not hasattr(lib, "compact_rows_empty"):
        return None
    shares, device = L.compact_rows_shares(b, k), torch.cuda.current_device()

    def empty():
        rc = lib.compact_rows_empty(b, shares, device, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"compact_rows_empty launch failed: {lib.compact_rows_error_string(rc).decode()}")

    return graph_ms(empty)


def compact_rows_checks(card: str) -> dict:
    """K9 forward and backward against their plain versions (`compact_case_check`) on every mask of COMPACT_CASES, in
    fp32 and bf16 on the maps' box slice; at 640 with M 32 also on a contiguous tensor and down the scalar route, and
    in fp64 (the float64 reference step); one device kernel a forward call at B 16, M 32 (`compact_kernels_a_call`).
    Returns {"checks", "masks": the masks' foreground counts (least, most) against K, "kernels_a_call"}."""
    import torch

    n, seen, kernels = 0, [], None
    for b, imgsz, m, kind in COMPACT_CASES:
        seed = b + imgsz + m + len(kind)
        fg, k = compact_mask(b, imgsz, m, kind, seed)
        a = fg.shape[1]
        nfg = fg.sum(1)
        seen.append((kind, imgsz, m, int(nfg.min()), int(nfg.max()), k))
        if kind == "assigner" and not 0 < int(nfg.max()) <= k:
            raise AssertionError(f"compact_rows: the assigner's mask at {imgsz}, M {m} holds {int(nfg.max())} "
                                 f"foreground rows in an image, K {k}")
        layouts = [("map", torch.float32), ("map", torch.bfloat16)]
        if (imgsz, m, kind) == (640, 32, "assigner"):
            layouts += [("contiguous", torch.float32), ("contiguous", torch.bfloat16), ("scalar", torch.float32),
                        ("scalar", torch.bfloat16), ("map", torch.float64), ("scalar", torch.float64)]
        for layout, dtype in layouts:
            x = compact_layout(layout, b, a, dtype, seed)
            g = compact_gradient(b, k, dtype, seed + 1, misaligned=layout == "scalar")
            compact_case_check(x, fg, k, g, COMPACT_ROUTES[layout],
                               f"B {b}, A {a}, M {m}, K {k}, {kind} mask, {layout}, {str(dtype).split('.')[-1]}")
            n += 1
        if (b, imgsz, m, kind) == (16, 640, 32, "assigner"):
            kernels = compact_kernels_a_call(compact_layout("map", b, a, torch.float32, seed), fg, k)
            if kernels != 1:
                raise AssertionError(f"compact_rows: {kernels} device kernels under one forward call, not 1")
    log(f"kernel: compact_rows (K9) equal to its plain version in {n} checks, forward (rows, idx, pos) and backward "
        f"bit for bit, each also on a second call and in a CUDA graph replay: masks (kind, imgsz, M, least and most "
        f"foreground rows an image, K) {seen}; fp32 and bf16 on the maps' box slice (row stride 144), at 640 / M 32 "
        f"also on a contiguous tensor, down the scalar route (row stride 146, one column in; the gradient one element "
        f"off) and in fp64; NaN, +-inf and -0.0 among the logits; one device kernel a forward call (torch.profiler, "
        f"B 16, A 8,400, K 320), on {card}")
    return {"checks": n, "masks": seen, "kernels_a_call": kernels}


def compact_rows_work(name: str, b: int, a: int, k: int, es: int) -> int:
    """Bytes of the function one K9 call computes at these shapes (C 64), each read once and each written once: the
    forward (lax.top_k of fg, then the gather) reads fg (B * A bytes) and the K rows it gathers and writes the rows
    and idx (int64); the backward (the gather's transpose) reads g and idx and writes the dense dx (B, A, 64). The
    inverse map pos that this design's forward writes and its backward reads is not the function's, so not counted."""
    if name == "compact_rows":
        return b * a + 2 * b * k * 64 * es + b * k * 8
    return b * k * 64 * es + b * k * 8 + b * a * 64 * es


def compact_rows_bound_ms(name: str, b: int, a: int, k: int, es: int):
    """Least time of one K9 call: `compact_rows_work`'s bytes at the HBM rate (a copy: no arithmetic to bound it)."""
    return compact_rows_work(name, b, a, k, es) / HBM_BYTES_PER_S * 1e3, "bytes"


def compact_rows_numbers(card: str) -> dict:
    """K9 at the train step's shapes (B 16, A 8,400, M 32: K 320) on the assigner's masks, forward on the maps' box
    slice and backward, fp32 and bf16, by device time (a CUDA graph of 20 calls replayed): warm (one input set) and
    cold (`cold_graph_ms`: the maps and masks in turn, each mask rolled along A), beside the plain version, the bound
    and, for the forward, a yardstick of library calls (a stable torch.sort of fg, then torch.gather; the plain
    backward is itself zeros and a scatter), and the forward beside the launch floor (`compact_floor_ms`). Returns
    {name: {dtype: {ms, cold_ms, cold_sets, plain_ms, bound_ms, bound_by, library_ms, max_abs_err, nfg, shape; the
    forward also floor_ms}}}."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L

    b, m = 16, 32
    fg0, k = compact_mask(b, 640, m, "assigner", seed=31)
    a = fg0.shape[1]
    floor = compact_floor_ms(b, k)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname, es = str(dtype).split(".")[-1], dtype.itemsize
        for name in ("compact_rows", "compact_rows_backward"):
            n_sets = cold_sets(compact_rows_work(name, b, a, k, es))
            fgs = [torch.roll(fg0, 7 * i, 1) for i in range(n_sets)]
            if name == "compact_rows":
                xs = [compact_layout("map", b, a, dtype, seed=32 + i) for i in range(n_sets)]
                calls = [lambda x=x, f=f: L.compact_rows(x, f, k) for x, f in zip(xs, fgs)]
                plain = lambda: L.compact_rows_plain(xs[0], fgs[0], k)[:2]
                lib = lambda: torch.gather(xs[0], 1, torch.sort(fgs[0].view(torch.uint8), dim=1, descending=True,
                                                                stable=True)[1][:, :k, None].expand(-1, -1, 64))
            else:
                gs = [compact_gradient(b, k, dtype, seed=40 + i, misaligned=False) for i in range(n_sets)]
                inv = [L.compact_rows_plain(fg.new_zeros(b, a, 1, dtype=torch.float32), fg, k)[1:] for fg in fgs]
                calls = [lambda g=g, ip=ip: L.compact_rows_backward(g, *ip) for g, ip in zip(gs, inv)]
                plain = lambda: L.compact_rows_backward_plain(gs[0], *inv[0])
                lib = None
            got, want = calls[0](), plain()
            torch.cuda.synchronize()
            got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(same_bits(x, y) for x, y in zip(got_t, want_t)):
                raise AssertionError(f"{name} ({dname}) differs from its plain version at B {b}, A {a}, K {k}")
            ms = graph_ms(calls[0])
            cold = cold_graph_ms(calls)
            plain_ms = graph_ms(plain, iters=5, reps=3)
            lib_ms = graph_ms(lib) if lib else None
            bound, bound_by = compact_rows_bound_ms(name, b, a, k, es)
            entry = {"ms": ms, "cold_ms": cold, "cold_sets": n_sets, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms, "max_abs_err": 0.0,
                     "nfg": [int(fg0.sum(1).min()), int(fg0.sum(1).max())], "shape": [b, a, 64, k]}
            extra = ""
            if name == "compact_rows":
                entry["floor_ms"] = floor
                extra = f"; an empty kernel on its grid {floor:.4f} ms" if floor is not None else ""
            out.setdefault(name, {})[dname] = entry
            log(f"kernel: {name} ({dname}, B {b}, A {a}, K {k}, the assigner's masks with "
                f"{int(fg0.sum(1).min())}-{int(fg0.sum(1).max())} foreground rows an image): {ms:.4f} ms device warm "
                f"(graph replay), {cold:.4f} cold ({n_sets} sets in turn), {ms / bound:.2f}x and {cold / bound:.2f}x "
                f"its bound of {bound:.4f} ms ({bound_by}){extra}; plain {plain_ms:.4f} ms"
                f"{'; stable torch.sort of fg then torch.gather ' + format(lib_ms, '.4f') + ' ms' if lib else ''}; "
                f"bit for bit, on {card}")
            del calls
    return out


# ---------------- K10: the apply (clip, the 7 rules, the zeroing, the EMA) ----------------

K10_RULES = ("SGD", "Adam", "Adamax", "AdamW", "NAdam", "RAdam", "RMSProp")
K10_RAMP = (([0.001, 0.002, 0.003], 0.8), ([0.01, 0.02, 0.005], 0.86))  # (lr_vec, momentum) of the checks' 2 steps


def k10_setup(rule: str, seed: int):
    """yolo11n's apply on the card, the same bits for the same seed: init(0) weights, every trainable tensor with a
    gradient (`k10_grads`) and moments drawn on the card, random BN statistics, an EMA a
    little off the weights, the optimizer at step 3 (NAdam's mu_product to match) and K10's table built. Returns
    (model, optimizer, ema)."""
    import torch

    from yololite_tpu_torch.engine import optim
    from yololite_tpu_torch.models.model import DetectionModel
    from yololite_tpu_torch.utils.ema import ModelEMA

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(t, scale=1.0):
        return torch.randn(t.shape, generator=gen, device="cuda") * scale

    m = DetectionModel("yolo11n.yaml", nc=80).init(0).cuda()
    with torch.no_grad():
        for k, t in m.state_dict().items():
            if k.endswith("running_mean"):
                t.copy_(rand(t, 0.5))
            elif k.endswith("running_var"):
                t.copy_(rand(t).abs() + 0.5)
    opt = optim.build_optimizer(rule, m, 0.01, 0.9, 5e-4)
    with torch.no_grad():
        for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
            p.grad = torch.zeros_like(p)
            mu.copy_(rand(p, 1e-3))
            nu.copy_(rand(p, 1e-3).square())
    ema = ModelEMA(m)
    with torch.no_grad():
        for e in ema.ema.state_dict().values():
            if e.is_floating_point():
                e.add_(rand(e, 1e-3))
    ema.updates = 3
    optim.load_moments(rule, opt, {}, {}, {}, step=3, beta1=0.9)
    k10_grads(opt, seed)
    opt.track(m, ema)
    return m, opt, ema


def k10_grads(opt, seed: int) -> None:
    """Fresh gradients (norm about 16) in place, the same bits for the same seed (an apply zeroes them)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for p in opt.params:
        p.grad.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.01)


def k10_state(m, opt, ema) -> list:
    """Every tensor one apply writes: the weights and BN statistics, moments, gradients, EMA, step, mu_product."""
    return [*m.state_dict().values(), *opt.mu, *opt.nu, *(p.grad for p in opt.params),
            *ema.ema.state_dict().values(), opt.step, opt.extra]


def k10_table_tensors(table) -> list:
    """Every tensor of an apply table, in its order."""
    return [x for r in table.train for x in r[:5]] + [x for r in table.floats + table.ints for x in r]


def k10_plain_step(opt, ema, scale):
    """`Optimizer.apply` with K10's plain version in place of the kernel, at the clip factor given."""
    from yololite_tpu_torch.ops import optim_kernels as OK

    opt.step.add_(1)
    s, extra = OK.step_scalars(opt.name, opt.step, opt.momentum, opt.extra)
    if extra is not None:
        opt.extra.copy_(extra)
    return OK.optim_apply_plain(opt.table, opt.name, opt.hyper, s, opt.weight_decay, ema.d, ema.one_minus_d,
                                scale=scale)


def k10_odd(seed: int, dtype=None):
    """An apply table of odd tensors of `dtype` (fp32, or fp64 as the float64 reference step's), the same bits for
    the same seed: trainable rows of 1, 7, 4,097 and 13 elements (the last two an element off 16 bytes, so the
    kernel's scalar route), in the three groups; an EMA-only row of 5 off 16 bytes and one of 8,200 aligned; an int64
    row of 3. Returns (table, hyper, d, one_minus_d, step, extra)."""
    import torch

    from yololite_tpu_torch.ops import optim_kernels as OK

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def t(n, off=False, s=1.0):
        x = (torch.randn(n + off, generator=gen, device="cuda") * s).to(dtype or torch.float32)
        return x[1:] if off else x

    train = []
    for n, gid, off in ((1, 0, False), (7, 1, False), (4097, 2, True), (13, 1, True)):
        train.append((t(n, off), t(n, off, 3.0), t(n, off, 0.1), t(n, off, 0.1).square(), t(n, off), gid))
    rest = [(t(5, True), t(5, True)), (t(8200), t(8200)),
            (torch.arange(3, device="cuda"), torch.arange(7, 10, device="cuda"))]
    hyper = torch.tensor([0.01, 0.02, 0.03, 0.87], device="cuda")
    d = torch.tensor(0.25, device="cuda")
    return (OK.ApplyTable(train, rest), hyper, d, 1.0 - d, torch.tensor(4, dtype=torch.int32, device="cuda"),
            torch.tensor(0.5, device="cuda"))


def max_abs_diff(xs, ys) -> float:
    """The largest |x - y| over pairs of tensors, in fp64 (NaN where both are NaN counts 0)."""
    import torch

    worst = 0.0
    for x, y in zip(xs, ys):
        if x.numel():
            a, b = x.double(), y.double()
            worst = max(worst, float(torch.where(a.isnan() & b.isnan(), 0.0, (a - b).abs()).max()))
    return worst


def k10_rule_check(rule: str, second_run: bool = False) -> dict:
    """K10 against its plain version on the card for one rule: on yolo11n (255 trainable tensors, 162 EMA-only
    floating and 81 integer state_dict entries) over 2 applies with lr and momentum moving (`K10_RAMP`), and on
    `k10_odd`'s tensors (two draws in fp32, one in fp64): every tensor it writes bit for bit given the kernel's
    clip factor, the norm
    within 1e-6 relative of the plain version's, one counted call an apply; with second_run, a second run from the
    same start gives the same bits, the norm's included. Raises on a difference; returns {"checks", "norm_rel_err"
    (largest), "max_abs_err" (largest |kernel - plain| over the tensors compared), "train", "floats", "ints", "vec"
    (trainable rows on the 16-byte route)}."""
    import torch

    from yololite_tpu_torch.ops import optim_kernels as OK

    def run(m, o, e, plain_of=None):
        clips = []
        for i, (lr_vec, momentum) in enumerate(K10_RAMP):
            k10_grads(o, 100 + i)
            o.set_lr_momentum(lr_vec, momentum)
            e.advance()
            if plain_of is None:
                before = OK.optim_apply.launches
                clips.append(o.apply(e.d, e.one_minus_d))
                if OK.optim_apply.launches != before + 1:
                    raise AssertionError(f"optim_apply {rule}: {OK.optim_apply.launches - before} counted calls")
            else:
                clips.append(k10_plain_step(o, e, plain_of[i][1]))
        torch.cuda.synchronize()
        return clips

    worst, checks = 0.0, 0
    (ma, oa, ea), (mb, ob, eb) = k10_setup(rule, 7), k10_setup(rule, 7)
    got = run(ma, oa, ea)
    want = run(mb, ob, eb, plain_of=got)  # each apply of the plain run at the kernel run's clip factor
    for i, (clip, plain) in enumerate(zip(got, want)):
        rel = abs(float(clip[0]) - float(plain[0])) / float(plain[0])
        worst = max(worst, rel)
        if rel > 1e-6 or not float(clip[1]) < 1:
            raise AssertionError(f"optim_apply {rule}, apply {i}: norm {float(clip[0])!r} vs plain "
                                 f"{float(plain[0])!r}, scale {float(clip[1])!r}")
        checks += 1
    err = max_abs_diff(k10_state(ma, oa, ea), k10_state(mb, ob, eb))
    bad = [i for i, (x, y) in enumerate(zip(k10_state(ma, oa, ea), k10_state(mb, ob, eb))) if not same_bits(x, y)]
    if bad:
        raise AssertionError(f"optim_apply {rule} on yolo11n differs from its plain version in {len(bad)} tensors "
                             f"(first: state index {bad[0]})")
    if second_run:
        mc, oc, ec = k10_setup(rule, 7)
        again = run(mc, oc, ec)
        if not (all(same_bits(x, y) for x, y in zip(again, got)) and
                all(same_bits(x, y) for x, y in zip(k10_state(mc, oc, ec), k10_state(ma, oa, ea)))):
            raise AssertionError(f"optim_apply {rule}: a second run from the same start gave other bits")
        del mc, oc, ec
    out = {"train": len(oa.table.train), "floats": len(oa.table.floats), "ints": len(oa.table.ints),
           "vec": sum(OK._vec16(*r[:5]) for r in oa.table.train)}
    del ma, oa, ea, mb, ob, eb
    for seed, dtype in ((11, torch.float32), (12, torch.float32), (13, torch.float64)):
        runs = []
        for _ in range(2):
            table, hyper, d, omd, step, extra = k10_odd(seed, dtype)
            scalars, _ = OK.step_scalars(rule, step, hyper[3], extra)
            runs.append((table, hyper, scalars, d, omd))
        (ta, ha, sa, da, oda), (tb, hb, sb, db, odb) = runs
        clip = OK.optim_apply(ta, rule, ha, sa, 5e-4, da, oda)
        plain = OK.optim_apply_plain(tb, rule, hb, sb, 5e-4, db, odb, scale=clip[1])
        torch.cuda.synchronize()
        rel = abs(float(clip[0]) - float(plain[0])) / float(plain[0])
        worst = max(worst, rel)
        err = max(err, max_abs_diff(k10_table_tensors(ta), k10_table_tensors(tb)))
        if rel > 1e-6 or not all(same_bits(x, y) for x, y in zip(k10_table_tensors(ta), k10_table_tensors(tb))):
            raise AssertionError(f"optim_apply {rule} on the odd {dtype} tensors (seed {seed}) differs from its plain "
                                 f"version")
        checks += 1
    return {"checks": checks, "norm_rel_err": worst, "max_abs_err": err, **out}


def k10_checks(card: str) -> dict:
    """`k10_rule_check` for all 7 rules, AdamW with a second run. Returns {"checks", "norm_rel_err" (largest),
    "max_abs_err"}."""
    results = {rule: k10_rule_check(rule, second_run=rule == "AdamW") for rule in K10_RULES}
    checks = sum(r["checks"] for r in results.values())
    worst = max(r["norm_rel_err"] for r in results.values())
    err = max(r["max_abs_err"] for r in results.values())
    r = results["AdamW"]
    log(f"kernel: optim_apply (K10) bit for bit against its plain version given its clip factor, for all 7 rules "
        f"({', '.join(K10_RULES)}), in {checks} checks: yolo11n's {r['train']} trainable tensors ({r['vec']} on the "
        f"16-byte route), {r['floats']} EMA-only floating and {r['ints']} integer entries over 2 applies with lr and "
        f"momentum moving, and tensors of 1, 7, 13 and 4,097 elements (two an element off 16 bytes), an EMA-only row "
        f"of 5 off 16, in fp32 and in fp64 (the float64 reference step's), max |kernel - plain| {err!r}; the norm within "
        f"{worst:.3g} relative of the plain version's fp64 sum; a second AdamW run the same bits; one counted call an "
        f"apply, on {card}")
    return {"checks": checks, "norm_rel_err": worst, "max_abs_err": err}


def k10_bytes(table, rule: str) -> int:
    """The bytes the function must move, each input read once and each output written once: p, g, mu, nu (not
    SGD's) and the EMA read, and p, mu, nu, the EMA and the zeroed g written; each other floating entry and its EMA
    read and the EMA written; each integer entry read and written. The norm's second read of g is this design's,
    not the function's (g fits the L2), so it is not counted."""
    n_train = sum(r[0].numel() for r in table.train)
    arrays = 8 if rule == "SGD" else 10
    n_float = sum(x.numel() for _, x in table.floats)
    n_int = sum(x.numel() * x.element_size() for _, x in table.ints)
    return 4 * n_train * arrays + 3 * 4 * n_float + 2 * n_int


def k10_bound_ms(table, rule: str):
    """Least time of one apply on the card: its bytes (`k10_bytes`) over HBM; the ~20 fp32 ops an element are far
    under the fp32 rate."""
    n = sum(r[0].numel() for r in table.train)
    ops = 25 * n
    by_bytes, by_ops = k10_bytes(table, rule) / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_kernels(fn) -> int:
    """Device kernels (and memsets and copies) one call of fn launched, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def parent_apply(m, opt, ema, rule: str):
    """The parent's apply on the same tensors, as the library yardstick: clip_grad_norm_, torch.optim's capturable
    foreach AdamW (SGD: its fused form, nesterov) at device lr and a Python-float momentum, _foreach_zero_ and the
    EMA's two foreach ops. Returns a function that runs one apply (no host sync: a graph captures it)."""
    import torch

    params = opt.params
    lr = torch.tensor(0.01, device="cuda")
    if rule == "SGD":
        t_opt = torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True, fused=True)
    else:
        t_opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=5e-4, capturable=True,
                                  foreach=True)
    grads = [p.grad for p in params]
    e_f, m_f = [], []
    for e, x in zip(ema.ema.state_dict().values(), m.state_dict().values()):
        if e.is_floating_point():
            e_f.append(e)
            m_f.append(x)

    def step():
        torch.nn.utils.clip_grad_norm_(params, 10.0, error_if_nonfinite=False)
        t_opt.step()
        torch._foreach_zero_(grads)
        torch._foreach_mul_(e_f, ema.d)
        torch._foreach_add_(e_f, torch._foreach_mul(m_f, ema.one_minus_d))

    step()  # the state, outside any capture
    return step


def fused_library_step(m, opt, rule: str):
    """torch.optim's fused AdamW (SGD: fused SGD, nesterov) stepping alone over the same parameters: the library's
    fastest form of the update alone (no clip, no zeroing, no EMA). Returns a function of one step."""
    import torch

    lr = torch.tensor(0.01, device="cuda")
    if rule == "SGD":
        t_opt = torch.optim.SGD(opt.params, lr=lr, momentum=0.9, nesterov=True, fused=True)
    else:
        t_opt = torch.optim.AdamW(opt.params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=5e-4,
                                  fused=True, capturable=True)
    t_opt.step()
    return t_opt.step


def k10_numbers(card: str) -> dict:
    """K10 at yolo11n, AdamW and SGD, by device time: the kernel's call cold (`cold_graph_ms`: two sets of tensors
    in turn, each apply's 95-116 MB beyond the L2) and warm, the whole apply as the trainer runs it (the step
    scalars and K10) replayed as a graph, cold; its plain version (back-to-back calls, CUDA events); the bound; the
    library yardsticks, cold: torch.optim's fused AdamW or SGD stepping alone, and the parent's whole apply
    (clip_grad_norm_, capturable foreach torch.optim, _foreach_zero_, the EMA's foreach); the device kernels one
    apply launches in each form (torch.profiler). Returns {rule: {...}}."""
    import torch

    from yololite_tpu_torch.ops import optim_kernels as OK

    out = {}
    for rule in ("AdamW", "SGD"):
        sets = [k10_setup(rule, 20 + i) for i in range(2)]
        m, opt, ema = sets[0]
        for _, o, e in sets:
            o.set_lr_momentum([0.01] * 3, 0.9)
            e.advance()
        s = [OK.step_scalars(rule, o.step, o.momentum, o.extra)[0] for _, o, _ in sets]
        kernel = [lambda o=o, e=e, s=s_: OK.optim_apply(o.table, rule, o.hyper, s, o.weight_decay, e.d,
                                                         e.one_minus_d) for (_, o, e), s_ in zip(sets, s)]
        whole = [lambda o=o, e=e: o.apply(e.d, e.one_minus_d) for _, o, e in sets]
        ms = cold_graph_ms(kernel)
        warm = graph_ms(kernel[0])
        whole_ms = cold_graph_ms(whole)
        plain_ms = cuda_ms(lambda: OK.optim_apply_plain(opt.table, rule, opt.hyper, s[0], opt.weight_decay, ema.d,
                                                        ema.one_minus_d), 3, warmup=1)
        bound, bound_by = k10_bound_ms(opt.table, rule)
        launches_k10 = device_kernels(whole[0])
        for i, (_, o, _) in enumerate(sets):  # the gradients again (the applies zeroed them), for the yardsticks
            k10_grads(o, 30 + i)
        fused = [fused_library_step(mm, o, rule) for mm, o, _ in sets]
        lib_ms = cold_graph_ms(fused)
        parent = [parent_apply(mm, o, e, rule) for mm, o, e in sets]
        parent_ms = cold_graph_ms(parent, iters=5)
        launches_parent = device_kernels(parent[0])
        mb = k10_bytes(opt.table, rule) / 1e6
        out[rule] = {"ms": ms, "warm_ms": warm, "apply_ms": whole_ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms, "parent_apply_ms": parent_ms, "mbytes": mb,
                     "device_kernels_an_apply": launches_k10, "parent_device_kernels_an_apply": launches_parent,
                     "trainable": len(opt.table.train), "values": sum(r[0].numel() for r in opt.table.train)}
        log(f"kernel: optim_apply (K10) {rule} on yolo11n ({len(opt.table.train)} trainable tensors, "
            f"{out[rule]['values']} values; {mb:.1f} MB an apply): {ms:.4f} ms device cold (graph replay, 2 sets in "
            f"turn), {warm:.4f} warm, {ms / bound:.2f}x its bound of {bound:.4f} ms ({bound_by}); the whole apply "
            f"(step scalars + K10) {whole_ms:.4f} ms cold, {launches_k10} device kernels; plain version "
            f"{plain_ms:.3f} ms (back-to-back calls); torch.optim fused {rule} stepping alone {lib_ms:.4f} ms cold; "
            f"the parent's whole apply (clip_grad_norm_, {'fused SGD' if rule == 'SGD' else 'capturable foreach AdamW'}"
            f", _foreach_zero_, the EMA's foreach) {parent_ms:.4f} ms cold as a graph, {launches_parent} device "
            f"kernels, on {card}")
        del sets, kernel, whole, fused, parent, m, opt, ema
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_loss():
    """The loss tail through its plain versions inside the block: K5, K6a and K6b as autograd Functions of the plain
    forwards with the plain closed-form backwards, K7 as the stable sort, K9 as the stable sort and torch.gather with
    the rows put back into zeros as its backward; no loss-tail launch."""
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L
    from yololite_tpu_torch.utils import loss as tloss, tal

    def plain_function(fwd, bwd):
        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, *rest):
                ctx.save_for_backward(x)
                ctx.rest = rest
                return fwd(x, *rest)

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                return (bwd(x, *ctx.rest, g),) + (None,) * len(ctx.rest)

        return Plain.apply

    class PlainCompact(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, fg, k):
            rows, idx, pos = L.compact_rows_plain(x, fg, k)
            ctx.save_for_backward(idx, pos)
            ctx.mark_non_differentiable(idx)
            return rows, idx

        @staticmethod
        def backward(ctx, g, _):
            idx, pos = ctx.saved_tensors
            return L.compact_rows_backward_plain(g, idx, pos), None, None

    saved = (L.dfl_expectation, tloss.dfl_ce_mean, tloss.bce_sum, tal.topk_rows, tloss.compact_rows)
    L.dfl_expectation = plain_function(L.dfl_expectation_plain,
                                       lambda x, r, g: L.dfl_expectation_backward_plain(x, g, r))
    tloss.dfl_ce_mean = plain_function(L.dfl_ce_plain, L.dfl_ce_backward_plain)
    tloss.bce_sum = plain_function(L.bce_sum_plain, L.bce_sum_backward_plain)
    tal.topk_rows = L.topk_stable
    tloss.compact_rows = PlainCompact.apply
    try:
        yield
    finally:
        L.dfl_expectation, tloss.dfl_ce_mean, tloss.bce_sum, tal.topk_rows, tloss.compact_rows = saved


def loss_launches(compact: bool, heads: int = 1) -> dict:
    """The loss-tail launches one train step makes, by wrapper name: each kernel once a head; K5's forward twice in
    the compact form (the dense decode for the assigner, the gathered rows' for the box terms); K9 and its backward
    once a head in the compact form, never in the dense one."""
    from yololite_tpu_torch.ops import loss_kernels as L

    want = {w.__name__: heads for w in L.COUNTED}
    want["dfl_expectation"] = heads * (2 if compact else 1)
    want["compact_rows"] = want["compact_rows_backward"] = heads if compact else 0
    return want


def loss_rows(loss, images, targets):
    """(A, K) of the v8 loss `loss` on this batch: its anchors, and the rows its compact form keeps
    (`v8DetectionLoss.compact_k`), K None where it runs the dense form."""
    h, w = images.shape[1], images.shape[2]
    a = sum((h // s) * (w // s) for s in loss.strides)
    return a, loss.compact_k(targets["gt_bboxes"].shape[1], a)


@contextlib.contextmanager
def box_loss_form(compact: bool):
    """utils/loss.py's COMPACT_BOX_LOSS set to `compact` inside the block."""
    from yololite_tpu_torch.utils import loss as tloss

    saved = tloss.COMPACT_BOX_LOSS
    tloss.COMPACT_BOX_LOSS = compact
    try:
        yield
    finally:
        tloss.COMPACT_BOX_LOSS = saved


def loss_tail_step_check(card: str, trainer_fn) -> None:
    """One train step of trainer_fn(amp)'s first batch (640, batch 16 in phase 5; forward, loss, backward; eager, in
    deterministic mode) with the loss-tail kernels against the same step with their plain versions (`plain_loss`),
    in fp32 and bf16: fg_mask equal, loss items within rtol 1e-5, each kernel launched as `loss_launches` says (the
    compact form where the batch takes it: K9 once, K5's forward twice) and none with the plain versions, and every
    gradient equal bit for bit (the backward kernels follow their plain versions' rounding, and no gradient depends
    on K6b's sum); each gradient's relative L2 to loss_tail_step_grads_<dtype>.tsv in the output directory as the
    record."""
    import torch

    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.ops import loss_kernels as L

    for amp in (False, True):
        dtype = "bf16" if amp else "fp32"
        st = trainer_fn(amp)
        batch = next(iter(st.train_loader))
        images = torch.from_numpy(batch["img"]).to(st.device)
        targets = st._targets(batch)
        out = {}
        with deterministic(), graphs.eager():
            for mode in ("kernels", "plain"):
                before = [w.launches for w in L.COUNTED]
                with plain_loss() if mode == "plain" else contextlib.nullcontext():
                    items = st._grad_step(images, targets)
                torch.cuda.synchronize()
                launched = [w.launches - n for w, n in zip(L.COUNTED, before)]
                grads = {n: p.grad.detach().clone() for n, p in st.model.named_parameters() if p.grad is not None}
                torch._foreach_zero_(st._grads)
                out[mode] = (items.clone(), st.fg_mask.clone(), grads, launched)
        (ik, fk, gk, lk), (ip, fp, gp, lp) = out["kernels"], out["plain"]
        compact = loss_rows(st.loss_fn, images, targets)[1] is not None
        if dict(zip((w.__name__ for w in L.COUNTED), lk)) != loss_launches(compact) or any(lp):
            raise AssertionError(f"loss-tail step {dtype}: launches {dict(zip((w.__name__ for w in L.COUNTED), lk))} "
                                 f"with the kernels ({'compact' if compact else 'dense'} form), {lp} with the plain "
                                 f"versions")
        if not torch.equal(fk, fp):
            raise AssertionError(f"loss-tail step {dtype}: fg_mask differs in {int((fk != fp).sum())} anchors")
        if not torch.allclose(ik, ip, rtol=1e-5, atol=0):
            raise AssertionError(f"loss-tail step {dtype}: loss items {ik.tolist()} against {ip.tolist()}")
        if set(gk) != set(gp):
            raise AssertionError(f"loss-tail step {dtype}: gradients of {sorted(set(gk) ^ set(gp))[:3]} in one step "
                                 f"only")
        rel = {n: float((gk[n].double() - gp[n].double()).norm() / max(float(gp[n].double().norm()), 1e-30))
               for n in gp}
        Path("chiprun_out").mkdir(exist_ok=True)
        Path(f"chiprun_out/loss_tail_step_grads_{dtype}.tsv").write_text(
            "".join(f"{n}\t{r:.6g}\n" for n, r in sorted(rel.items(), key=lambda kv: -kv[1])))
        differ = [n for n in gp if not same_bits(gk[n], gp[n])]
        if differ:
            raise AssertionError(f"loss-tail step {dtype}: {len(differ)} of {len(gp)} gradients differ from the plain "
                                 f"step's bits (largest relative L2 {max(rel.values()):.3g}), first {differ[:3]}")
        log(f"train: one step at {images.shape[1]}, batch {images.shape[0]} ({dtype}, M "
            f"{targets['gt_bboxes'].shape[1]}, eager, "
            f"deterministic mode) with the loss-tail kernels against their plain versions: fg_mask equal "
            f"({int(fk.sum())} foreground anchors), loss items {ik.tolist()} within "
            f"{float(((ik - ip).abs() / ip.abs()).max()):.3g} relative; all {len(gp)} gradients bit for bit; the "
            f"{'compact' if compact else 'dense'} box/DFL form, launches {dict(zip((w.__name__ for w in L.COUNTED), lk))}"
            f", on {card}")


def largest_difference(got: dict, want: dict) -> str:
    """Where two dicts of tensors of the same keys differ most, relative to the larger magnitude there: the key,
    the flat index and both values; "" where every pair is torch.equal."""
    import torch

    worst = None
    for n in want:
        if torch.equal(got[n], want[n]):
            continue
        a, b = got[n].double().reshape(-1), want[n].double().reshape(-1)
        rel = ((a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)).nan_to_num(float("inf"))
        i = int(rel.argmax())
        if worst is None or float(rel[i]) > worst[0]:
            worst = (float(rel[i]), n, i, float(a[i]), float(b[i]))
    if worst is None:
        return ""
    return (f"largest relative difference {worst[0]:.3g} in {worst[1]} at flat index {worst[2]} ({worst[3]!r} "
            f"against {worst[4]!r})")


def compact_vs_dense_step(card: str, trainer_fn) -> dict:
    """One train step of trainer_fn(amp)'s first batch (eager, deterministic mode, the loss-tail kernels) in the
    compact box/DFL form and in the dense one (utils/loss.py COMPACT_BOX_LOSS), fp32 and bf16: fg_mask equal, loss
    items within rtol 1e-5, every parameter's gradient and d loss / d maps equal in value (torch.equal: -0.0 and
    +0.0 alike), and in the compact form every row of d loss / d pred_distri that K9 did not pick +0.0, bit for bit;
    K9 launched once in the compact step and never in the dense one. A difference fails the check, with the largest
    relative one and where it is. Returns {dtype: {items_rel, nfg, picked, k}}."""
    import torch

    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.engine.predictor import fp32_convs
    from yololite_tpu_torch.ops import loss_kernels as L
    from yololite_tpu_torch.ops.decode import flatten_levels

    out = {}
    for amp in (False, True):
        dtype = "bf16" if amp else "fp32"
        st = trainer_fn(amp)
        batch = next(iter(st.train_loader))
        images = torch.from_numpy(batch["img"]).to(st.device)
        targets = st._targets(batch)
        k = loss_rows(st.loss_fn, images, targets)[1]
        if k is None:
            raise AssertionError(f"compact vs dense {dtype}: the batch takes the dense form")
        runs = {}
        with deterministic(), graphs.eager():
            for form in ("compact", "dense"):
                before = L.compact_rows.launches
                with box_loss_form(form == "compact"), fp32_convs(st.device):
                    feats = st._forward(images)
                    for f in feats:
                        f.retain_grad()
                    total, items, fg = st.loss_fn.forward(feats, targets)
                    total.backward()
                torch.cuda.synchronize()
                grads = {n: p.grad.detach().clone() for n, p in st.model.named_parameters() if p.grad is not None}
                grads["d loss / d maps"] = flatten_levels([f.grad for f in feats]).detach().clone()
                torch._foreach_zero_(st._grads)
                runs[form] = (items.clone(), fg.clone(), grads, L.compact_rows.launches - before)
        (ic, fc, gc, nc), (idn, fd, gd, nd) = runs["compact"], runs["dense"]
        if (nc, nd) != (1, 0):
            raise AssertionError(f"compact vs dense {dtype}: K9 launched {nc} times in the compact step, {nd} in the "
                                 f"dense one")
        if not torch.equal(fc, fd):
            raise AssertionError(f"compact vs dense {dtype}: fg_mask differs in {int((fc != fd).sum())} anchors")
        rel = float(((ic - idn).abs() / idn.abs()).max())
        if not torch.allclose(ic, idn, rtol=1e-5, atol=0):
            raise AssertionError(f"compact vs dense {dtype}: loss items {ic.tolist()} against {idn.tolist()}")
        differ = largest_difference(gc, gd)
        if differ:
            n_diff = sum(not torch.equal(gc[n], gd[n]) for n in gd)
            raise AssertionError(f"compact vs dense {dtype}: {n_diff} of {len(gd)} gradients differ in value; {differ}")
        box = gc["d loss / d maps"][..., :64]
        picked = L.compact_rows_plain(box[..., :1], fc, k)[2] >= 0
        rest = box[~picked]
        if not same_bits(rest, torch.zeros_like(rest)):
            raise AssertionError(f"compact vs dense {dtype}: {int((rest != 0).any(-1).sum())} rows K9 did not pick carry "
                                 f"a gradient, or -0.0")
        nfg = fc.sum(1)
        out[dtype] = {"items_rel": rel, "nfg": [int(nfg.min()), int(nfg.max())], "picked": int(picked.sum()), "k": k}
        log(f"train: one step at {images.shape[1]}, batch {images.shape[0]} ({dtype}, M "
            f"{targets['gt_bboxes'].shape[1]}: K {k}, eager, "
            f"deterministic mode) in the compact box/DFL form against the dense form: fg_mask equal "
            f"({int(nfg.min())}-{int(nfg.max())} foreground anchors an image, {int(picked.sum())} rows gathered), loss "
            f"items within {rel:.3g} relative, all {len(gd) - 1} parameter gradients and d loss / d maps equal in "
            f"value (torch.equal), the {int((~picked).sum())} rows K9 did not pick +0.0 in the compact form; K9 once "
            f"in the compact step, never in the dense one, on {card}")
    return out


def e2e_loss_check(card: str) -> None:
    """The end2end loss (one-to-many topk 10, one-to-one topk 1) at 640, batch 16, M 32 on seeded random maps, fp32,
    with the kernels against `plain_loss`: loss items within rtol 1e-5, d loss / d maps bit for bit, each head in the
    compact form (K9 and its backward twice a step, K5's forward four times), no launch with the plain versions."""
    import numpy as np
    import torch

    from yololite_tpu_torch.ops import loss_kernels as L
    from yololite_tpu_torch.utils import loss as tloss

    rng = np.random.default_rng(50)
    b, m, imgsz = 16, 32, 640
    n = rng.integers(4, m, b)
    bi = np.concatenate([np.full(c, i) for i, c in enumerate(n)]).astype(np.float32)
    c, wh = rng.uniform(0.1, 0.9, (len(bi), 2)), rng.uniform(0.02, 0.3, (len(bi), 2))
    batch = {"batch_idx": bi, "cls": rng.integers(0, 80, (len(bi), 1)).astype(np.float32),
             "bboxes": np.concatenate([c, wh], 1).astype(np.float32)}
    targets = {k: torch.from_numpy(v).cuda() for k, v in tloss.build_targets(batch, b, (imgsz, imgsz), m).items()}
    shapes = [(imgsz // s, imgsz // s) for s in (8, 16, 32)]
    maps = [torch.from_numpy((rng.standard_normal((2, b, h, w, 144)) * 2).astype(np.float32)).cuda()
            for h, w in shapes]
    loss = tloss.E2EDetectLoss(80, [8, 16, 32], 16)
    a = sum(h * w for h, w in shapes)
    ks = [head.compact_k(m, a) for head in (loss.one2many, loss.one2one)]
    if None in ks:
        raise AssertionError(f"e2e loss: a head takes the dense form at A {a}, M {m} (K {ks})")
    res = {}
    for mode in ("kernels", "plain"):
        leaves = [x.clone().requires_grad_() for x in maps]
        before = [w.launches for w in L.COUNTED]
        with plain_loss() if mode == "plain" else contextlib.nullcontext():
            total, items = loss({"one2many": [x[0] for x in leaves], "one2one": [x[1] for x in leaves]}, targets)
            total.backward()
        torch.cuda.synchronize()
        res[mode] = (items, [x.grad for x in leaves], dict(zip((w.__name__ for w in L.COUNTED),
                                                               (w.launches - n for w, n in zip(L.COUNTED, before)))))
    (ik, gk, lk), (ip, gp, lp) = res["kernels"], res["plain"]
    if lk != loss_launches(True, heads=2) or any(lp.values()):
        raise AssertionError(f"e2e loss: launches {lk} with the kernels, {lp} with the plain versions")
    if not torch.allclose(ik, ip, rtol=1e-5, atol=0) or not all(same_bits(x, y) for x, y in zip(gk, gp)):
        raise AssertionError(f"e2e loss: items {ik.tolist()} against {ip.tolist()}, maps' gradients bit for bit "
                             f"{[same_bits(x, y) for x, y in zip(gk, gp)]}")
    log(f"train: the end2end loss at 640, batch 16, M 32 (both heads compact: K {ks[0]} and {ks[1]}) with the kernels "
        f"against their plain versions: items within {float(((ik - ip).abs() / ip.abs()).max()):.3g} relative, d loss / "
        f"d maps bit for bit; launches {lk}, on {card}")


def loss_tail_autograd(card: str, trainer_fn) -> dict:
    """Where the loss's device time goes in a train step, op by op, in the compact box/DFL form and in the dense one
    (utils/loss.py COMPACT_BOX_LOSS), fp32 and bf16: one eager grad step of trainer_fn(amp)'s first batch under
    torch.profiler (with shapes; after two warm-up steps in the same form). By device time: each loss-tail op (K5,
    K6a, K6b forward and backward, K7, K9 and its backward); the CIoU terms (utils/loss.py's `bbox_iou` call, its
    forward ops under a profiler range and the backward nodes of those ops, linked by their sequence numbers); the
    backward of `flatten_levels` (its torch.cat, the same way); each `aten::slice_backward` that puts the (B, A, 64)
    or (B, A, 80) gradient of pred_distri or pred_scores back into a zeroed (B, A, 144) map; each add autograd makes
    of two gradients of the maps' or the gathered rows' shapes (K5's and K6a's dx, the two slices' maps); and the
    step's kernels in all. `AUTOGRAD_STEPS` profiled steps a form, the forms in turns, so each number has a spread.
    A graphed step replays the same kernels. Returns {form: {dtype: {name: [one value a profiled step]}}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.utils import loss as tloss

    def device_ms(e):
        return (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)) / 1e3

    def shape0(e):
        return list(e.input_shapes[0]) if e.input_shapes and e.input_shapes[0] else None

    def under(e, prefix):  # an ancestor's name starts with prefix
        e = e.cpu_parent
        while e is not None and not e.name.startswith(prefix):
            e = e.cpu_parent
        return e is not None

    def descendants(e):
        for c in e.cpu_children:
            yield c
            yield from descendants(c)

    def scoped(events, name):  # (forward ms, backward ms, backward nodes) of the ops under the range `name`
        ranges = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]  # not its span on the card
        seq = {c.sequence_nr for r in ranges for c in descendants(r) if c.sequence_nr >= 0}
        back = [e for e in events if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in seq]
        return sum(map(device_ms, ranges)), sum(map(device_ms, back)), len(back)

    def in_range(fn, name):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    def spread(values, fmt=".4f"):
        return f"{min(values):{fmt}}-{max(values):{fmt}}"

    out = {}
    saved = (tloss.bbox_iou, tloss.flatten_levels)
    tloss.bbox_iou = in_range(tloss.bbox_iou, "chip_smoke::ciou")
    tloss.flatten_levels = in_range(tloss.flatten_levels, "chip_smoke::flatten_levels")
    try:
        for amp in (False, True):
            dtype = "bf16" if amp else "fp32"
            st = trainer_fn(amp)
            batch = next(iter(st.train_loader))
            images = torch.from_numpy(batch["img"]).to(st.device)
            targets = st._targets(batch)
            b, h = images.shape[0], images.shape[1]
            a, k = loss_rows(st.loss_fn, images, targets)
            det = st.model.detect
            wanted = ([b, a, 4 * det.reg_max], [b, a, det.nc], [b, a, det.no], [b, k, 4 * det.reg_max])
            for form in ("compact", "dense"):  # two warm-up steps a form
                with graphs.eager(), box_loss_form(form == "compact"):
                    for _ in range(2):
                        st._grad_step(images, targets)
            torch.cuda.synchronize()
            torch._foreach_zero_(st._grads)
            for turn in range(AUTOGRAD_STEPS):
                for form in ("compact", "dense") if turn % 2 == 0 else ("dense", "compact"):
                    with graphs.eager(), box_loss_form(form == "compact"):
                        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                     record_shapes=True) as prof:
                            st._grad_step(images, targets)
                            torch.cuda.synchronize()
                    torch._foreach_zero_(st._grads)
                    events = prof.events()
                    slices = [e for e in events if e.name == "aten::slice_backward" and shape0(e) in wanted[:3]]
                    adds = [e for e in events if e.name in ("aten::add", "aten::add_") and shape0(e) in wanted
                            and len(e.input_shapes) > 1 and list(e.input_shapes[1]) == shape0(e)
                            and under(e, "autograd::engine::evaluate_function")]
                    ops = {}
                    for e in events:  # each loss-tail op once (not the op inside itself)
                        if e.name.startswith("yololite_tpu_torch::") and not under(e, "yololite_tpu_torch::"):
                            ops[e.name.split("::")[1]] = ops.get(e.name.split("::")[1], 0.0) + device_ms(e)
                    ciou_f, ciou_b, ciou_n = scoped(events, "chip_smoke::ciou")
                    cat_f, cat_b, cat_n = scoped(events, "chip_smoke::flatten_levels")
                    step = sum(e.time_range.elapsed_us() for e in events if e.device_type == DeviceType.CUDA
                               and not getattr(e, "is_user_annotation", False)) / 1e3
                    if not slices or not ops or not ciou_n or not cat_n:
                        raise AssertionError(f"loss-tail autograd {form} {dtype}: the profile shows {len(slices)} "
                                             f"slice_backward, {len(ops)} loss-tail ops, {ciou_n} CIoU backward "
                                             f"nodes and {cat_n} of flatten_levels")
                    if ("compact_rows" in ops) != (form == "compact"):
                        raise AssertionError(f"loss-tail autograd {form} {dtype}: K9 "
                                             f"{'absent' if form == 'compact' else 'ran'}")
                    r = {**{f"op:{n}": v for n, v in ops.items()}, "kernels_ms": sum(ops.values()),
                         "ciou_ms": ciou_f, "ciou_backward_ms": ciou_b, "ciou_nodes": ciou_n, "cat_ms": cat_f,
                         "cat_backward_ms": cat_b, "cat_nodes": cat_n, "slice_ms": sum(map(device_ms, slices)),
                         "slices": len(slices), "add_ms": sum(map(device_ms, adds)), "adds": len(adds),
                         "step_ms": step}
                    r["loss_ms"] = r["kernels_ms"] + ciou_f + ciou_b + r["slice_ms"] + r["add_ms"]
                    steps = out.setdefault(form, {}).setdefault(dtype, {})
                    for n, v in r.items():
                        steps.setdefault(n, []).append(v)
            for form in ("compact", "dense"):
                r = out[form][dtype]
                by_op = ", ".join(f"{n[3:]} {spread(r[n])}" for n in sorted(r) if n.startswith("op:"))
                log(f"train: the loss's device time by op, {form} box/DFL form, {AUTOGRAD_STEPS} eager grad steps at "
                    f"{h}, batch {b} in turns with the other form ({dtype}, A {a}, M {targets['gt_bboxes'].shape[1]}, "
                    f"each under torch.profiler; least-most of the steps; a graphed step replays these kernels): "
                    f"{by_op} ms (the loss-tail ops {spread(r['kernels_ms'])}); CIoU forward {spread(r['ciou_ms'])}, "
                    f"its backward {spread(r['ciou_backward_ms'])} ({r['ciou_nodes'][0]} nodes); {r['slices'][0]} slice_backward "
                    f"of the maps' slices {spread(r['slice_ms'])}; {r['adds'][0]} adds of their gradients "
                    f"{spread(r['add_ms'])}; these together {spread(r['loss_ms'])} ms; flatten_levels' torch.cat "
                    f"{spread(r['cat_ms'])}, its backward {spread(r['cat_backward_ms'])} ({r['cat_nodes'][0]} nodes); "
                    f"the step's kernels {spread(r['step_ms'], '.1f')} ms in all, on {card}")
            saving = [d - c for c, d in zip(out["compact"][dtype]["loss_ms"], out["dense"][dtype]["loss_ms"])]
            log(f"train: the loss's device time, dense less compact, turn by turn ({dtype}): "
                f"{', '.join(f'{v:.4f}' for v in saving)} ms, on {card}")
    finally:
        tloss.bbox_iou, tloss.flatten_levels = saved
    return out


def graphed_step_forms(card: str, trainer_fn) -> dict:
    """The whole train step (grad then apply, AdamW) of trainer_fn(amp)'s first batch replayed from its CUDA graphs,
    in the compact box/DFL form and in the dense one (a trainer each, the form set while it captures), fp32 and
    bf16, on one batch: CUDA events around each step, the median of 10, in turns (`STEP_TURNS`). Returns {form:
    {dtype: [ms of each turn]}}."""
    import numpy as np
    import torch

    from yololite_tpu_torch.engine.predictor import fp32_convs

    out = {}
    lr, mom = np.full(3, 1e-4, np.float32), 0.9
    for amp in (False, True):
        dtype = "bf16" if amp else "fp32"
        trainers, batch = {}, None
        for form in ("compact", "dense"):
            st = trainer_fn(amp)
            own = next(iter(st.train_loader))
            if batch is not None and not all(np.array_equal(own[k], batch[k]) for k in ("img", "cls", "bboxes")):
                raise AssertionError("two trainers' loaders, seeded alike, gave different first batches")
            batch = own  # both forms step on the same batch
            trainers[form] = (st, torch.from_numpy(batch["img"]).to(st.device), st._targets(batch))
        for form in STEP_TURNS:
            st, images, targets = trainers[form]
            with box_loss_form(form == "compact"), fp32_convs(images.device):
                ms = event_ms(lambda: None, lambda _: (st._grad_step(images, targets), st._apply_step(lr, mom)))
            if not st.graphs.replays:
                raise AssertionError(f"graphed step {form} {dtype}: no replay")
            out.setdefault(form, {}).setdefault(dtype, []).append(ms)
        log(f"train: the whole step replayed ({dtype}, batch {images.shape[0]} at {images.shape[1]}, M "
            f"{targets['gt_bboxes'].shape[1]}, CUDA events, median of 10, in turns {', '.join(STEP_TURNS)}): "
            f"compact {', '.join(f'{v:.3f}' for v in out['compact'][dtype])} ms, dense "
            f"{', '.join(f'{v:.3f}' for v in out['dense'][dtype])} ms, on {card}")
    return out


def profile_calls(fn, reps: int):
    """Wall ms of `reps` calls of fn (ending in a synchronize) under torch.profiler, the card's busy ms over them (the
    union of its kernels and copies), and the count of device events; busy None when the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tools.torch_predict_profile import busy_ms

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in on_device) if on_device else None
    return wall, busy, len(on_device)


@contextlib.contextmanager
def recorded_uploads():
    """Every `Upload` (data/build.py: a feed's, or the pipeline's) made inside the block, in order: their counters
    (batches, bytes, the byte sizes of the arrays sent, each batch's copy events, the hand-over's host time)."""
    from yololite_tpu_torch.data import build

    made, init = [], build.Upload.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    build.Upload.__init__ = recording
    try:
        yield made
    finally:
        build.Upload.__init__ = init


PAD_BYTES = 4099  # a pad copy's size: no batch array's (uint8 images are 3 H W a row, the targets multiples of 16)


def _profiler_pad():
    """Work on the card that is no batch's: 8 page-locked copies of PAD_BYTES and 256 small kernels, then a sync. In
    this script's chip runs, a window profiled after earlier profiled phases lost one of its three batch copies (the
    same calls profiled alone in a fresh process kept all of them), so a window that counts batch copies begins and
    ends with this pad."""
    import torch

    host = torch.zeros(PAD_BYTES, dtype=torch.uint8).pin_memory()
    dev = torch.empty(PAD_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(8):
        dev.copy_(host, non_blocking=True)
    for _ in range(256):
        dev.add_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def htod_profile():
    """torch.profiler (CPU and CUDA) over the block, padded at both ends (`_profiler_pad`); yields (the profiler, the
    uploads made in the block: `recorded_uploads`). Read the copies with `htod_copies` after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _profiler_pad()
        with recorded_uploads() as uploads:
            yield prof, uploads
        torch.cuda.synchronize()
        _profiler_pad()


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, starts, a: float, b: float) -> float:
    """The length of [a, b] that the merged intervals cover."""
    import bisect

    got, i = 0.0, max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(merged) and merged[i][0] < b:
        got += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return got


def htod_copies(prof, uploads, what: str) -> dict:
    """The host-to-device copies that a torch.profiler run saw (its Chrome trace), by the source memory's kind
    (Pinned or Pageable in the copy's name), and the batches' among them: those whose byte count is the size of an
    array one of `uploads` sent; the pads of `htod_profile` are left out. Fails on any batch copied from pageable
    memory, and unless the pinned batch copies number at least the batches the uploads sent. Returns the counts, the
    batch copies' device ms a batch and GB/s, and, for each upload's batches after its first (each upload's copies
    in time order, `arrays` a batch), the share of the batch's copy time that a kernel on the card overlapped."""
    import json
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels, copies, names = [], [], set()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name, t0 = str(e.get("cat", "")).lower(), str(e.get("name", "")), float(e["ts"])
        if cat == "kernel":
            kernels.append((t0, t0 + float(e["dur"])))
        elif cat == "gpu_memcpy" and "HtoD" in name and int(e.get("args", {}).get("bytes", -1)) != PAD_BYTES:
            names.add(name)
            kind = "pinned" if "Pinned" in name else "pageable" if "Pageable" in name else name
            copies.append((t0, t0 + float(e["dur"]), kind, int(e.get("args", {}).get("bytes", -1))))
    sizes = set().union(*(u.sizes for u in uploads)) if uploads else set()
    batches = sum(u.batches for u in uploads)
    by_kind = {}
    for _, _, kind, nbytes in copies:
        n, b = by_kind.get(kind, (0, 0))
        by_kind[kind] = (n + 1, b + max(nbytes, 0))
    batch = sorted(c for c in copies if c[3] in sizes)
    pageable = [c for c in batch if c[2] != "pinned"]
    if pageable or len(batch) < batches:
        raise AssertionError(f"{what}: {len(pageable)} batch copies from pageable memory and {len(batch)} batch "
                             f"copies in all for {batches} batches sent ({len(copies)} host-to-device copies: "
                             f"{sorted(names)}; {len(kernels)} kernels in the trace)")
    merged = _merged(kernels)
    starts = [a for a, _ in merged]
    arrays = len(batch) // max(batches, 1)  # copies a batch: 1 (predict, val, pipeline) or 4 (train)
    shares, i = [], 0
    if len(batch) == arrays * batches:  # else other copies share a batch array's size: no grouping by batch
        for u in uploads:
            own = batch[i:i + u.batches * arrays]
            i += u.batches * arrays
            for j in range(1, u.batches):
                group = own[j * arrays:(j + 1) * arrays]
                dur = sum(b - a for a, b, _, _ in group)
                shares.append(sum(_covered(merged, starts, a, b) for a, b, _, _ in group) / dur if dur > 0 else 1.0)
    us = sum(b - a for a, b, _, _ in batch)
    nbytes = sum(c[3] for c in batch)
    return {"by_kind": by_kind, "batch_copies": len(batch), "batches": batches, "arrays": arrays, "shares": shares,
            "copy_ms_a_batch": us / 1e3 / max(batches, 1), "gb_s": nbytes / us / 1e3 if us > 0 else None,
            "mib_a_batch": nbytes / 2 ** 20 / max(batches, 1), "kernels": len(kernels)}


def copies_text(c: dict) -> str:
    kinds = ", ".join(f"{k} {n} ({b / 2 ** 20:.1f} MiB)" for k, (n, b) in sorted(c["by_kind"].items()))
    rate = f"{c['gb_s']:.2f} GB/s" if c["gb_s"] else "no rate"
    return (f"host-to-device copies by source kind: {kinds}; of them the batches' {c['batch_copies']} for "
            f"{c['batches']} batches, all pinned, {c['copy_ms_a_batch']:.3f} ms a batch on the card "
            f"({c['mib_a_batch']:.2f} MiB, {rate}); the batch copies' overlap with kernels on the card after each "
            f"pass's first batch: {share_text(c['shares'])}")


def share_text(shares) -> str:
    import numpy as np

    if not shares:
        return "none measured (no batch after a pass's first)"
    return (f"min {min(shares):.3f}, median {float(np.median(shares)):.3f}, mean {float(np.mean(shares)):.3f}, "
            f"{sum(x >= 0.9 for x in shares)} of {len(shares)} batches at 0.9 or more")


def handover_text(uploads) -> str:
    """The consumer's host ms a batch handing batches over, and the share of the bytes staged by a host copy."""
    batches = sum(u.batches for u in uploads)
    hand = sum(u.handover_s for u in uploads) * 1e3 / max(batches, 1)
    staged = sum(u.staged_bytes for u in uploads) / max(sum(u.bytes for u in uploads), 1)
    return (f"hand-over {hand:.4f} ms a batch on the consumer's thread ({batches} batches); {staged:.3f} of the bytes "
            f"copied into the ring on the host first")


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


def write_val_dataset(root: Path, shapes, seed: int, labels=None, split: str = "val") -> Path:
    """A YOLO dataset split under root: PNG images (dark background, bright rectangles), labels, data.yaml.

    labels: per-image lists of (cls, cx, cy, w, h) normalized; random boxes over the 80 classes when None.
    data.yaml names the train split too once one has been written.
    """
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        im = rng.integers(0, 30, (h, w, 3)).astype(np.uint8)
        for _ in range(10):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            im[y0:y0 + rng.integers(8, h // 2), x0:x0 + rng.integers(8, w // 2)] += rng.integers(0, 200, 3).astype(
                np.uint8)
        if not cv2.imwrite(str(root / "images" / split / f"im{i:03d}.png"), im):
            raise RuntimeError(f"could not write {root}/images/{split}/im{i:03d}.png")
        if labels is None:
            n = int(rng.integers(1, 8))
            rows = [(int(k), *xy, *s) for k, xy, s in zip(rng.integers(0, 80, n), rng.uniform(0.2, 0.8, (n, 2)),
                                                            rng.uniform(0.05, 0.3, (n, 2)))]
        else:
            rows = labels[i]
        (root / "labels" / split / f"im{i:03d}.txt").write_text(
            "\n".join(f"{k} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}" for k, cx, cy, bw, bh in rows))
    train = "train: images/train\n" if (root / "images" / "train").is_dir() else ""
    (root / "data.yaml").write_text(f"path: {root}\n{train}val: images/val\nnc: 80\n")
    return root / "data.yaml"


def separating_weights_(model) -> None:
    """Weights whose class scores differ from anchor to anchor, so near-ties are rare (in place).

    init(0) weights fade the image out through the depth: every class logit
    sits within a few ulps of one value and rounding alone orders the
    candidates. Every conv is scaled by 2.5, which keeps the signal alive to
    the head; each level's last class conv (of both branch pairs of an
    end2end head) is scaled up and its biases are set to multiples of 1/8 in
    (-5, 0).
    """
    import numpy as np
    import torch

    rng = np.random.default_rng(14)
    head = model.detect
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 4:
                p.mul_(2.5)
        for branch in (head.cv3, head.one2one_cv3) if head.end2end else (head.cv3,):
            for conv, s in zip((seq[2] for seq in branch), (100.0, 400.0, 1000.0)):
                conv.weight.mul_(s)
                conv.bias.copy_(torch.from_numpy(rng.integers(-39, 0, conv.bias.shape[0]) / 8.0))


def mixed_sizes_stream(card: str) -> None:
    """Phase 3: a stream of 48 frames at 12 sizes, drawn with a skew (photos from a few cameras), sent as one
    predict call each (a server's requests; a list of arrays would be one batch), graphed and eagerly. The uint8
    path keys its graph on the frame size: a size seen once stays eager, its second frame captures, later ones
    replay, and the cache holds at most graphs.MAX_GRAPHS. Checks the detections equal the eager run's and the
    bound; reports the calls replayed, the graphs held and the pool's bytes."""
    import numpy as np
    import torch

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine import graphs

    sizes = [(480, 640), (720, 1280), (1080, 1920), (375, 500), (640, 480), (427, 640), (768, 1024), (300, 400),
             (600, 800), (512, 512), (1280, 720), (240, 320)]
    rng = np.random.default_rng(40)
    p = 1.0 / np.sqrt(np.arange(1, len(sizes) + 1))
    draws = rng.choice(len(sizes), 48, p=p / p.sum())
    stream = [rng.integers(0, 256, (*sizes[i], 3), dtype=np.uint8) for i in draws]
    kw = dict(conf=1e-7, imgsz=640, batch=1, save=False, verbose=False)
    model = YOLOLite("yolo11n.yaml")
    model.predict(stream[0], **kw)  # set up: its warm-up and this frame run eagerly (first sights)
    cache = model.predictor._graphs
    calls, replays, captures = cache.calls, cache.replays, cache.captures
    pool0 = graphs.pool_reserved_bytes()
    times = {}
    for name in ("graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graphs.eager() if name == "eager" else contextlib.nullcontext():
            got = [model.predict(f, **kw)[0] for f in stream]
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        if name == "graphed":
            graphed = got
            held, pool1 = len(cache), graphs.pool_reserved_bytes()
    calls, replays, captures = cache.calls - calls, cache.replays - replays, cache.captures - captures
    repeated = sum(1 for i, d in enumerate(draws) if d in draws[:i] or d == draws[0])
    if calls != len(stream) or held > graphs.MAX_GRAPHS or not replays:
        raise AssertionError(f"mixed sizes: {calls} calls, {replays} replays, {held} graphs held")
    for a, b in zip(graphed, got):
        if not np.array_equal(a.boxes.data, b.boxes.data) or a.orig_shape != b.orig_shape:
            raise AssertionError("mixed sizes: graphed predict differs from eager")
    log(f"slice: a stream of {len(stream)} frames at {len(set(draws.tolist()))} sizes (skewed draw), yolo11n fp32 "
        f"batch 1 at 640: {calls} calls, {replays} replayed ({replays / calls:.1%}), {captures} captured, "
        f"{calls - replays} eager (first sights, or sizes dropped from the cache); {repeated} frames of a size seen "
        f"before; {held} graphs held (bound {graphs.MAX_GRAPHS}); the graph pool {pool0 / 2 ** 20:.1f} -> "
        f"{pool1 / 2 ** 20:.1f} MiB reserved; graphed {times['graphed'] / len(stream):.2f} ms a frame, eager "
        f"{times['eager'] / len(stream):.2f}; detections equal, on {card}")


def mixed_sizes_val(card: str, model, root: Path, recorded) -> None:
    """Phase 4: val through the facade of 256 images whose sizes mix ten common photo sizes (80%) with random ones
    (20%), at batch 16, rect: a bucket shape's first batch runs eagerly, its second captures, later ones replay.
    Runs graphed, eagerly and graphed again, each a new validator; checks equal metrics and K4 once a batch; reports
    img/s and the share of batches that replay."""
    import numpy as np
    import torch

    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.ops.kernels import blocked_nms_finalize, select_decode

    common = [(480, 640), (427, 640), (640, 480), (640, 427), (512, 640), (360, 640), (640, 640), (375, 500),
              (333, 500), (500, 375)]
    weights = np.array([0.35, 0.2, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05])
    rng = np.random.default_rng(41)
    n_img, bs = 256, 16
    shapes = [common[rng.choice(len(common), p=weights)] if rng.uniform() < 0.8
              else tuple(int(v) for v in rng.integers(200, 641, 2)) for _ in range(n_img)]
    data = write_val_dataset(root / "val256", shapes, seed=42)
    kw = dict(data=str(data), imgsz=640, batch=bs, rect=True, conf=1e-7, plots=False, verbose=False,
              project=str(root / "runs"), save_json=False)
    model.val(name="mixed_cache", **kw)  # the label cache
    rd, lines = None, []
    for name in ("graphed", "eager", "graphed again"):
        blocked_nms_finalize.launches = 0
        k3_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graphs.eager() if name == "eager" else contextlib.nullcontext():
            m = model.val(name=f"mixed_{name.replace(' ', '_')}", validator=recorded, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        v = recorded.made[-1]
        batches, g = len(v.dataloader), v._infer.graphs
        buckets = len({tuple(int(x) for x in r) for r in v.dataloader.dataset.batch_shapes})
        k3_tally(select_decode.launches, f"mixed-size val {name}", only="cluster", add=False)
        if blocked_nms_finalize.launches != batches + (0 if name == "eager" else g.warmups) or (
                select_decode.launches != blocked_nms_finalize.launches) or (
                rd is not None and m.results_dict != rd):  # a capture's warm-up launches K3 and K4 too
            raise AssertionError(f"mixed-size val {name}: K4 {blocked_nms_finalize.launches} and K3 "
                                 f"{select_decode.launches} launches for {batches} batches, metrics {m.results_dict} "
                                 f"vs {rd}")
        rd = m.results_dict
        lines.append(f"{name} {n_img / dt:.1f} img/s" + ("" if name == "eager" else
                     f" ({g.replays} of {g.calls} batches replayed, {g.captures} captured)"))
    log(f"val: 256 images of mixed sizes (ten common photo sizes and 20% random ones), yolo11n fp32 at 640, batch "
        f"{bs}, rect, through the facade: {batches} batches in {buckets} bucket shapes; {'; '.join(lines)}; metrics "
        f"equal, K3 and K4 once a batch, on {card}")


def val_phase(card: str, model):
    """yolo11n val at 640 on the card through the facade (`model`, init(0) on the card), its checks and timings.

    Returns K4's launches in the val runs, K4's numbers on val's own inputs, and K3's launches in the val runs
    with its numbers on those inputs and nms_from_feats's times with K3 and with its plain version.
    """
    import tempfile

    import numpy as np
    import torch

    from yololite_tpu_torch.data.dataset import DataLoader, YOLODataset
    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs, inference_net
    from yololite_tpu_torch.engine.validator import VAL_MAX_CAND, DetectionValidator
    from yololite_tpu_torch.ops import nms
    from yololite_tpu_torch.ops.kernels import blocked_nms_finalize, greedy_nms_keep, select_decode

    class Recorded(DetectionValidator):
        """The facade's validator, kept so that its graph cache can be read."""
        made = []

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            Recorded.made.append(self)

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)] * 16  # rect at batch 16: four buckets
    data = write_val_dataset(root / "val64", shapes, seed=15)
    n_img, bs = len(shapes), 16
    launches = k3_launches = 0
    for half in (False, True):
        dtype = "bf16" if half else "fp32"
        kw = dict(data=str(data), imgsz=640, batch=bs, rect=True, conf=1e-7, half=half, plots=False,
                  verbose=False, project=str(root / "runs"), name=dtype)
        metrics = model.val(save_json=True, **kw)  # label cache, predictions.json
        rd = metrics.results_dict
        if not all(np.isfinite(v) and 0 <= v <= 1 for v in rd.values()):
            raise AssertionError(f"val {dtype} metrics not finite or outside [0, 1]: {rd}")
        preds = list((root / "runs").glob(f"{dtype}*/predictions.json"))
        if len(preds) != 1 or not json.loads(preds[0].read_text()):
            raise AssertionError(f"val {dtype}: predictions.json missing or empty ({preds})")
        # through the facade (a new validator each call; each of the four bucket shapes holds one batch, seen once,
        # so every step runs eagerly), then one validator three times (its first run eager, its second captures each
        # shape and replays it, its third replays), then eagerly; K4 once a batch (and once a capture's warm-up
        # run, if any), K1 never
        v = DetectionValidator(args={**kw, "mode": "val", "name": f"{dtype}_reused"})
        runs = {}
        for name in ("facade", "facade again", "validator", "validator captured", "validator replayed", "eager"):
            greedy_nms_keep.launches = blocked_nms_finalize.launches = 0
            k3_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name.startswith("facade"):
                m = model.val(save_json=False, validator=Recorded, **kw)
                g = Recorded.made[-1]._infer.graphs
                stats = (g.calls, g.replays, g.captures, g.warmups)
            elif name == "eager":
                with graphs.eager():
                    m = model.val(save_json=False, **kw)
                stats = (0, 0, 0, 0)
            else:
                g = v._infer and v._infer.graphs
                before = (0, 0, 0, 0) if g is None else (g.calls, g.replays, g.captures, g.warmups)
                v(model=model.model)
                m = v.metrics
                g = v._infer.graphs
                stats = (g.calls - before[0], g.replays - before[1], g.captures - before[2], g.warmups - before[3])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n1, n4, n3 = greedy_nms_keep.launches, blocked_nms_finalize.launches, select_decode.launches
            want_replays = {"validator captured": n_img // bs, "validator replayed": n_img // bs}.get(name, 0)
            if n1 or n4 != n_img // bs + stats[3] or n3 != n4 or stats[1] != want_replays:  # a capture's warm-up too
                raise AssertionError(f"val {dtype} {name}: {n1} K1, {n3} K3 and {n4} K4 launches for {n_img // bs} "
                                     f"batches; (calls, replays, captures) {stats}")
            if m.results_dict != rd:
                raise AssertionError(f"val {dtype} {name}: metrics {m.results_dict} differ from the first run's {rd}")
            launches += n4
            k3_launches += n3
            k3_tally(n3, f"val {dtype} {name}", only="cluster")
            runs[name] = dt
            sp = m.speed
            log(f"val: yolo11n {dtype} batch {bs} at 640, rect, conf 1e-7, {n_img} images, {name}: "
                f"{n_img / dt:.1f} img/s ({dt:.3f} s); speed per image: preprocess {sp['preprocess']:.3f} ms, "
                f"inference {sp['inference']:.3f} ms, postprocess {sp['postprocess']:.3f} ms; mAP50-95 "
                f"{m.results_dict['metrics/mAP50-95(B)']:.5f} (equal to the first run's); K3 and K4 {n4} launches "
                f"each, K1 {n1}; steps on the card {stats[0]}, replayed {stats[1]}, captured {stats[2]} (warm-up runs "
                f"{stats[3]}), on {card}")
        log(f"val: {dtype}: {len(v._infer.graphs)} graphs in the reused validator (one per bucket shape); the graph "
            f"pool holds {graphs.pool_reserved_bytes() / 2 ** 20:.1f} MiB reserved; every run's metrics equal, on "
            f"{card}")

    mixed_sizes_val(card, model, root, Recorded)

    # where one fp32 val run's time goes on the card: torch.profiler over a reused validator's replayed run
    v = DetectionValidator(args=dict(data=str(data), imgsz=640, batch=bs, rect=True, conf=1e-7, plots=False,
                                     verbose=False, project=str(root / "runs"), name="profile", mode="val"))
    for _ in range(2):  # eager, then every bucket shape captured
        v(model=model.model)
    wall, device, events = profile_calls(lambda: v(model=model.model), 1)
    if device is None:
        raise RuntimeError("torch.profiler recorded no device activity in the val run")
    log(f"val: profile of one fp32 run, graphs replayed ({n_img} images, under torch.profiler): {wall:.1f} ms, "
        f"device busy {device:.1f} ms, idle share {1 - device / wall:.3f}, {events} device kernels and copies, on "
        f"{card}")

    # one val batch (the first rect bucket) alone: loader, forward, NMS through K4 and the plain version
    t0 = time.perf_counter()
    ds = YOLODataset(str(root / "val64" / "images" / "val"), imgsz=640, batch_size=bs, rect=True,
                     data={"names": {i: str(i) for i in range(80)}})
    t_ds = time.perf_counter() - t0
    t_load, batches = {}, None
    for workers in (1, 8):  # the same batches at any workers (files in the page cache: the val runs read them)
        t0 = time.perf_counter()
        got = list(DataLoader(ds, batch_size=bs, workers=workers))
        t_load[workers] = time.perf_counter() - t0
        if batches is not None and not all(np.array_equal(a[k], b[k]) for a, b in zip(batches, got)
                                           for k in ("img", "cls", "bboxes", "batch_idx")):
            raise AssertionError(f"val loader: the batches at {workers} workers differ from those at 1")
        batches = got
    t0 = time.perf_counter()
    net = inference_net(model.model, torch.device("cuda"), half=False)
    torch.cuda.synchronize()
    t_net = time.perf_counter() - t0
    log(f"val: host loader alone (decode, letterbox, collate; two batches in flight), {n_img} images: workers 1 "
        f"{n_img / t_load[1]:.1f} img/s ({t_load[1]:.3f} s), workers 8 {n_img / t_load[8]:.1f} img/s "
        f"({t_load[8]:.3f} s), the batches equal; buckets {sorted({b['img'].shape[1:3] for b in batches})}; set-up "
        f"alone: dataset from the label cache {t_ds * 1e3:.1f} ms, fused net copy {t_net * 1e3:.1f} ms, on {card}")
    im = torch.from_numpy(batches[0]["img"]).cuda()
    with torch.inference_mode(), fp32_convs(im.device):
        x = im.float() * (1.0 / 255.0)
        feats = [f.float() for f in forward_nhwc(net, x)]
        args = (feats, model.model.strides, model.model.nc, model.model.reg_max)
        kw_nms = dict(conf_thres=1e-7, iou_thres=0.7, max_det=300, max_cand=VAL_MAX_CAND, multi_label=True)
        captured = []
        real = nms.blocked_nms_finalize
        nms.blocked_nms_finalize = lambda *a: captured.append(a) or real(*a)
        try:
            with_kernel = nms.nms_from_feats(*args, **kw_nms)
        finally:
            nms.blocked_nms_finalize = real
        k4_args, thr, max_det = captured[0][:5], captured[0][5], captured[0][6]
        nms.blocked_nms_finalize = k4_plain
        try:
            with_plain = nms.nms_from_feats(*args, **kw_nms)
        finally:
            nms.blocked_nms_finalize = real
        if not torch.equal(with_kernel, with_plain):
            raise AssertionError("val nms_from_feats at K = 8192 differs between K4 and its plain version")
        log(f"val: nms_from_feats K={VAL_MAX_CAND} multi-label through K4 == through its plain version "
            f"(fp32, batch {bs} at {tuple(im.shape[1:3])}, {int((with_kernel[..., 4] > 0).sum())} detections), "
            f"on {card}")
        peaks = {}
        for name, fn in (("K4", lambda: nms.nms_from_feats(*args, **kw_nms)), ("plain", None)):
            if fn is None:  # the path before K4: the blocked keep (K1 a block, plain cross passes), then _finalize
                nms.blocked_nms_finalize = lambda *a: nms._finalize(a[1], a[2], a[3], nms._blocked_keep(
                    a[0], a[4], a[5]), a[6])
                fn = lambda: nms.nms_from_feats(*args, **kw_nms)
            try:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated() - base, cuda_ms(fn, 10))
            finally:
                nms.blocked_nms_finalize = real
        t_fw = cuda_ms(lambda: forward_nhwc(net, im.float() * (1.0 / 255.0)), 10)
        # K3 on this batch's maps; nms_from_feats with K3 (back to back and by device time) and with its plain version
        k3_args_val = (feats, *args[1:], 1e-7, VAL_MAX_CAND, None, False, True, False)
        k3 = k3_numbers(card, k3_args_val, "val's fp32 maps")
        # the long-row routes on val's fp32 maps, on the half net's bf16 maps (scored in fp32, as the bf16 val does)
        # and on the sparse scene (fewer than K entries pass the gate)
        net16 = inference_net(model.model, torch.device("cuda"), half=True)
        feats16 = forward_nhwc(net16, x.to(torch.bfloat16))
        k3_routes = {"fp32": k3_route_times(card, k3_args_val, "val's fp32 maps"),
                     "bf16": k3_route_times(card, (feats16, *k3_args_val[1:]), "val's bf16 maps"),
                     **{name: k3_route_times(card, k3_args(next(c for c in K3_CASES if c[0] == f"val-{name}")),
                                                f"val-{name}") for name in ("sparse", "bunched", "b72", "b136")}}
        del net16, feats16
        with plain_select():
            same = torch.equal(with_kernel, nms.nms_from_feats(*args, **kw_nms))
            t_plain_select = cuda_ms(lambda: nms.nms_from_feats(*args, **kw_nms), 10)
        t_nms_graph = graph_ms(lambda: nms.nms_from_feats(*args, **kw_nms))
    log(f"val: nms_from_feats K={VAL_MAX_CAND} (fp32, batch {bs}) with K3 and K4 {peaks['K4'][1]:.3f} ms back to back "
        f"({t_nms_graph:.4f} ms device time, graph replay), with K3's plain version and K4 (the path before K3) "
        f"{t_plain_select:.3f} ms; detections {'equal' if same else 'NOT equal'}, on {card}")
    log(f"val: stages alone (fp32, batch {bs} at {tuple(im.shape[1:3])}): forward {t_fw:.3f} ms, nms_from_feats "
        f"K={VAL_MAX_CAND} through K4 {peaks['K4'][1]:.3f} ms, peak {peaks['K4'][0] / 2 ** 20:.1f} MiB; through "
        f"the blocked keep with K1 and the plain cross passes (the path before K4) {peaks['plain'][1]:.3f} ms, peak "
        f"{peaks['plain'][0] / 2 ** 20:.1f} MiB; above the {base / 2 ** 20:.1f} MiB held, on {card}")

    # K4 on val's own inputs (the first fp32 batch's), against its plain version, with its bound
    k4 = k4_numbers(card, k4_args, thr, max_det, "val's fp32 inputs")

    # the card against the CPU at imgsz 160: separating weights, 4 images labelled from the model's own detections
    small_val_card_vs_cpu(card, root, "yolo11n", "yolo11n.yaml")
    tmp.cleanup()
    k3_val = {"launches": k3_launches, "numbers": k3, "routes": k3_routes, "nms_ms": peaks["K4"][1],
              "nms_graph_ms": t_nms_graph,
              "nms_plain_select_ms": t_plain_select}
    return launches, k3_val, {"val_ms": k4["ms"], "val_launch_ms": k4["launch_ms"], "val_plain_ms": k4["plain_ms"],
                      "val_bound_ms": k4["bound_ms"],
                      "val_bound_by": k4["bound_by"], "val_shape": k4["shape"], "val_max_abs_err": k4["max_abs_err"],
                      "val_cluster": k4["cluster"], "val_step": k4["step"],
                      "val_max_active_clusters": k4["max_active_clusters"],
                      "val_nms_ms": peaks["K4"][1], "val_nms_peak_mib": peaks["K4"][0] / 2 ** 20,
                      "blocked_keep_path_nms_ms": peaks["plain"][1],
                      "blocked_keep_path_nms_peak_mib": peaks["plain"][0] / 2 ** 20}


def event_ms(setup, fn, iters: int = 10) -> float:
    """Median milliseconds of fn alone on the card (CUDA events around it), with setup() run untimed before each call."""
    import torch

    times = []
    for i in range(iters + 2):
        arg = setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:  # two warm-up calls
            times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def grad_rel_l2(a, b, floor: float) -> float:
    return float((a - b).norm() / max(float(b.norm()), floor))


@contextlib.contextmanager
def deterministic():
    """torch's deterministic mode inside the block (cuDNN's deterministic algorithms, the sort-based index and
    scatter sums); an op with no deterministic CUDA version warns instead of raising, and its name is added to the
    set yielded. cuBLAS needs CUBLAS_WORKSPACE_CONFIG, which main() sets before the first cuBLAS call."""
    import warnings

    import torch

    before = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    names = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            yield names
        finally:
            torch.use_deterministic_algorithms(before[0], warn_only=before[1])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2], before[3]
            names.update(str(w.message).split(" does not have a deterministic")[0] for w in caught
                         if "does not have a deterministic" in str(w.message))


def train_step_groups(tr) -> dict:
    """A trainer's state after its steps, by group: weights, BN statistics, optimizer moments, EMA (lists of
    tensors)."""
    from yololite_tpu_torch.engine import optim

    named = tr._named_trainable()
    mu, nu = optim.moments(tr.opt_name, tr.optimizer, named)
    return {"weights": list(named.values()),
            "BN statistics": [b for k, b in tr.model.named_buffers() if "running" in k],
            "optimizer moments": [*mu.values(), *nu.values()],
            "EMA": [v for v in tr.ema.ema.state_dict().values() if v.is_floating_point()]}


def record_graph_calls(tr) -> list:
    """Record every call of a trainer's graph cache: (key, "eager", "captured" or "replayed") per call, in order
    (a capture also replays: "captured"). Returns the list it fills."""
    calls = []
    step = tr.graphs.step

    def recording(fn, inputs, key, device, holds=None):
        g = tr.graphs
        before = (g.calls, g.captures, g.replays)
        out = step(fn, inputs, key, device, holds)
        how = ("captured" if g.captures > before[1] else "replayed" if g.replays > before[2] else
               "eager" if g.calls > before[0] else "uncached")
        calls.append((key, how))
        return out

    tr.graphs.step = recording
    return calls


def replays_from_third_sight(calls, kind: str):
    """(calls of `kind`, those replayed without a capture, whether every call after its key's second sight was one)
    from `record_graph_calls`' list."""
    seen, n, replayed, ok = {}, 0, 0, True
    for key, how in calls:
        if key[0] != kind:
            continue
        seen[key] = seen.get(key, 0) + 1
        n += 1
        replayed += how == "replayed"
        ok &= how == ("eager" if seen[key] == 1 else "captured" if seen[key] == 2 else "replayed")
    return n, replayed, ok


def graphed_vs_eager_steps(ov, model_fn, batches, nw: int) -> dict:
    """Trainers from the same start take the same iterations (`batches`, the warmup ramping lr, momentum and
    accumulate over `nw` iterations) in deterministic mode: one through the train graphs, one eagerly
    (`graphs.eager()`) and one more eagerly (the eager-to-eager spread). Returns per group (loss items, fg_mask,
    weights, BN statistics, optimizer moments, EMA) whether graphed equals eager bit for bit and the largest
    |graphed - eager| and |eager - eager|, the graphed trainer's captures, replays and warm-ups by kind of step and
    each graph call (`record_graph_calls`), its applies, its optimizer step, and the ops that have no
    deterministic CUDA version."""
    import numpy as np
    import torch

    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.engine.trainer import DetectionTrainer

    runs = {}
    with deterministic() as nondet:
        for kind in ("graphed", "eager", "eager again"):
            tr = DetectionTrainer(overrides={**ov, "name": f"{ov.get('name', 'steps')}_{kind.replace(' ', '_')}"})
            tr.set_model(model_fn())
            tr._setup_train()
            tr.model.train()
            calls = record_graph_calls(tr)
            items, fg, last, applies = [], [], -1, 0
            with graphs.eager() if kind != "graphed" else contextlib.nullcontext():
                for ni, (staged, _) in enumerate(tr.feed([dict(b) for b in batches])):
                    tr.accumulate, lr_vec, momentum = tr._schedule(ni, nw, 0)
                    apply = tr.fused or ni - last >= tr.accumulate
                    items.append(tr._train_batch(staged, apply, lr_vec, momentum))
                    fg.append(tr.fg_mask)
                    if apply:
                        last, applies = ni, applies + 1
            torch.cuda.synchronize()
            runs[kind] = (tr, {"loss items": items, "fg_mask": fg, **train_step_groups(tr)}, applies, calls)
    tg, g, applies, calls = runs["graphed"]
    te, e, _, _ = runs["eager"]
    _, e2, _, _ = runs["eager again"]
    dist = lambda xs, ys: max(float((x.detach().double() - y.detach().double()).abs().max()) if x.numel() else 0.0
                              for x, y in zip(xs, ys))
    out = {k: {"equal": all(torch.equal(x, y) for x, y in zip(g[k], e[k])), "graphed_eager": dist(g[k], e[k]),
               "eager_eager": dist(e2[k], e[k])} for k in e}
    kinds = {}
    for key in tg.graphs._graphs:
        kinds[key[0]] = kinds.get(key[0], 0) + 1
    return {"groups": out, "captured": kinds, "captures": tg.graphs.captures, "replays": tg.graphs.replays,
            "warmups": tg.graphs.warmups, "calls": tg.graphs.calls, "steps": len(batches), "applies": applies,
            "graph_calls": calls, "step": int(tg.optimizer.step), "eager_step": int(te.optimizer.step),
            "nondeterministic": sorted(nondet), "fused": tg.fused, "accumulate": tg.accumulate}


def graphed_vs_eager_verdict(report: dict) -> str:
    """'bit for bit' when every group of a `graphed_vs_eager_steps` report is equal; else each unequal group held
    within the eager-to-eager spread, named with the ops torch has no deterministic version of. Raises otherwise."""
    bad = {k: v for k, v in report["groups"].items() if not v["equal"]}
    if not bad:
        return "bit for bit"
    over = {k: v for k, v in bad.items() if v["graphed_eager"] > v["eager_eager"]}
    if over or not report["nondeterministic"]:
        raise AssertionError(f"graphed train steps differ from eager beyond the eager-to-eager spread: {bad}; "
                             f"nondeterministic ops {report['nondeterministic']}")
    return ("within the eager-to-eager spread (" + "; ".join(f"{k} {v['graphed_eager']:.3g} <= {v['eager_eager']:.3g}"
                                                            for k, v in bad.items())
            + f"; ops with no deterministic CUDA version: {report['nondeterministic']})")


def host_loader_numbers(card: str, hyp, dinfo, n_images: int) -> None:
    """The train loader alone (mosaic, perspective, HSV, flips), at workers 0, 2, 8 and the host's CPU count: two
    passes each (the first decodes every image once as the buffer fills, as a first epoch does; the second finds them
    in the buffer), its batches at 8 workers checked equal to those at 0, bit for bit; then one batch's host time
    split by stage, on one thread, from a fresh dataset (each item decodes its own image)."""
    import os

    import numpy as np

    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset

    bs, ncpu, keys = int(hyp.batch), os.cpu_count(), ("img", "cls", "bboxes", "batch_idx")
    rates, kept = {}, {}
    for workers in dict.fromkeys((0, 2, 8, ncpu)):
        ds = build_yolo_dataset(hyp, dinfo["train"], bs, dinfo, mode="train")
        loader = build_dataloader(ds, bs, workers, shuffle=True, seed=0)
        rates[workers] = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = [{k: b[k] for k in keys} for b in loader]
            rates[workers].append(n_images / (time.perf_counter() - t0))
            if workers in (0, 8):
                kept.setdefault(workers, []).extend(got)
    if len(kept[0]) != len(kept[8]) or not all(np.array_equal(a[k], b[k]) for a, b in zip(kept[0], kept[8])
                                               for k in keys):
        raise AssertionError("train loader: the batches at 8 workers differ from those at 0")
    log(f"train: host loader alone (mosaic, perspective, HSV, flips: the default recipe; batch {bs} at {hyp.imgsz}, "
        f"{n_images} "
        f"images, two batches in flight), img/s in the first pass (each image decoded once) and the second (the images "
        f"in the buffer) by workers: "
        + "; ".join(f"{w} {r[0]:.1f}, {r[1]:.1f}" for w, r in rates.items())
        + f"; the {2 * len(kept[0])} batches at 8 workers equal those at 0 bit for bit; host {ncpu} CPUs, on {card}")

    for recipe, over in (("the default recipe", {}), ("copy-paste 0.5 and mixup 0.5 added", {"copy_paste": 0.5,
                                                                                            "mixup": 0.5})):
        ds = build_yolo_dataset(get_cfg(overrides={**vars(hyp), **over}), dinfo["train"], bs, dinfo, mode="train")
        chunk = next(build_dataloader(ds, bs, 0, shuffle=True, seed=0)._batches())
        t0 = time.perf_counter()
        items = [ds.plan(i) for i in chunk]
        times = {"plan": time.perf_counter() - t0}
        out = np.empty((len(items), *items[0]["img"].shape), np.uint8)
        for j, item in enumerate(items):
            ds.apply(item, out[j], times)
        t0 = time.perf_counter()
        for item in items:
            item.pop("img")
        ds.collate_fn(items)
        times["collate"] += time.perf_counter() - t0
        total = sum(times.values())
        stages = ("plan", "decode", "mosaic", "copy_paste", "letterbox", "warp", "mixup", "albumentations", "hsv",
                  "flips", "format", "collate")
        log(f"train: one batch's host time by stage ({recipe}; batch {bs} at {hyp.imgsz}, a fresh dataset, one "
            f"thread, host clock): " + ", ".join(f"{k} {times[k] * 1e3:.2f} ms" for k in stages if k in times)
            + f"; total {total * 1e3:.1f} ms ({bs / total:.1f} img/s on one thread), the plan (the label work, all "
            f"Python) {times['plan'] / total:.3f} of it; host {ncpu} CPUs, on {card}")


def train_phase(card: str):
    """yolo11n train at 640 on the card through the facade, its checks and timings.

    Training starts from init(0) with every Detect class bias set to -6: init(0)'s
    priors (-11.5 to -8.8) and its signal, which fades through the eval-mode depth,
    leave no class score above the EMA val's fixed conf of 0.001, so its NMS
    would have nothing to suppress and K4 would never run. Returns the launches
    of K1 (the reload's predict), K4 (the EMA vals and final vals of the
    train and resume runs), K3 (all of those) and K2 (the reload's predict).
    """
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tools.torch_predict_profile import busy_ms
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
    from yololite_tpu_torch.engine import graphs, optim
    from yololite_tpu_torch.engine import validator as validator_mod
    from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs
    from yololite_tpu_torch.data.utils import check_det_dataset
    from yololite_tpu_torch.engine.trainer import TARGET_KEYS, DetectionTrainer
    from yololite_tpu_torch.models import checkpoint as ckpt
    from yololite_tpu_torch.ops import loss_kernels as L
    from yololite_tpu_torch.ops import nms
    from yololite_tpu_torch.ops import optim_kernels as OK
    from yololite_tpu_torch.ops.kernels import blocked_nms_finalize, device_letterbox, greedy_nms_keep, select_decode

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
    write_val_dataset(root / "ds", shapes * 16, seed=20, split="train")  # 64 train images
    data = write_val_dataset(root / "ds", shapes * 4, seed=21, split="val")  # 16 val images
    n_train, bs = 64, 16

    class CheckedTrainer(DetectionTrainer):
        """Checks each epoch's EMA val: K3 and K4 once per val batch of the K = 8192 NMS, K1 never, and (graphed)
        metrics equal to an eager val of the same EMA; records the val graphs' calls, captures and replays per
        epoch, and each train step's graph call (`record_graph_calls`)."""

        def _setup_train(self):
            super()._setup_train()
            self.graph_calls = record_graph_calls(self)

        def validate(self):
            k1, k4, k3 = greedy_nms_keep.launches, blocked_nms_finalize.launches, select_decode.launches
            r3 = select_decode.by_route.as_dict()
            g = self.validator.ema_graphs
            before = (g.calls, g.captures, g.replays)
            stats = super().validate()
            n1, n4 = greedy_nms_keep.launches - k1, blocked_nms_finalize.launches - k4
            n3 = select_decode.launches - k3
            if n1 or n4 != len(self.validator.dataloader) or n3 != n4:
                raise AssertionError(f"train epoch {self.epoch}: EMA val made {n1} K1, {n3} K3 and {n4} K4 launches "
                                     f"for {len(self.validator.dataloader)} batches")
            k3_tally(n3, f"train epoch {self.epoch} EMA val", only="cluster", add=False, less=r3)
            self.val_launches = getattr(self, "val_launches", []) + [n4]
            self.val_graphs = getattr(self, "val_graphs", []) + [
                tuple(a - b for a, b in zip((g.calls, g.captures, g.replays), before))]
            if not graphs._eager:  # the same EMA eagerly: the same metrics, and (the last epoch's) its maps
                k4, k3, r3 = blocked_nms_finalize.launches, select_decode.launches, select_decode.by_route.as_dict()
                real, maps = validator_mod.nms_from_feats, []
                validator_mod.nms_from_feats = lambda feats, *a, **kw: (
                    maps or maps.append(([f.clone() for f in feats], a, kw)), real(feats, *a, **kw))[1]
                try:
                    with graphs.eager():
                        eager = self.validator(trainer=self)
                finally:
                    validator_mod.nms_from_feats = real
                self.ema_maps = maps[0]  # the first batch's
                self.compare_k4 = getattr(self, "compare_k4", 0) + blocked_nms_finalize.launches - k4
                self.compare_k3 = getattr(self, "compare_k3", 0) + select_decode.launches - k3
                self.compare_routes = {r: getattr(self, "compare_routes", {}).get(r, 0) + v - r3[r]
                                       for r, v in select_decode.by_route.as_dict().items()}
                if eager != stats:
                    raise AssertionError(f"train epoch {self.epoch}: the graphed EMA val's metrics {stats} differ "
                                         f"from the eager val's {eager}")
            return stats

    def start_model():
        m = YOLOLite("yolo11n.yaml")  # init(0) on the card
        with torch.no_grad():
            for seq in m.model.detect.cv3:
                seq[2].bias.fill_(-6.0)
        return m

    # (a) the train graphs against the eager steps, in deterministic mode: 10 steps from the same start, all of them
    # in the warmup (lr, momentum and accumulate ramping every step); AdamW in fp32 and bf16 through the grad and
    # apply graphs (nbs 32: accumulate 1 -> 2; one apply graph, lr and momentum device scalars), SGD through the
    # fused graph (nbs 16 at batch 16: accumulate 1); each key's third and later calls replay, warmup included
    hyp = get_cfg(overrides={"data": str(data), "imgsz": 640, "batch": bs, "mode": "train"})
    dinfo = check_det_dataset(str(data))
    loader = build_dataloader(build_yolo_dataset(hyp, dinfo["train"], bs, dinfo, mode="train"), bs, hyp.workers,
                              shuffle=True, seed=0)
    n_steps = 10
    batches = [b for _ in range(3) for b in loader][:n_steps]
    for case, kw in (("AdamW fp32", dict(optimizer="AdamW", nbs=32, amp=False)),
                     ("AdamW bf16", dict(optimizer="AdamW", nbs=32, amp=True)),
                     ("SGD fused", dict(optimizer="SGD", nbs=16, amp=False))):
        ov = {"data": str(data), "imgsz": 640, "batch": bs, "val": False, "save": False, "plots": False,
              "project": str(root / "runs"), "name": case.replace(" ", "_"), **kw}
        t0 = time.perf_counter()
        rep = graphed_vs_eager_steps(ov, lambda: start_model().model, batches, nw=n_steps)
        verdict = graphed_vs_eager_verdict(rep)
        want = {"fused"} if kw["optimizer"] == "SGD" else {"grad", "apply"}
        kind = "fused" if kw["optimizer"] == "SGD" else "apply"
        n_apply, n_replayed, ok = replays_from_third_sight(rep["graph_calls"], kind)
        if (set(rep["captured"]) != want or rep["fused"] != (kw["optimizer"] == "SGD") or not ok or
                n_apply != rep["applies"] or not n_replayed or not rep["step"] == rep["eager_step"] == rep["applies"]):
            raise AssertionError(f"train graphs {case}: captured {rep['captured']}, fused {rep['fused']}, "
                                 f"{kind} calls {n_apply} ({n_replayed} replayed, from the third sight of a key: {ok})"
                                 f", {rep['applies']} applies, optimizer step {rep['step']} (eager "
                                 f"{rep['eager_step']})")
        groups = ", ".join(f"{k} {'equal' if v['equal'] else 'NOT equal'} (max |graphed - eager| "
                           f"{v['graphed_eager']:.3g}, |eager - eager| {v['eager_eager']:.3g})"
                           for k, v in rep["groups"].items())
        log(f"train graphs (a) {case}: {rep['steps']} steps at 640, batch {bs}, all in the warmup (lr, momentum "
            f"and accumulate moving), {rep['applies']} applies ({n_replayed} of them replayed {kind} graphs, every "
            f"call from a key's third sight; the optimizer's device step {rep['step']}), accumulate "
            f"{rep['accumulate']} at the end, deterministic mode: graphed == eager {verdict}; "
            f"{groups}; graphs held by kind {rep['captured']}, {rep['captures']} captures, {rep['replays']} replays "
            f"of {rep['calls']} graph calls, {rep['warmups']} warm-ups; ops torch has no deterministic CUDA version "
            f"of: {rep['nondeterministic'] or 'none'}; {time.perf_counter() - t0:.1f} s, on {card}")

    # one step with the loss-tail kernels against the same step with their plain versions, fp32 and bf16
    def loss_trainer(amp):
        tr = DetectionTrainer(overrides={"data": str(data), "imgsz": 640, "batch": bs, "amp": amp, "val": False,
                                         "save": False, "project": str(root / "runs"),
                                         "name": f"loss_tail_{'bf16' if amp else 'fp32'}"})
        tr.set_model(start_model().model)
        tr._setup_train()
        return tr

    loss_tail_step_check(card, loss_trainer)
    # the compact box/DFL form (K9) against the dense form on the same batch; the end2end loss's two compact heads;
    # the loss's device time by op and the graphed step, in both forms
    compact_dense = compact_vs_dense_step(card, loss_trainer)
    e2e_loss_check(card)
    autograd_tail = loss_tail_autograd(card, loss_trainer)
    step_forms = graphed_step_forms(card, loss_trainer)

    # (b), (c) the facade's train, graphed (fp32 and bf16) and eager (fp32), 3 epochs: the keys repeat from the
    # second step, the EMA val's bucket shapes from the second epoch; every step is in the warmup (100 iterations),
    # and its applies replay the one apply graph from the third; the loss tail's and K10's launches counted in the
    # graphed runs and the resume (a replayed graph adds its capture's)
    step_counted = (*L.COUNTED, OK.optim_apply)
    launches = {"greedy_nms_keep": 0, "blocked_nms_finalize": 0, "select_decode": 0, "device_letterbox": 0,
                **{w.__name__: 0 for w in step_counted}}
    runs = {}
    for amp, mode in ((False, "graphed"), (True, "graphed"), (False, "eager")):
        dtype = "bf16" if amp else "fp32"
        m = start_model()
        greedy_nms_keep.launches = blocked_nms_finalize.launches = 0
        k3_zero()
        for w in step_counted:
            w.launches = 0
        pool0 = graphs.pool_reserved_bytes()
        t0 = time.perf_counter()
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            m.train(trainer=CheckedTrainer, data=str(data), epochs=3, imgsz=640, batch=bs, amp=amp, plots=False,
                    project=str(root / "runs"), name=f"{dtype}_{mode}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = m.trainer
        n, n1 = blocked_nms_finalize.launches - getattr(t, "compare_k4", 0), greedy_nms_keep.launches
        n3 = select_decode.launches - getattr(t, "compare_k3", 0)
        if n1 or n3 != n:
            raise AssertionError(f"train {dtype}: {n1} K1 and {n3} K3 launches; every val NMS is K = 8192 (K3, K4)")
        tail = {w.__name__: w.launches for w in step_counted}
        if not all(tail.values()):
            raise AssertionError(f"train {dtype} {mode}: loss-tail and K10 launches {tail}")
        n_apply, n_replayed, from_third = replays_from_third_sight(t.graph_calls, "apply")
        if mode == "graphed":
            launches["blocked_nms_finalize"] += n
            launches["select_decode"] += n3
            k3_tally(n3, f"train {dtype} {mode}", less=getattr(t, "compare_routes", None))
            for name, v in tail.items():
                launches[name] += v
        rows = np.loadtxt(t.csv, delimiter=",", skiprows=1, ndmin=2)
        if rows.shape[0] != 3 or not np.isfinite(rows).all() or not (rows[:, 1:4] > 0).all():
            raise AssertionError(f"train {dtype}: results.csv rows not finite or not 3 epochs: {rows}")
        for f in (t.last, t.best, t.csv):
            if not Path(f).exists():
                raise AssertionError(f"train {dtype}: {f} missing")
        if t.opt_name != "AdamW" or len(t.val_launches) != 3:
            raise AssertionError(f"train {dtype}: optimizer {t.opt_name}, EMA val launches {t.val_launches}")
        g = t.graphs
        if mode == "graphed":
            n_val = len(t.validator.dataloader)
            if not g.replays or t.val_graphs[2][2] != n_val:
                raise AssertionError(f"train {dtype}: {g.replays} train step replays; EMA val graphs (calls, "
                                     f"captures, replays) per epoch {t.val_graphs}, {n_val} batches")
            if n_apply != 12 or n_replayed < 10 or not from_third:
                raise AssertionError(f"train {dtype}: {n_replayed} of {n_apply} applies replayed (from the third "
                                     f"sight: {from_third}); the warmup's applies replay the one apply graph")
        elif g.calls:
            raise AssertionError(f"train {dtype} eager: {g.calls} graph calls")
        runs[(dtype, mode)] = t
        ips = [n_train / s_ for s_ in t.train_seconds]
        log(f"train: yolo11n {dtype} {mode} at 640, batch {bs}, {n_train} images, 3 epochs, mosaic, AdamW (auto): "
            f"epoch loop without val {', '.join(f'{s_:.3f} s ({v:.1f} img/s)' for s_, v in zip(t.train_seconds, ips))}; "
            f"whole train() {wall:.2f} s; loss items per epoch {rows[:, 1:4].round(5).tolist()}; train steps "
            f"{g.calls} on the card, {g.captures} captured, {g.replays} replayed ({len(t._step_shapes)} (shape, M) "
            f"variants, graphs held by kind {sorted(k[0] for k in g._graphs)}); applies {n_apply}, {n_replayed} of "
            f"them replayed (all {n_apply} in the warmup's ramp of lr and momentum); EMA val graphs (calls, captures, "
            f"replays) per epoch {t.val_graphs}, metrics equal to an eager val each epoch; loss-tail and K10 launches "
            f"{tail}; K4 launches {n} "
            f"(and {getattr(t, 'compare_k4', 0)} in those eager vals) "
            f"({t.val_launches} in the EMA vals, the rest in the final val of best.npz: one batch, seen once, so "
            f"eager); graph pool {graphs.pool_reserved_bytes() / 2 ** 20:.1f} MiB reserved (+"
            f"{(graphs.pool_reserved_bytes() - pool0) / 2 ** 20:.1f} in this run), "
            f"{graphs.pool_allocated_bytes() / 2 ** 20:.1f} MiB of it held by live blocks, on {card}")

    # K3's long-row routes on the EMA val's own maps (the last epoch's first batch, from the eager val beside the
    # graphed one; scored in fp32 as the EMA val scores them): the class biases start at -6, so that the scores bunch
    for dtype in ("fp32", "bf16"):
        feats, a, kw = runs[(dtype, "graphed")].ema_maps
        K3_EMA_ROUTES[dtype] = k3_route_times(card, (feats, *a, kw["conf_thres"], kw["max_cand"], kw.get("class_mask"),
                                                     kw.get("half", False), kw["multi_label"], kw["agnostic"]),
                                              f"the {dtype} train's EMA val, epoch 3, batch 0")

    # the fused form through the facade: nbs 16 at batch 16 (accumulate 1 for the whole run), fp32 and bf16, 3
    # epochs without val: one fused graph per (shape, M) key, replayed from the key's third sight through the warmup
    for amp in (False, True):
        dtype = "bf16" if amp else "fp32"
        m = start_model()
        for w in step_counted:
            w.launches = 0
        t0 = time.perf_counter()
        m.train(trainer=CheckedTrainer, data=str(data), epochs=3, imgsz=640, batch=bs, nbs=bs, amp=amp, val=False,
                plots=False, project=str(root / "runs"), name=f"{dtype}_fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = m.trainer
        tail = {w.__name__: w.launches for w in step_counted}
        n_fused, n_replayed, from_third = replays_from_third_sight(t.graph_calls, "fused")
        rows = np.loadtxt(t.csv, delimiter=",", skiprows=1, ndmin=2)
        if (not t.fused or not all(tail.values()) or n_fused != 12 or not n_replayed or not from_third or
                rows.shape[0] != 3 or not np.isfinite(rows).all()):
            raise AssertionError(f"train {dtype} fused: fused {t.fused}, {n_replayed} of {n_fused} fused steps "
                                 f"replayed (from the third sight: {from_third}), launches {tail}, results {rows}")
        for name, v in tail.items():
            launches[name] += v
        g = t.graphs
        log(f"train: yolo11n {dtype} fused (nbs {bs}: accumulate 1) at 640, batch {bs}, {n_train} images, 3 epochs, "
            f"no val: epoch loop {', '.join(f'{s_:.3f} s' for s_ in t.train_seconds)}, whole train() {wall:.2f} s; "
            f"{n_fused} fused steps, {n_replayed} replayed ({len(t._step_shapes)} (shape, M) keys; all in the "
            f"warmup's ramp of lr and momentum); graphs held by kind {sorted(k[0] for k in g._graphs)}; loss items per "
            f"epoch {rows[:, 1:4].round(5).tolist()}; loss-tail and K10 launches {tail}, on {card}")

    # reload best.npz and predict; resume last.npz for one more epoch with the optimizer state restored
    t32 = runs[("fp32", "graphed")]
    frames = [np.random.default_rng(22).integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    greedy_nms_keep.launches = device_letterbox.launches = 0
    k3_zero()
    res = YOLOLite(str(t32.best)).predict(frames, imgsz=640, conf=1e-7, batch=4, save=False, verbose=False)
    if (select_decode.launches, device_letterbox.launches) != (greedy_nms_keep.launches, 1):
        raise AssertionError(f"predict from best.npz: K1 {greedy_nms_keep.launches}, K3 {select_decode.launches}, "
                             f"K2 {device_letterbox.launches} launches (the warm-up and one call)")
    launches["greedy_nms_keep"] += greedy_nms_keep.launches
    launches["select_decode"] += select_decode.launches
    k3_tally(select_decode.launches, "predict from best.npz", only="finish")
    launches["device_letterbox"] += device_letterbox.launches
    if len(res) != 4 or not all(len(r) and np.isfinite(r.boxes.data).all() for r in res):
        raise AssertionError("predict from best.npz: no detections or not finite")
    restored = {}

    class ResumeChecked(CheckedTrainer):
        def resume_training(self, blob):
            super().resume_training(blob)
            _, state, meta = blob
            named = self._named_trainable()
            mu, nu = optim.moments(self.opt_name, self.optimizer, named)
            want_mu = ckpt.tensors_of(self.model, state["opt"]["mu"], named)
            want_nu = ckpt.tensors_of(self.model, state["opt"]["nu"], named)
            if not all(torch.equal(mu[k].cpu(), want_mu[k]) and torch.equal(nu[k].cpu(), want_nu[k]) for k in named):
                raise AssertionError("resume: optimizer moments differ from last.npz's")
            restored.update(step=int(self.optimizer.step), epoch=self.start_epoch, updates=self.ema.updates,
                            saved_epoch=meta["epoch"])

    blocked_nms_finalize.launches = 0
    k3_zero()
    for w in step_counted:
        w.launches = 0
    rt = ResumeChecked(overrides={"resume": str(t32.last)})
    rt.epochs = 4
    rt.train()
    for w in step_counted:
        if not w.launches:
            raise AssertionError(f"resume: {w.__name__} never launched")
        launches[w.__name__] += w.launches
    launches["blocked_nms_finalize"] += blocked_nms_finalize.launches - getattr(rt, "compare_k4", 0)
    launches["select_decode"] += select_decode.launches - getattr(rt, "compare_k3", 0)
    k3_tally(select_decode.launches - getattr(rt, "compare_k3", 0), "resume", less=getattr(rt, "compare_routes", None))
    n_apply, n_replayed, from_third = replays_from_third_sight(rt.graph_calls, "apply")
    if (restored.get("epoch") != 3 or restored["saved_epoch"] != 2 or rt.epoch != 3 or restored["step"] < 1 or
            restored["step"] != restored["updates"] or int(rt.optimizer.step) != restored["step"] + n_apply or
            not from_third):
        raise AssertionError(f"resume: {restored}, ran to epoch {rt.epoch}, optimizer step {int(rt.optimizer.step)} "
                             f"after {n_apply} applies ({n_replayed} replayed, from the third: {from_third})")
    log(f"train: best.npz predicts on the card ({[len(r) for r in res]} detections); resume from last.npz (epoch "
        f"{restored['saved_epoch']}) ran epoch {rt.epoch + 1} with AdamW at step {restored['step']} and "
        f"{restored['updates']} EMA updates restored, moments equal to the file's; its {n_apply} applies advanced "
        f"the device step to {int(rt.optimizer.step)}, {n_replayed} of them replayed, on {card}")

    # one val batch inside the trainer: the EMA net's maps through nms_from_feats with K4 and its plain version
    vb = next(iter(t32.validator.dataloader))
    with torch.inference_mode(), fp32_convs(torch.device("cuda")):
        x = torch.from_numpy(vb["img"]).cuda().float() * (1.0 / 255.0)
        feats = [f.float() for f in forward_nhwc(t32.ema.ema, x)]
        args = (feats, t32.model.strides, t32.model.nc, t32.model.reg_max)
        kw_nms = dict(conf_thres=0.001, iou_thres=0.7, max_det=300, max_cand=8192, multi_label=True)
        with_kernel = nms.nms_from_feats(*args, **kw_nms)
        nms.blocked_nms_finalize = k4_plain
        try:
            with_plain = nms.nms_from_feats(*args, **kw_nms)
        finally:
            nms.blocked_nms_finalize = blocked_nms_finalize
    if not torch.equal(with_kernel, with_plain) or not int((with_kernel[..., 4] > 0).sum()):
        raise AssertionError("train's EMA val: nms_from_feats differs between K4 and its plain version")
    log(f"train: EMA val batch {tuple(x.shape)}: nms_from_feats K=8192 multi-label through K4 == through its plain "
        f"version ({int((with_kernel[..., 4] > 0).sum())} detections), on {card}")

    # the one-process fp32 step against the float64 step at 640, batch 16 (SGD, lr 100), with the trainer's
    # NCHW-contiguous batch and, for the record, with the channels-last batch it fed the card before
    step_against_float64(card, root, data)

    # the host loader alone, with mosaic, by workers, and one batch's host time by stage
    hyp = get_cfg(overrides={"data": str(data), "imgsz": 640, "batch": bs, "mode": "train"})
    host_loader_numbers(card, hyp, check_det_dataset(str(data)), n_train)

    # one step's stages alone on a batch of 16 at 640 (CUDA events), its peak memory graphed and eager, per dtype
    for amp in (False, True):
        dtype = "bf16" if amp else "fp32"
        st = DetectionTrainer(overrides={"data": str(data), "imgsz": 640, "batch": bs, "amp": amp, "val": False, "save": False,
                              "project": str(root / "runs"), "name": f"stages_{dtype}"})
        st.set_model(start_model().model)
        st._setup_train()
        pool0 = graphs.pool_reserved_bytes()
        batch = next(iter(st.train_loader))
        images = torch.from_numpy(batch["img"]).cuda()
        targets = st._targets(batch)
        lr, mom = np.full(3, 1e-4, np.float32), 0.9
        with fp32_convs(images.device):
            fw = event_ms(lambda: None, lambda _: st._forward(images))
            loss = event_ms(lambda: st._forward(images), lambda f: st.loss_fn(f, targets))
            bw = event_ms(lambda: st.loss_fn(st._forward(images), targets)[0], lambda tot: tot.backward())
            torch._foreach_zero_(st._grads)
            opt = event_ms(lambda: st._grad_step(images, targets), lambda _: st._apply_step(lr, mom))  # replayed
            with graphs.eager():
                opt_eager = event_ms(lambda: st._grad_step(images, targets), lambda _: st._apply_step(lr, mom))
            step = event_ms(lambda: None, lambda _: (st._grad_step(images, targets), st._apply_step(lr, mom)))
            with graphs.eager():
                step_eager = event_ms(lambda: None, lambda _: (st._grad_step(images, targets),
                                                              st._apply_step(lr, mom)))
            peaks = {}
            for mode in ("graphed", "eager"):
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    for w in L.COUNTED:
                        w.launches = 0
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    st._grad_step(images, targets)
                    st._apply_step(lr, mom)
                    torch.cuda.synchronize()
                    peaks[mode] = (torch.cuda.max_memory_allocated() - base, base,
                                   tuple(w.launches for w in L.COUNTED))
        g = st.graphs
        log(f"train: one step's stages alone ({dtype}, batch {bs} at 640, CUDA events, median of 10): forward "
            f"{fw:.3f} ms, loss incl. TAL {loss:.3f} ms, backward {bw:.3f} ms (eager, each alone); clip + AdamW + EMA "
            f"{opt:.3f} ms replayed, {opt_eager:.3f} eager; the whole step (grad + apply) {step:.3f} ms replayed, "
            f"{step_eager:.3f} eager; M = {targets['gt_bboxes'].shape[1]}; step's peak above the "
            f"{peaks['eager'][1] / 2 ** 20:.1f} MiB held: graphed {peaks['graphed'][0] / 2 ** 20:.1f} MiB (its "
            f"activations live in the graph pool: {graphs.pool_reserved_bytes() / 2 ** 20:.1f} MiB reserved, "
            f"+{(graphs.pool_reserved_bytes() - pool0) / 2 ** 20:.1f} for this trainer's captures), eager "
            f"{peaks['eager'][0] / 2 ** 20:.1f} MiB; loss-tail launches per step "
            f"({', '.join(w.__name__ for w in L.COUNTED)}) graphed {peaks['graphed'][2]} (a replay adds its "
            f"capture's), eager {peaks['eager'][2]}; the graphed step before the loss-tail kernels took 48.8-49.8 ms "
            f"fp32 and 19.0-19.2 bf16 (NVIDIA H100 80GB HBM3, 700 W); "
            f"{g.captures} captures, {g.replays} replays, on {card}")

    # where an epoch loop's wall time goes (fp32 graphed and eager, bf16 graphed), on the loader at the default
    # workers, the batches through the trainer's feed: blocked on the feed (the loader, or the feed's staging), handing
    # the batch over (the step's stream waits on its copy), enqueueing the step (a replay: the graph launch and the
    # copies in and out), waiting for the card; every step in the warmup's ramp (lr and momentum moving), as the first
    # 100 iterations of a run are. A fourth pass, the same way under torch.profiler, gives the batches' copies on the
    # card: ms, GB/s and the share of each copy that kernels overlapped
    def loop_pass(lt, dtype):
        """One pass of lt's loader through its feed, a sync after each step: the host seconds by part, each step's
        host enqueue and whether it captured a graph, the pass's seconds."""
        feed = lt.feed(lt.train_loader)
        it, up = iter(feed), feed.upload
        parts = dict.fromkeys(("feed", "handover", "enqueue", "device"), 0.0)
        per_step = []
        t_loop = time.perf_counter()
        while True:
            t0, h0 = time.perf_counter(), up.handover_s
            got = next(it, None)
            t1, hand = time.perf_counter(), up.handover_s - h0
            if got is None:
                break
            staged = got[0]
            captures = lt.graphs.captures
            _, lr_vec, momentum = lt._schedule(ni[dtype], 100, 0)
            ni[dtype] += 1
            lt._grad_step(staged["img"], {k: staged[k] for k in TARGET_KEYS})
            lt._apply_step(lr_vec, momentum)
            t3 = time.perf_counter()
            per_step.append((t3 - t1, lt.graphs.captures > captures))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0 - hand, hand, t3 - t1, t4 - t3)):
                parts[k] += dt
        return parts, per_step, time.perf_counter() - t_loop

    loop_trainers, ni = {}, {}
    for dtype, mode in (("fp32", "graphed"), ("fp32", "eager"), ("bf16", "graphed")):
        if dtype not in loop_trainers:
            lt = DetectionTrainer(overrides={"data": str(data), "imgsz": 640, "batch": bs, "val": False,
                                             "save": False, "amp": dtype == "bf16", "project": str(root / "runs"),
                                             "name": f"loop_{dtype}"})
            lt.set_model(start_model().model)
            lt._setup_train()
            loop_trainers[dtype], ni[dtype] = lt, 0
        lt = loop_trainers[dtype]
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            for rep in range(3):  # the first passes fill the image buffer, warm cuDNN and capture the keys
                counts = (lt.graphs.calls, lt.graphs.captures, lt.graphs.replays)
                parts, per_step, t_loop = loop_pass(lt, dtype)
            calls, captures, replays = (a - b for a, b in zip((lt.graphs.calls, lt.graphs.captures,
                                                               lt.graphs.replays), counts))
            last = ni[dtype] - 1
            with htod_profile() as (prof, uploads):
                loop_pass(lt, dtype)
        copies = htod_copies(prof, uploads, f"train {dtype} {mode} loop, a fourth pass")
        steps = len(lt.train_loader)
        ms = {k: v * 1e3 for k, v in parts.items()}
        log(f"train: one {dtype} epoch loop taken apart, {mode}, its third pass ({n_train} images, {steps} steps in "
            f"the warmup's ramp, iterations {last - steps + 1}-{last} of 100, loader at {lt.args.workers} "
            f"workers: blocked on the feed {ms['feed'] / steps:.1f} ms a step beside the card's "
            f"{(ms['enqueue'] + ms['device']) / steps:.1f} ms a step from the step's enqueue to its end; "
            f"{calls} graph calls: {replays} replayed ({captures} of them captured in this pass), {calls - replays} "
            f"eager at a key's first sight; host clock, a sync after each step): "
            f"{t_loop * 1e3:.1f} ms = blocked on the feed (the loader, or the feed's staging) {ms['feed']:.1f} ms + "
            f"handing the batch and its targets over {ms['handover']:.3f} ms ({ms['handover'] / steps:.4f} ms a step) "
            f"+ host enqueueing forward, loss, backward, clip, AdamW and EMA {ms['enqueue']:.1f} ms "
            f"({ms['enqueue'] / steps:.1f} ms a step) + waiting for the card after that {ms['device']:.1f} ms "
            f"({ms['device'] / steps:.1f} ms a step); the enqueue of a step without a capture "
            f"{', '.join(f'{e * 1e3:.1f}' for e, c in per_step if not c)} ms, of a step with one "
            f"{', '.join(f'{e * 1e3:.1f}' for e, c in per_step if c) or '-'} ms; a fourth pass the same way under "
            f"torch.profiler: {copies_text(copies)}, on {card}")

    # the loop as `_train_epochs` runs it (no sync a step), graphed, on the warm trainers above (graphs captured, the
    # images in the buffer): two passes under torch.profiler. The loop's ms a step, the steps' spans on the card (CUDA
    # events), the feed's hand-over, and the batches' copies on the card (the trace): ms, GB/s and the share of each
    # batch's copy after a pass's first that kernels overlapped
    for dtype in ("fp32", "bf16"):
        lt, spans = loop_trainers[dtype], []
        with htod_profile() as (prof, uploads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                for staged, _ in lt.feed(lt.train_loader):
                    _, lr_vec, momentum = lt._schedule(ni[dtype], 100, 0)
                    ni[dtype] += 1
                    span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    span[0].record()
                    lt._grad_step(staged["img"], {k: staged[k] for k in TARGET_KEYS})
                    lt._apply_step(lr_vec, momentum)
                    span[1].record()
                    spans.append(span)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        copies = htod_copies(prof, uploads, f"train {dtype} loop")
        on_card = sum(a.elapsed_time(b) for a, b in spans)
        log(f"train: the {dtype} epoch loop as _train_epochs runs it (graphed, warm, no sync a step, 2 passes of "
            f"{len(spans) // 2} steps under torch.profiler): {wall * 1e3 / len(spans):.1f} ms a step, "
            f"{n_train * 2 / wall:.1f} img/s, the steps' spans on the card {on_card / len(spans):.1f} ms a step; "
            f"{copies_text(copies)}; {handover_text(uploads)}, on {card}")

    # the device's idle share over a 2-epoch train (fp32, no val, no save) under torch.profiler, graphed and eager;
    # the host-to-device copies in its trace by the source's kind (every batch from page-locked memory) and the share
    # of each batch's copy that kernels overlapped; then one epoch with the EMA val, the same way
    for mode, epochs, val in (("graphed", 2, False), ("eager", 2, False), ("graphed", 1, True)):
        pt = DetectionTrainer(overrides={"data": str(data), "imgsz": 640, "batch": bs, "epochs": epochs, "val": val,
                                         "save": False, "project": str(root / "runs"),
                                         "name": f"profile_{mode}{'_val' if val else ''}"})
        m = start_model().model
        pt.set_model(m)
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            with htod_profile() as (prof, uploads):
                t0 = time.perf_counter()
                pt.train()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        copies = htod_copies(prof, uploads, f"train {mode}{' with the EMA val' if val else ''}")
        if val:
            fed = {"train": sum(u.batches for u in uploads if u.ring is pt._ring),
                   "val": sum(u.batches for u in uploads if u.ring is pt.validator._ring)}
            if fed != {"train": n_train // bs, "val": len(pt.validator.dataloader)}:  # no save: no final val
                raise AssertionError(f"train with val: batches fed {fed}")
            log(f"train: one fp32 epoch, graphed, with the EMA val ({n_train} train and 16 val "
                f"images, under torch.profiler): batches fed {fed}; {copies_text(copies)}; "
                f"{handover_text(uploads)}, on "
                f"{card}")
            continue
        on_device = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        if not on_device:
            raise RuntimeError("torch.profiler recorded no device activity in the train epochs")
        by_name = {}
        for e in on_device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        device = busy_ms((e.time_range.start, e.time_range.end) for e in on_device)
        loop = sum(pt.train_seconds) * 1e3
        top = ", ".join(f"{k[:48]} {v:.2f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
        log(f"train: profile of a 2-epoch fp32 train, {mode} ({n_train} images, no val, under torch.profiler): "
            f"train() {wall:.1f} ms, epoch loops {loop:.1f} ms ({', '.join(f'{x * 1e3:.1f}' for x in pt.train_seconds)}"
            f"), device busy {device:.1f} ms, idle share of the epoch loops {1 - device / loop:.3f}, "
            f"{len(on_device)} device kernels and copies; {pt.graphs.captures} captures, {pt.graphs.replays} replays "
            f"of {pt.graphs.calls} graph calls; top ms: {top}; {copies_text(copies)}; {handover_text(uploads)}; "
            f"on {card}")

    # K5, K6a, K6b (forward and backward) and K7 at the train step's shapes, beside their plain versions and bounds
    launches["loss_tail"] = loss_tail_numbers(card)
    launches["loss_tail_autograd"] = autograd_tail
    # K9 (forward and backward) at the train step's shapes, beside its plain version, bound and library calls
    launches["compact_rows_numbers"] = compact_rows_numbers(card)
    launches["compact_vs_dense"] = compact_dense
    launches["step_forms"] = step_forms

    # the card against the CPU: one SGD step at imgsz 160, batch 2, fp32, the same weights and batch
    one_step_card_vs_cpu(card, root, "yolo11n", "yolo11n.yaml", data)
    tmp.cleanup()
    return launches


def int8_conv_bound_ms(x_shape, x_bytes: int, w_shape, out_shape, out_bytes: int):
    """Least time of one K8 call on these shapes, and what bounds it ("bytes" or "operations").

    Bytes: x read once (int8, or bf16 / fp32 when K8 quantizes it in its
    load), w once (int8), scale and bias (fp32), the output written once (int8
    or bf16). Operations: 2 per multiply-add of the convolution, at the card's
    int8 tensor-core rate.
    """
    b, cin, h, w = x_shape
    cout, kh, kw, cin_g = w_shape
    ho, wo = out_shape[2:]
    by_bytes = (b * cin * h * w * x_bytes + cout * kh * kw * cin_g + 8 * cout + b * cout * ho * wo * out_bytes
                ) / HBM_BYTES_PER_S
    by_ops = 2 * b * cout * ho * wo * kh * kw * cin_g / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median device milliseconds per call of fn: `iters` calls captured in one CUDA graph, the graph replayed
    `reps` times between CUDA events, so the host's enqueue of each call is outside the timing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture (first-call set-up)
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[len(times) // 2]


def k8_build_report(lib_path: Path) -> str:
    """ptxas's registers and spills for each K8 kernel (from the build log), and the count of warpgroup MMA
    instructions (*GMMA) in the library's SASS (cuobjdump -sass)."""
    from yololite_tpu_torch.ops import cuda_build

    rows, name = [], None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"int8_conv_(gemm|depthwise|direct|stem|1x1)(?:ILi(\d+)E(?:Li(\d+)E)?)?", m.group(1))
            second = "WG" if k is not None and k.group(1) == "gemm" else "min blocks"  # 1x1<BN, MINB>
            name = None if k is None else k.group(1) if k.group(2) is None else (
                f"{k.group(1)}<N {k.group(2)}" + (f", {second} {k.group(3)}>" if k.group(3) else ">"))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} regs, {spills}")
            name = None
    cuobjdump = str(Path(cuda_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    gmma = [ln for ln in sass.splitlines() if re.search(r"\b[A-Z]?GMMA\b", ln)]
    ops = sorted({re.search(r"\b([A-Z]?GMMA[.\w]*)", ln).group(1) for ln in gmma})
    return (f"ptxas per kernel: {'; '.join(rows)}; SASS: {len(gmma)} warpgroup MMA instructions "
            f"({', '.join(ops[:8])})"), len(gmma)


def k4_build_report(lib_path: Path) -> str:
    """ptxas's registers and spills for K4's kernel, from the build log, and its SASS instructions (cuobjdump -sass;
    the library has the one kernel)."""
    from yololite_tpu_torch.ops import cuda_build

    log = lib_path.with_suffix(".log").read_text()
    entry = log[log.index("blocked_nms_cluster_kernel"):]
    regs = re.search(r"Used (\d+) registers", entry).group(1)
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
    cuobjdump = str(Path(cuda_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    n = len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass[sass.index("blocked_nms_cluster_kernel"):]))
    return (f"ptxas: blocked_nms_cluster_kernel {regs} regs, {spills.group(1)}/{spills.group(2)} B spilled; "
            f"{n} SASS instructions")


def loss_tail_build_report(lib_path: Path) -> str:
    """ptxas's registers, stack frame and spills for each kernel of a loss-tail library (csrc/dfl.cu,
    csrc/bce_sum.cu, csrc/topk_rows.cu), from its build log; the names demangled by the toolkit's cu++filt where it
    has one."""
    from yololite_tpu_torch.ops import cuda_build

    rows, name, frame = [], None, ""
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            frame = f"{m.group(1)} B stack, {m.group(2)}/{m.group(3)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m.group(1)} regs, {frame}"))
            name, frame = None, ""
    filt = Path(cuda_build.nvcc()).with_name("cu++filt")
    names = [n for n, _ in rows]
    if filt.exists() and names:
        out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [re.sub(r"\([^()]*\)$", "", re.sub(r"\(anonymous namespace\)::|<unnamed>::|void |\(int\)", "", n))
                     for n in out.stdout.splitlines()]
    return "; ".join(f"{n}: {r}" for n, (_, r) in zip(names, rows))


def conv_kind(x, mod) -> str:
    cout, kh, kw, cin_g = mod.weight.shape
    return "stem" if x.shape[1] == 3 else "depthwise" if mod.groups > 1 else f"{kh}x{kw}"


K8_PICKS = ("gemm", "gemm1x1")  # the routes int8_conv_pick can name: route 1 and gemm1x1


def k8_routes(name: str, x, mod, args, y) -> dict:
    """One 1x1 conv (groups 1) on each of K8's routes that can run it (`K8_PICKS`), each asserted equal to the
    forward's output y, on x as the forward hands it (a channel-split view read in place), and torch._int_mm on the
    same product (int32 out, no epilogue), timed in turns (a, b, .., b, a, the mean of the two).
    Returns {route: ms or None, "int_mm": ms, f"{route}_plan": plan}."""
    import torch

    from yololite_tpu_torch.ops.kernels import _int8_conv_launch, int8_conv_plan, quantize_act

    out, fns = {}, {}
    for pick in K8_PICKS:
        plan = int8_conv_plan(x, mod.weight, y, mod.groups, mod.stride, mod.padding, pick=pick)
        out[f"{pick}_plan"] = plan
        out[pick] = None
        if plan["route"] is None:
            continue
        if not torch.equal(_int8_conv_launch(*args, pick=pick), y):
            raise AssertionError(f"{name}: {tuple(x.shape)} -> {tuple(y.shape)}: the {pick} route's output differs")
        fns[pick] = lambda pick=pick: _int8_conv_launch(*args, pick=pick)
    cout, _, _, cin = mod.weight.shape
    xq = x if x.dtype == torch.int8 else quantize_act(x, mod.sin)
    a2 = xq.permute(0, 2, 3, 1).reshape(-1, cin)  # a copy where x is a channel-split view, made outside the timing
    b2 = mod.weight.reshape(cout, cin).t()
    fns["int_mm"] = lambda: torch._int_mm(a2, b2)
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(graph_ms(fns[k]))
    out.update({k: sum(v) / len(v) for k, v in times.items()})
    return out


def k8_on_convs(card: str, pred, frames, n_convs: int, name: str, time_plain: bool) -> dict:
    """K8 against its plain version (every output equal), and timed by device time, on every quantized conv of
    one int8 forward of `pred` on `frames`; with each conv's bound, the route plan() picks, and each 1x1 conv on both
    routes and torch._int_mm (`k8_routes`). A conv's `ms` is `int8_conv`'s on the input as the forward hands it; the
    forward must copy no input (`int8_conv.copies` 0). Sums by kind against their bounds; the 3x3 convs' own, and the
    1x1 convs on gemm1x1, on route 1 and torch._int_mm. Writes each conv's row to chiprun_out/k8_<name>_convs.tsv
    (b<batch> appended below batch 32)."""
    import numpy as np
    import torch

    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.models import modules as M
    from yololite_tpu_torch.ops.kernels import int8_conv, int8_conv_plain, int8_conv_plan, x_pitch

    calls = []
    hooks = [m.register_forward_hook(lambda mod, i, y: calls.append((mod, i[0], i[1], y)))
             for m in pred.net.modules() if isinstance(m, M.QConv)]
    try:
        raw = torch.from_numpy(np.stack(frames)).cuda().flip(-1)
        int8_conv.copies = 0
        with graphs.eager():  # hooks run in the eager forward, not in a replay
            pred.infer_uint8(raw, 640)
        copies = int8_conv.copies
    finally:
        for h in hooks:
            h.remove()
    if len(calls) != n_convs:
        raise AssertionError(f"{name}: {len(calls)} quantized conv calls in one int8 forward, not {n_convs}")
    if copies:
        raise AssertionError(f"{name}: int8_conv copied {copies} inputs before the kernel in one int8 forward")
    bs = len(frames)
    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes", "ops", "edge_ms", "edge_bound"), 0.0)
    sums = {k: dict.fromkeys(("ms", "bound_ms", "route1_ms", "new_ms", "int_mm_ms"), 0.0) for k in ("3x3", "1x1")}
    slower, kinds, routes, rows = [], {}, {}, []
    differ = total = split = 0
    with torch.inference_mode():
        for mod, x, act, y in calls:
            kind = conv_kind(x, mod)
            cout, kh, kw_, cin_g = mod.weight.shape
            is_1x1 = kh == kw_ == 1 and mod.stride == 1 and mod.groups == 1
            args = (x, mod.weight, mod.scale, mod.bias, mod.stride, mod.padding, mod.groups, act, mod.sout or 0.0,
                    mod.sin_value)
            want = int8_conv_plain(*args)
            differ += int((y != want).sum())
            total += want.numel()
            pitch = x_pitch(x)
            split += pitch != x.shape[1]
            ms = graph_ms(lambda: int8_conv(*args))
            bound, by = int8_conv_bound_ms(tuple(x.shape), x.element_size(), tuple(mod.weight.shape),
                                           tuple(y.shape), y.element_size())
            plan = int8_conv_plan(x, mod.weight, y, mod.groups, mod.stride, mod.padding)
            route = plan["route"] + (f" N{plan['n_tile']} M{plan['m_tile']}" if plan["route"] in ("gemm", "gemm1x1")
                                     else "")
            routes[route] = routes.get(route, 0) + 1
            if kind in sums:
                sums[kind]["ms"] += ms
                sums[kind]["bound_ms"] += bound
            r = k8_routes(name, x, mod, args, y) if is_1x1 and kind == "1x1" else None
            if r is not None:
                s = sums["1x1"]
                s["route1_ms"] += r["gemm"] if r["gemm"] is not None else ms
                s["new_ms"] += r["gemm1x1"] if r["gemm1x1"] is not None else ms
                s["int_mm_ms"] += r["int_mm"]
                alt = [v for k, v in r.items() if k in K8_PICKS and k != plan["route"] and v is not None]
                if alt and r[plan["route"]] > min(alt):
                    slower.append(f"{tuple(x.shape)} {x.dtype} -> {cout} s{mod.stride} {y.dtype}: {plan['route']} "
                                  f"{r[plan['route']]:.4f} vs {min(alt):.4f} ms")
            if x.dtype != torch.int8 and is_1x1:
                tot["edge_ms"] += ms
                tot["edge_bound"] += bound
            q = plan
            row = [kind, tuple(x.shape), x.dtype, pitch, tuple(mod.weight.shape), f"s{mod.stride}", y.dtype, route,
                   f"{ms:.4f}", f"{bound:.4f}", by]
            row += ["" if r is None or r.get(k) is None else f"{r[k]:.4f}" for k in (*K8_PICKS, "int_mm")]
            row += [q["blocks_per_sm"], q["n_groups"] or "", q["a_sets"] or "", int(q["whole_table"]), q["smem"]]
            rows.append("\t".join(str(v) for v in row))
            k = kinds.setdefault(kind, {"n": 0, "ms": 0.0, "bound_ms": 0.0})
            k["n"] += 1
            k["ms"] += ms
            k["bound_ms"] += bound
            tot["ms"] += ms
            tot["bound_ms"] += bound
            tot["bytes" if by == "bytes" else "ops"] += bound
            if time_plain:
                tot["plain_ms"] += cuda_ms(lambda: int8_conv_plain(*args), 2, warmup=1)
    del calls
    out = Path("chiprun_out")  # each conv's row, for the record
    out.mkdir(exist_ok=True)
    head = ("kind\tx\tx dtype\tpitch\tw\tstride\tout dtype\troute (plan)\tms (int8_conv)\tbound ms\tbound by\t"
            "route 1 ms\tgemm1x1 ms\ttorch._int_mm ms\tblocks an SM\tN groups\tA sets\twhole table\tshared memory\n")
    (out / f"k8_{name}_convs{'' if bs == 32 else f'_b{bs}'}.tsv").write_text(head + "\n".join(rows) + "\n")
    if differ:
        raise AssertionError(f"{name}: K8 differs from its plain version on {differ} of {total} outputs")

    by_kind = "; ".join(f"{k} ({v['n']} convs) {v['ms']:.4f} ms vs bound {v['bound_ms']:.4f} ms "
                        f"({v['ms'] / v['bound_ms']:.1f}x)" for k, v in sorted(kinds.items()))
    s3, s1 = sums["3x3"], sums["1x1"]
    log(f"serving (b): {name}: K8 == its plain version on all {n_convs} quantized convs of one int8 forward at 640, "
        f"batch {bs} (0 of "
        f"{total} outputs differ); int8_conv copied {copies} inputs (channel-split views read in place: {split}); "
        f"device time (CUDA graph replay) summed: K8 {tot['ms']:.4f} ms through int8_conv, bound {tot['bound_ms']:.4f} "
        f"ms ({tot['ms'] / tot['bound_ms']:.2f}x; {tot['bytes']:.4f} ms of it in bytes-bound convs, {tot['ops']:.4f} "
        f"ms in operation-bound ones)" + (f", plain {tot['plain_ms']:.3f} ms" if time_plain else "")
        + (f"; the 3x3 convs {s3['ms']:.4f} ms vs bound {s3['bound_ms']:.4f} ms "
           f"({s3['ms'] / s3['bound_ms']:.1f}x)" if s3["ms"] else "")
        + f"; the 1x1 convs {s1['ms']:.4f} ms vs bound {s1['bound_ms']:.4f} ms, in turns on gemm1x1 "
        f"{s1['new_ms']:.4f} ms, on route 1 {s1['route1_ms']:.4f} ms, torch._int_mm (int32 out, no epilogue) "
        f"{s1['int_mm_ms']:.4f} ms; the float-edge 1x1s {tot['edge_ms']:.4f} ms vs bound {tot['edge_bound']:.4f} ms; "
        f"on a route slower than another that can run it: {len(slower)} {slower}; by kind: {by_kind}; routes "
        f"{routes}; on {card}")
    return {"max_abs_err": 0.0, "ms": tot["ms"], "plain_ms": tot["plain_ms"] if time_plain else None,
            "bound_ms": tot["bound_ms"], "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
            "outputs_differing": differ, "copies": copies, "split_views": split,
            "ms_3x3": s3["ms"], "bound_3x3_ms": s3["bound_ms"], "ms_1x1": s1["ms"], "bound_1x1_ms": s1["bound_ms"],
            "gemm1x1_1x1_ms": s1["new_ms"], "route1_1x1_ms": s1["route1_ms"], "int_mm_1x1_ms": s1["int_mm_ms"],
            "edge_1x1_ms": tot["edge_ms"], "edge_1x1_bound_ms": tot["edge_bound"], "slower": len(slower),
            "routes": routes, "by_kind": kinds}


def int8_vs_bf16(card: str, path: str, frames, bs: int, n_convs: int, name: str, turns=("bf16", "int8", "int8",
                                                                                          "bf16")):
    """predict(int8=True) against bf16 predict on one model, both graphed, in turns, each turn `reps` calls timed on
    the host (each call ends in host results); then one turn of each run eagerly, for the record. Returns the
    graphed medians, the calls (each launched K1, K3 and K2 once), the K8 launches of the int8 calls and the int8
    predictor."""
    import numpy as np

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.ops import kernels
    from yololite_tpu_torch.ops.kernels import device_letterbox, greedy_nms_keep, int8_conv, select_decode

    kw = dict(conf=1e-7, imgsz=640, batch=bs, save=False, verbose=False)
    models = {"bf16": (YOLOLite(path), {"half": True}), "int8": (YOLOLite(path), {"int8": True})}
    for model, extra in models.values():
        for _ in range(2):  # set up, warm up (int8: calibrate on this batch) and run eagerly, then capture
            model.predict(frames, **kw, **extra)
    times = {"bf16": [], "int8": [], "bf16 eager": [], "int8 eager": []}
    k1 = k8 = 0
    reps = 5
    quantize_act, quantizes = kernels.quantize_act, []
    kernels.quantize_act = lambda *a: quantizes.append(1) or quantize_act(*a)  # K8 quantizes floats in its load
    try:
        for mode in (*turns, "bf16 eager", "int8 eager"):
            model, extra = models[mode.split()[0]]
            for _ in range(reps):
                greedy_nms_keep.launches = int8_conv.launches = device_letterbox.launches = 0
                k3_zero()
                t0 = time.perf_counter()
                with graphs.eager() if mode.endswith("eager") else contextlib.nullcontext():
                    results = model.predict(frames, **kw, **extra)
                times[mode].append(time.perf_counter() - t0)
                if (greedy_nms_keep.launches, select_decode.launches, device_letterbox.launches) != (1, 1, 1) or (
                        int8_conv.launches != (n_convs if mode.startswith("int8") else 0)):
                    raise AssertionError(f"{name} {mode} predict: {greedy_nms_keep.launches} K1, "
                                         f"{select_decode.launches} K3, {device_letterbox.launches} K2 and "
                                         f"{int8_conv.launches} K8 launches in one call")
                k1 += 1
                k3_tally(1, f"{name} {mode} predict", only="finish")
                k8 += int8_conv.launches
                if not all(len(r) and np.isfinite(r.boxes.data).all() for r in results):
                    raise AssertionError(f"{name} {mode} predict at batch {bs}: no detections or non-finite ones")
    finally:
        kernels.quantize_act = quantize_act
    if quantizes:
        raise AssertionError(f"{name}: quantize_act ran {len(quantizes)} times outside K8 in int8 predict")
    med = {m: sorted(t)[len(t) // 2] for m, t in times.items()}
    log(f"serving (b): {name} predict at 640, batch {bs}, eager (no graphs), one turn of {reps} calls each: int8 "
        f"median {med['int8 eager'] * 1e3:.2f} ms/call, bf16 {med['bf16 eager'] * 1e3:.2f} ms/call (int8 "
        f"x{med['bf16 eager'] / med['int8 eager']:.3f}), on {card}")
    log(f"serving (b): {name} predict at 640, batch {bs}, graphed, turns {'/'.join(turns)} of {reps} calls: int8 median "
        f"{med['int8'] * 1e3:.2f} ms/call ({bs / med['int8']:.1f} img/s; calls "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times['int8'])}) vs bf16 {med['bf16'] * 1e3:.2f} ms/call "
        f"({bs / med['bf16']:.1f} img/s; calls {', '.join(f'{t * 1e3:.2f}' for t in times['bf16'])}); int8 "
        f"{'faster' if med['int8'] < med['bf16'] else 'NOT faster'} than bf16 (x{med['bf16'] / med['int8']:.3f}); "
        f"K8 {n_convs} launches an int8 call, on {card}")
    return med, k1, k8, models["int8"][0].predictor


def serving_phase(card: str, frames):
    """Phase 6: .pt and ensemble predict, int8 predict with K8, export, the pipeline and embed on the card.

    Returns K1's launches on these main paths, K8's launches in the int8
    predict runs, K8's numbers for the kernels line, and K3's and K2's
    launches on these main paths.
    """
    import tempfile

    import numpy as np
    import torch
    import torch.nn as nn

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.predictor import DetectionPredictor, fp32_convs
    from yololite_tpu_torch.models.model import DetectionModel, EnsembleModel
    from yololite_tpu_torch.ops import nms
    from yololite_tpu_torch.ops.kernels import (device_letterbox, greedy_nms_keep, greedy_nms_keep_plain, int8_conv,
                                               select_decode)
    from yololite_tpu_torch.ops.letterbox import preprocess_batch
    from yololite_tpu_torch.runtime import InferencePipeline, export_predict, load_exported, predict_graph
    from yololite_tpu_torch.engine import graphs

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    k1 = k3 = k2 = 0
    kw = dict(conf=1e-7, imgsz=640, batch=32, save=False, verbose=False)

    # (a) .pt files through the stub unpickler: a plain model and a 2-member ensemble
    m0, m1 = DetectionModel("yolo11n.yaml").init(0), DetectionModel("yolo11n.yaml").init(1)
    plain_pt, ens_pt = root / "yolo11n.pt", root / "pair.pt"
    torch.save({"model": m0, "train_args": {"imgsz": 640}, "epoch": -1}, str(plain_pt))
    torch.save({"model": nn.ModuleList([m0, m1]), "train_args": {"imgsz": 640}}, str(ens_pt))
    exact_keep = nms._exact_keep
    for name, path in (("plain .pt", plain_pt), ("2-member ensemble .pt", ens_pt)):
        model = YOLOLite(str(path))
        members = model.model.members if isinstance(model.model, EnsembleModel) else [model.model]
        for got, want in zip(members, (m0, m1)):
            if not all(torch.equal(a.cpu(), b) for a, b in zip(got.state_dict().values(), want.state_dict().values())):
                raise AssertionError(f"{name}: loaded weights differ from the saved ones")
        for _ in range(2):  # set up, warm up and run eagerly, then capture
            model.predict(frames, **kw)
        inputs = []
        nms._exact_keep = lambda b, v, t: inputs.append((b.clone(), v.clone(), t)) or exact_keep(b, v, t)
        try:
            with graphs.eager():  # the inputs the step gives the exact keep
                model.predict(frames, **kw)
        finally:
            nms._exact_keep = exact_keep
        greedy_nms_keep.launches = device_letterbox.launches = 0
        k3_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            results = model.predict(frames, **kw)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        n = greedy_nms_keep.launches
        ensemble = isinstance(model.model, EnsembleModel)  # decodes every member, then non_max_suppression: no K3
        if n != reps or len(inputs) != 1 or (select_decode.launches, device_letterbox.launches) != (
                0 if ensemble else reps, reps):
            raise AssertionError(f"{name}: {n} K1, {select_decode.launches} K3 and {device_letterbox.launches} K2 "
                                 f"launches in {reps} predict calls, {len(inputs)} exact keeps in the eager call")
        k1 += n
        k3 += select_decode.launches
        k3_tally(select_decode.launches, f"serving {name} predict", only="finish")
        k2 += device_letterbox.launches
        boxes, valid, thr = inputs[-1]
        boxes = boxes.float().contiguous()
        if not torch.equal(greedy_nms_keep(boxes, valid, thr), greedy_nms_keep_plain(boxes, valid, thr)):
            raise AssertionError(f"{name}: K1's keep differs from the plain keep on the predict run's inputs")
        if len(results) != len(frames) or not all(len(r) and np.isfinite(r.boxes.data).all() for r in results):
            raise AssertionError(f"{name}: predict gave no detections or non-finite ones")
        log(f"serving (a): {name} (yolo11n, init({'0' if name.startswith('plain') else '0, 1'})) loads bit-equal, "
            f"predicts batch 32 at 640: {dt * 1e3:.2f} ms/batch, {32 / dt:.1f} img/s, "
            f"{sum(len(r) for r in results) / 32:.1f} detections/img; K1 {n} launches in {reps} calls (K3 "
            f"{0 if ensemble else reps}, K2 {reps}), keep == plain "
            f"on B={tuple(valid.shape)[0]} K={tuple(valid.shape)[1]}, on {card}")

    # (b) int8 predict beside bf16: yolo11n (the plain .pt) at batch 1 and, in turns, 32; K8 on every quantized
    # conv against its plain version and timed; then the same at yolo11m (init(0))
    model = YOLOLite(str(plain_pt))
    k8_launches = 0
    med1, n1, n8, _ = int8_vs_bf16(card, str(plain_pt), frames[:1], 1, 76, "yolo11n", turns=("bf16", "int8"))
    k1, k3, k2 = k1 + n1, k3 + n1, k2 + n1
    k8_launches += n8
    med32, n1, n8, pred = int8_vs_bf16(card, str(plain_pt), frames, 32, 76, "yolo11n")
    k1, k3, k2 = k1 + n1, k3 + n1, k2 + n1
    k8_launches += n8
    k8 = k8_on_convs(card, pred, frames, 76, "yolo11n", time_plain=True)
    k8_b1 = k8_on_convs(card, pred, frames[:1], 76, "yolo11n", time_plain=False)
    k8.update(int8_ms_b32=med32["int8"] * 1e3, bf16_ms_b32=med32["bf16"] * 1e3, int8_ms_b1=med1["int8"] * 1e3,
              bf16_ms_b1=med1["bf16"] * 1e3, int8_eager_ms_b32=med32["int8 eager"] * 1e3,
              bf16_eager_ms_b32=med32["bf16 eager"] * 1e3)
    del pred
    med_m, n1, n8, pred = int8_vs_bf16(card, "yolo11m.yaml", frames, 32, 101, "yolo11m")
    k1, k3, k2 = k1 + n1, k3 + n1, k2 + n1
    k8_launches += n8
    k8_m = k8_on_convs(card, pred, frames, 101, "yolo11m", time_plain=False)
    k8_m_b1 = k8_on_convs(card, pred, frames[:1], 101, "yolo11m", time_plain=False)
    sums = ("ms", "bound_ms", "ms_3x3", "bound_3x3_ms", "ms_1x1", "bound_1x1_ms", "gemm1x1_1x1_ms", "route1_1x1_ms",
            "int_mm_1x1_ms", "slower", "copies")
    k8["b1"] = {key: k8_b1[key] for key in sums}  # every conv of a batch-1 forward
    k8["yolo11m"] = {**{key: k8_m[key] for key in ("bound_by", "split_views", "edge_1x1_ms", "edge_1x1_bound_ms",
                                                   "routes", *sums)},
                     "b1": {key: k8_m_b1[key] for key in sums},
                     "int8_ms_b32": med_m["int8"] * 1e3, "bf16_ms_b32": med_m["bf16"] * 1e3}
    del pred
    torch.cuda.empty_cache()

    # (c) export at 640, batch 8, fp32 and int8: reloaded, bit-equal to the in-process graph
    im8 = torch.from_numpy(preprocess_batch(frames[:8], imgsz=640)).cuda()
    for mode, ekw in (("fp32", {"half": False}), ("int8", {"half": True, "int8_calib": [im8.cpu().numpy()]})):
        t0 = time.perf_counter()
        path = export_predict(model.model, root / f"n_{mode}.pt2", imgsz=640, batch=8, conf=1e-7, device="cuda",
                              **ekw)
        t_export = time.perf_counter() - t0
        call, meta = load_exported(path)
        graph = predict_graph(model.model, conf=1e-7, device="cuda", **ekw)
        greedy_nms_keep.launches = int8_conv.launches = 0
        k3_zero()
        with torch.inference_mode(), fp32_convs(im8.device):
            ref = graph(im8)
        out = call(im8)
        torch.cuda.synchronize()
        want_k8 = 2 * 76 if mode == "int8" else 0
        if greedy_nms_keep.launches != 2 or select_decode.launches != 2 or int8_conv.launches != want_k8:
            raise AssertionError(f"export {mode}: {greedy_nms_keep.launches} K1, {select_decode.launches} K3 and "
                                 f"{int8_conv.launches} K8 launches in the in-process and the exported run")
        k3_ops = [n for n in torch.export.load(str(path)).graph.nodes
                  if n.op == "call_function" and "select_decode" in str(n.target)]
        if len(k3_ops) != 1:
            raise AssertionError(f"export {mode}: the exported graph holds {len(k3_ops)} select_decode ops, not one")
        if not torch.equal(out, ref) or not int((ref[..., 4] > 0).sum()):
            raise AssertionError(f"export {mode}: the reloaded graph differs from the in-process one, or detects nothing")
        log(f"serving (c): export {mode} at 640, batch 8: {t_export:.1f} s to export, {path.stat().st_size / 1e6:.1f} "
            f"MB; reloaded output bit-equal to the in-process graph ({int((ref[..., 4] > 0).sum())} detections), "
            f"K3 (one op in the graph), K1{' and K8' if want_k8 else ''} as ops, on {card}")

    # (d) InferencePipeline at batch 8, 640: 32 submissions, graphed (its warm-up eager on this thread, the first
    # batch captured on the dispatch thread after a warm-up run there), eagerly, and graphed again (all replays)
    pred = DetectionPredictor(overrides={"conf": 1e-7, "batch": 8, "imgsz": 640, "mode": "predict", "verbose": False,
                                         "save": False})
    pred.setup_model(model.model)
    subs = [frames[(8 * i) % 32:(8 * i) % 32 + 8] for i in range(32)]
    want = None
    lines = []
    for name in ("graphed", "eager", "graphed again"):
        pipe = InferencePipeline(pred, imgsz=640).start()
        greedy_nms_keep.launches = 0
        k3_zero()
        warmups = pred._graphs.warmups
        t0 = time.perf_counter()
        with graphs.eager() if name == "eager" else contextlib.nullcontext():
            for b in subs:
                pipe.submit(b)
            pipe.close()
            got = list(pipe.results())
        wall = time.perf_counter() - t0
        k1 += greedy_nms_keep.launches
        k3 += select_decode.launches
        k3_tally(select_decode.launches, f"pipeline {name}", only="finish")
        warmups = pred._graphs.warmups - warmups
        if len(got) != 32 or greedy_nms_keep.launches != 32 + warmups or select_decode.launches != 32 + warmups:
            raise AssertionError(f"pipeline {name}: {len(got)} results, {greedy_nms_keep.launches} K1 and "
                                 f"{select_decode.launches} K3 launches for 32 batches")  # a capture's warm-up too
        if want is None:
            want = pred.infer(torch.from_numpy(preprocess_batch(subs[0], imgsz=640)).cuda()).cpu().numpy()
        if not np.array_equal(got[0][1], want) or not (want[..., 4] > 0).any():
            raise AssertionError(f"pipeline {name}: detections differ from the predictor's infer on the same batch")
        sm = pipe.summary(wall)
        lines.append(f"{name}: p50 {sm['p50_ms']:.2f} ms, p90 {sm['p90_ms']:.2f} ms, p99 {sm['p99_ms']:.2f} ms, "
                     f"{sm['throughput_img_s']:.1f} img/s")
    log(f"serving (d): InferencePipeline yolo11n fp32 at 640, batch 8, 32 submissions (submit to detections on the "
        f"host): {'; '.join(lines)}; detections == predictor.infer's, on {card}")

    # (e) embed on the card against the CPU
    on_card = YOLOLite(str(plain_pt)).embed(frames[:2], layers=[4, 6, 10], imgsz=640)
    on_cpu = YOLOLite(str(plain_pt), device="cpu").embed(frames[:2], layers=[4, 6, 10], imgsz=640)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(on_card, on_cpu))
    log(f"serving (e): embed of rows 4, 6, 10 at 640 on the card == the CPU's within rtol 1e-3 (largest difference "
        f"{rel:.2e} of the largest value), shape {on_card[0].shape}, on {card}")
    tmp.cleanup()
    return k1, k8_launches, k8, {"select_decode": k3, "device_letterbox": k2}


def small_val_card_vs_cpu(card: str, root: Path, name: str, spec) -> None:
    """The model with separating weights on the card against the CPU at imgsz 160: predict on 2 frames (matched as
    sets) and val on 4 images labelled from the CPU's own detections (counts per image equal, mAP50-95 within 1e-3)."""
    import numpy as np

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.validator import DetectionValidator

    cpu_model = YOLOLite(spec, device="cpu")
    separating_weights_(cpu_model.model)
    card_model = YOLOLite(spec)
    card_model.model.load_state_dict(cpu_model.model.state_dict())
    small = [f[::3, ::3].copy() for f in np.random.default_rng(24).integers(0, 256, (2, 480, 640, 3), np.uint8)]
    kw = dict(conf=1e-7, imgsz=160, batch=2, save=False, verbose=False)
    for a, b in zip(cpu_model.predict(small, **kw), card_model.predict(small, **kw)):
        da, db = a.boxes.data, b.boxes.data
        if not len(da) or len(da) != len(db) or match_sets(da, db) != len(da):
            raise AssertionError(f"{name} predict card vs CPU at imgsz 160: {len(db)} vs {len(da)} detections, "
                                 f"{match_sets(da, db)} matched")
    shapes = [(120, 160), (160, 120), (90, 160), (160, 160)]
    data = write_val_dataset(root / f"{name}_val4", shapes, seed=16, labels=[[] for _ in shapes])
    files = sorted(str(f) for f in (root / f"{name}_val4" / "images" / "val").iterdir())
    rng = np.random.default_rng(17)
    labels = []
    for r, (h, w) in zip(cpu_model.predict(files, conf=0.01, imgsz=160, batch=4, save=False, verbose=False), shapes):
        rows = []
        for x1, y1, x2, y2, _, c in r.boxes.data[:8]:
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.uniform(-3, 3, 4), 0, [w, h, w, h])
            if x2 - x1 > 2 and y2 - y1 > 2:
                rows.append((int(c), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h))
        labels.append(rows)
    write_val_dataset(root / f"{name}_val4", shapes, seed=16, labels=labels)
    vargs = dict(data=str(data), imgsz=160, batch=2, rect=True, conf=1e-7, plots=False, verbose=False, mode="val")
    on = {}
    for dev, m in (("card", card_model), ("cpu", cpu_model)):
        v = DetectionValidator(save_dir=root / "runs" / f"{name}_small_{dev}", args=vargs, device=m.device)
        v(model=m.model)
        on[dev] = ([len(c) for c in v.stats["conf"]], v.metrics.results_dict["metrics/mAP50-95(B)"])
    (n_card, map_card), (n_cpu, map_cpu) = on["card"], on["cpu"]
    if n_card != n_cpu or abs(map_card - map_cpu) > 1e-3 or not 0 < map_cpu <= 1:
        raise AssertionError(f"{name} val card vs CPU at imgsz 160: detections {n_card} vs {n_cpu}, "
                             f"mAP50-95 {map_card} vs {map_cpu}")
    log(f"{name}: card == CPU at imgsz 160, separating weights: predict on 2 frames (matched as sets), val on 4 "
        f"images (detections {n_card}, mAP50-95 {map_card:.6f} vs {map_cpu:.6f}), on {card}")


def one_step_card_vs_cpu(card: str, root: Path, name: str, spec, data, bound: float = 1e-3) -> None:
    """One SGD step at imgsz 160, batch 2, fp32, init(0) weights, on the card against the CPU.

    The step moves each weight by lr * 1.9 * (clipped gradient + decay); at lr
    100 that lies far above the fp32 rounding of the new weight (at lr 1,
    rounding alone can move a BN weight's after - before past the limit where
    its gradient is small), so the update is held to the CPU's as the
    gradients are: fg_mask equal, loss items within 1e-4, each gradient and
    each weight's and BN statistic's update within `bound` relative L2. Both
    fp32 gradients are also measured against the same step in float64 on the
    CPU, which says how much of their gap is fp32 rounding.
    """
    import copy

    import numpy as np
    import torch

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.predictor import fp32_convs, forward_nhwc
    from yololite_tpu_torch.engine.trainer import DetectionTrainer

    pair = {}
    for dev in ("cuda", "cpu"):
        tr = DetectionTrainer(overrides={"data": str(data), "imgsz": 160, "batch": 2, "val": False, "save": False,
                                         "optimizer": "SGD", "project": str(root / "runs"),
                                         "name": f"{name}_step_{dev}", "workers": 0}, device=dev)
        tr.set_model(YOLOLite(spec, device="cpu").model)
        tr._setup_train()
        pair[dev] = tr
    batch = next(iter(pair["cpu"].train_loader))
    targets = pair["cpu"]._targets(batch)
    m64 = copy.deepcopy(pair["cpu"].model).double()
    x64 = torch.from_numpy(batch["img"]).double() / 255.0
    total, _, _ = pair["cpu"].loss_fn.forward(
        forward_nhwc(m64, x64.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)),
        {k: v.double() if v.is_floating_point() else v for k, v in targets.items()})
    total.backward()
    g64 = {k: p.grad.detach().clone() for k, p in m64.named_parameters()}
    got = {}
    for dev, tr in pair.items():
        before = {k: v.detach().cpu().double() for k, v in tr.model.state_dict().items() if v.is_floating_point()}
        targets = tr._targets(batch)
        with fp32_convs(tr.device):
            total, items, fg = tr.loss_fn.forward(tr._forward(torch.from_numpy(batch["img"]).to(tr.device)), targets)
            total.backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in tr.model.named_parameters()}
        tr._apply_step(np.full(3, 100.0, np.float32), 0.9)
        after = {k: v.detach().cpu().double() for k, v in tr.model.state_dict().items() if v.is_floating_point()}
        got[dev] = (items.cpu(), fg.cpu(), grads, {k: after[k] - before[k] for k in before})
    (ic, fc, gc, uc), (ih, fh, gh, uh) = got["cuda"], got["cpu"]
    floor = 1e-5 * max(float(g.norm()) for g in gh.values())
    worst = max((grad_rel_l2(gc[k], gh[k], floor), k) for k in gh)
    item_rel = float(((ic - ih).abs() / ih.abs()).max())
    u_floor = 1e-5 * max(float(u.norm()) for u in uh.values())
    u_worst = max((grad_rel_l2(uc[k], uh[k], u_floor), k) for k in uh)
    card64 = max(grad_rel_l2(gc[k].double(), g64[k], floor) for k in g64)
    cpu64 = max(grad_rel_l2(gh[k].double(), g64[k], floor) for k in g64)
    if not torch.equal(fc, fh) or item_rel > 1e-4 or worst[0] > bound or u_worst[0] > bound:
        raise AssertionError(f"{name} one step card vs CPU: fg equal {torch.equal(fc, fh)}, items rel {item_rel}, "
                             f"worst gradient rel L2 {worst}, worst update rel L2 {u_worst} (bound {bound}); "
                             f"against the float64 step: card {card64}, CPU {cpu64}")
    log(f"{name}: one SGD step card == CPU at 160, batch 2, fp32: fg_mask equal ({int(fh.sum())} anchors), loss "
        f"items within {item_rel:.2e} relative, worst gradient relative L2 {worst[0]:.2e} ({worst[1]}), worst update "
        f"(after - before) of a weight or BN statistic relative L2 {u_worst[0]:.2e} ({u_worst[1]}), bound {bound:g}; "
        f"worst gradient against the float64 step on the CPU: card {card64:.2e}, CPU {cpu64:.2e}, on {card}")


def zoo_phase(card: str, frames):
    """Phase 7: YOLOv10-N and GELAN-T of the extended block zoo at full width and 640 on the card, init(0) weights.

    Returns K1's launches in GELAN-T's predict runs and K4's in its val runs, K3's in both and K2's in every
    predict run (YOLOv10-N's end2end head takes a top-k of its one2one maps and runs no NMS, so no K3).
    """
    import tempfile

    import numpy as np
    import torch

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.cfg.dicts import GELAN_T, YOLOV10N
    from yololite_tpu_torch.engine.predictor import fp32_convs
    from yololite_tpu_torch.models.model import DetectionModel
    from yololite_tpu_torch.ops import nms
    from yololite_tpu_torch.ops.decode import postprocess_end2end
    from yololite_tpu_torch.ops.kernels import (blocked_nms_finalize, device_letterbox, greedy_nms_keep,
                                               greedy_nms_keep_plain, int8_conv, select_decode)

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    specs = {"yolov10n": YOLOV10N, "gelan-t": GELAN_T}
    models = {name: YOLOLite(spec) for name, spec in specs.items()}  # init(0) on the card
    for name, m in models.items():
        log(f"zoo: {name}: {m.model.num_params():,} parameters, {m.model.gflops(640):.2f} GFLOPs at 640, strides "
            f"{m.model.strides}, end2end {m.model.detect.end2end}, rows {[r.name for r in m.model.model]}")
    k1 = k4 = k3 = k2 = 0

    # (a) predict the 32 frames at 640, conf 1e-7: YOLOv10-N at batch 1 and 32, GELAN-T at 32, fp32 and bf16
    configs = {"yolov10n": [(False, 1), (False, 32), (True, 1), (True, 32)], "gelan-t": [(False, 32), (True, 32)]}
    for name, m in models.items():
        e2e = m.model.detect.end2end
        for half, bs in configs[name]:
            dtype = "bf16" if half else "fp32"
            src = frames[:bs]
            kw = dict(conf=1e-7, imgsz=640, batch=bs, half=half, save=False, verbose=False)
            for _ in range(2):  # set up, warm up and run eagerly, then capture
                m.predict(src, **kw)
            greedy_nms_keep.launches = device_letterbox.launches = 0
            k3_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                results = m.predict(src, **kw)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / reps
            n = greedy_nms_keep.launches
            if n != (0 if e2e else reps) or select_decode.launches != n or device_letterbox.launches != reps:
                raise AssertionError(f"{name} predict {dtype} batch {bs}: {n} K1, {select_decode.launches} K3 and "
                                     f"{device_letterbox.launches} K2 launches in {reps} calls")
            k1 += n
            k3 += select_decode.launches
            k3_tally(select_decode.launches, f"{name} predict {dtype} batch {bs}", only="finish")
            k2 += device_letterbox.launches
            if len(results) != bs:
                raise AssertionError(f"{name}: {len(results)} results for {bs} images")
            for r in results:
                d = r.boxes.data
                if d.ndim != 2 or d.shape[1] != 6 or not len(d) or not np.isfinite(d).all():
                    raise AssertionError(f"{name}: bad detections, shape {d.shape}, finite {np.isfinite(d).all()}")
                if (d[:, :4] < 0).any() or (d[:, [0, 2]] > 640).any() or (d[:, [1, 3]] > 480).any():
                    raise AssertionError(f"{name}: boxes outside the 480x640 frame")
            pred = m.predictor
            raw = torch.from_numpy(np.stack(src)).cuda().flip(-1)
            mm = m.model
            layout = pred.letterbox_channels_last(raw.device)
            with torch.inference_mode(), fp32_convs(raw.device):
                x = device_letterbox(raw, 640, pred.dtype, channels_last=layout)
                feats = pred._forward(x)
                if e2e:
                    tail = lambda: postprocess_end2end(feats["one2one"], mm.strides, mm.nc, mm.reg_max,
                                                       max_det=min(pred.max_det, mm.detect.max_det),
                                                       conf_thres=pred.conf)
                    tail_name = "postprocess_end2end (top-k)"
                else:
                    args = (feats, mm.strides, mm.nc, mm.reg_max)
                    kw_nms = dict(conf_thres=pred.conf, iou_thres=pred.iou, max_det=pred.max_det,
                                  max_cand=pred.pred_max_cand, half=pred.half)
                    with_kernel = nms.nms_from_feats(*args, **kw_nms)
                    nms.greedy_nms_keep = greedy_nms_keep_plain
                    try:
                        with_plain = nms.nms_from_feats(*args, **kw_nms)
                    finally:
                        nms.greedy_nms_keep = greedy_nms_keep
                    if not torch.equal(with_kernel, with_plain):
                        raise AssertionError(f"{name} {dtype}: nms_from_feats differs between K1 and the plain keep")
                    tail = lambda: nms.nms_from_feats(*args, **kw_nms)
                    tail_name = f"nms_from_feats K={pred.pred_max_cand} (== plain keep)"
                t_lb = cuda_ms(lambda: device_letterbox(raw, 640, pred.dtype, channels_last=layout), 10)
                t_fw = cuda_ms(lambda: pred._forward(x), 10)
                t_tail = cuda_ms(tail, 10)
            log(f"zoo: {name} predict {dtype} batch {bs} at 640, conf 1e-7: {dt * 1e3:.2f} ms/call, "
                f"{bs / dt:.1f} img/s, {sum(len(r) for r in results) / bs:.1f} detections/img, K1 and K3 {n} launches "
                f"each, K2 {reps}, in {reps} calls; stages alone: letterbox {t_lb:.3f} ms, forward {t_fw:.3f} ms, "
                f"{tail_name} "
                f"{t_tail:.3f} ms, their sum {(t_lb + t_fw + t_tail) / (dt * 1e3):.1%} of the call, on {card}")

    # (b) val at 640, batch 16, rect, conf 1e-7 on the phase-4 set (64 images, four shapes), each bucket shape one
    # batch: seen once, so every step runs eagerly
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
    val_data = write_val_dataset(root / "val64", shapes * 16, seed=15)
    for name, m in models.items():
        kw = dict(data=str(val_data), imgsz=640, batch=16, rect=True, conf=1e-7, plots=False, verbose=False,
                  project=str(root / "runs"), name=f"{name}_val")
        m.val(**kw)  # the label cache
        greedy_nms_keep.launches = blocked_nms_finalize.launches = 0
        k3_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = m.val(**kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n1, n = greedy_nms_keep.launches, blocked_nms_finalize.launches
        e2e = m.model.detect.end2end
        if n1 or (n != 0 if e2e else n != 4) or select_decode.launches != n:  # 4 batches
            raise AssertionError(f"{name} val: {n1} K1, {select_decode.launches} K3 and {n} K4 launches for 4 "
                                 "batches")
        k4 += n
        k3 += n
        k3_tally(n, f"{name} val", only="cluster")
        rd = metrics.results_dict
        if not all(np.isfinite(v) and 0 <= v <= 1 for v in rd.values()):
            raise AssertionError(f"{name} val metrics not finite or outside [0, 1]: {rd}")
        sp = metrics.speed
        log(f"zoo: {name} val fp32 at 640, batch 16, rect, conf 1e-7, 64 images: {64 / dt:.1f} img/s ({dt:.3f} s); "
            f"per image: preprocess {sp['preprocess']:.3f} ms, inference {sp['inference']:.3f} ms, postprocess "
            f"{sp['postprocess']:.3f} ms; mAP50-95 {rd['metrics/mAP50-95(B)']:.5f}; K3 and K4 {n} launches each (4 "
            f"batches), "
            f"K1 0, on {card}")

    # (c) YOLOv10-N trains 1 epoch at 640, batch 16, on the phase-5 images, amp off and on; predicts from last.npz
    write_val_dataset(root / "ds", shapes * 16, seed=20, split="train")
    train_data = write_val_dataset(root / "ds", shapes * 4, seed=21, split="val")
    for amp in (False, True):
        dtype = "bf16" if amp else "fp32"
        m = YOLOLite(YOLOV10N)
        t0 = time.perf_counter()
        m.train(data=str(train_data), epochs=1, imgsz=640, batch=16, amp=amp, plots=False, project=str(root / "runs"),
                name=f"v10n_{dtype}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = m.trainer
        rows = np.loadtxt(t.csv, delimiter=",", skiprows=1, ndmin=2)
        if rows.shape[0] != 1 or not np.isfinite(rows).all() or not (rows[:, 1:4] > 0).all():
            raise AssertionError(f"yolov10n train {dtype}: results.csv not one finite epoch: {rows}")
        if not Path(t.last).exists() or type(t.loss_fn).__name__ != "E2EDetectLoss":
            raise AssertionError(f"yolov10n train {dtype}: last.npz missing or loss {type(t.loss_fn).__name__}")
        res = YOLOLite(str(t.last)).predict(frames[:4], imgsz=640, conf=1e-7, batch=4, save=False, verbose=False)
        if len(res) != 4 or not all(len(r) and np.isfinite(r.boxes.data).all() for r in res):
            raise AssertionError(f"yolov10n {dtype}: predict from last.npz gave no detections or non-finite ones")
        log(f"zoo: yolov10n train {dtype} at 640, batch 16, 64 images, 1 epoch, {t.opt_name}, E2EDetectLoss: epoch "
            f"loop without val {t.train_seconds[0]:.3f} s ({64 / t.train_seconds[0]:.1f} img/s), whole train() "
            f"{wall:.2f} s; loss items {rows[0, 1:4].round(5).tolist()}; last.npz predicts "
            f"({sum(len(r) for r in res)} detections on 4 frames), on {card}")

    # (d) YOLOv10-N as an upstream-format .pt, loaded through the facade: bit-equal weights, equal detections
    src_model = DetectionModel(YOLOV10N).init(0)
    pt = root / "yolov10n.pt"
    torch.save({"model": src_model, "train_args": {"imgsz": 640}, "epoch": -1}, str(pt))
    loaded = YOLOLite(str(pt))
    if not all(torch.equal(a.cpu(), b) for a, b in zip(loaded.model.state_dict().values(),
                                                        src_model.state_dict().values())):
        raise AssertionError("yolov10n .pt: loaded weights differ from the saved ones")
    kw = dict(conf=1e-7, imgsz=640, batch=32, save=False, verbose=False)
    for a, b in zip(loaded.predict(frames, **kw), models["yolov10n"].predict(frames, **kw)):
        if not np.array_equal(a.boxes.data, b.boxes.data):
            raise AssertionError("yolov10n .pt: detections differ from the init(0) model's")
    log(f"zoo: yolov10n .pt (the spec in the checkpoint) loads bit-equal and predicts 32 frames at 640 as the model "
        f"it came from, on {card}")

    # (e) int8 serving refuses the zoo model before any quantized forward; K8 is not touched
    first = int8_conv.launches
    try:
        YOLOLite(YOLOV10N).predict(frames[:1], int8=True, imgsz=640, conf=1e-7, save=False, verbose=False)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("yolov10n predict(int8=True) did not raise")
    if int8_conv.launches != first:
        raise AssertionError("yolov10n predict(int8=True) launched K8")
    log(f"zoo: yolov10n predict(int8=True) raises NotImplementedError, K8 not launched: {refusal[:120]}...")

    # (f) the card against the CPU at imgsz 160, both models. GELAN-T's step is held at 5e-3: its three-deep
    # RepCSP rows end in BNs over few values a channel, whose gradients nearly cancel, and cuDNN's fp32 step
    # lands about 2e-3 from the float64 step there (the line below logs it; the CPU's NCHW step under 1e-3)
    for name, spec in specs.items():
        small_val_card_vs_cpu(card, root, name, spec)
        one_step_card_vs_cpu(card, root, name, spec, train_data, bound=5e-3 if name == "gelan-t" else 1e-3)
    tmp.cleanup()
    return {"greedy_nms_keep": k1, "blocked_nms_finalize": k4, "select_decode": k3, "device_letterbox": k2}


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def patched_pool(record=None, force=None, rows=slice(None)):
    """A replacement for SPPF._pool (models/modules.py): the same max-pool, the first three calls' picks (flat
    indices into H*W: the checked step's three chained pools) appended to `record`; or, with `force`, the pools
    taking the given picks (rows `rows` of each) instead of their own."""
    import torch.nn.functional as F

    calls = iter(force or ())

    def pool(self, x):
        if force is not None:
            idx = next(calls)[rows].to(x.device)
            n, c, h, w = x.shape
            return x.reshape(n, c, h * w).gather(2, idx.reshape(n, c, h * w)).view(n, c, h, w)
        out, idx = F.max_pool2d(x, self.k, 1, self.k // 2, return_indices=True)
        if record is not None and len(record) < 3:
            record.append(idx.cpu())
        return out

    return pool


def picked_rank_steps(rank: int, world: int, device, ov, models, batches, lr, momentum, timed: int = 0):
    """A rank function for parallel.mesh.launch: data_parallel_step on each (model, batch) pair in turn, in one
    process group, each with its SPPF max-pools' picks recorded (this rank's rows); the first with `timed` timed
    steps. Returns [(output, picks)]."""
    from yololite_tpu_torch.engine.trainer import data_parallel_step
    from yololite_tpu_torch.models.modules import SPPF

    outs = []
    for i, (m, b) in enumerate(zip(models, batches)):
        picks = []
        SPPF._pool = patched_pool(picks)
        out = data_parallel_step(rank, world, device, ov, m, [b], lr, momentum, timed if i == 0 else 0)
        outs.append((out, picks))
    return outs


def float64_step(ov, model, batch, lr, momentum, picks=None) -> dict:
    """The trainer's SGD step in float64 on the card (an NCHW batch): gradients, weights and BN statistics before and
    after, and SPPF's max-pool picks; the reference of the fp32 steps. With `picks` (an fp32 step's), SPPF's pools
    take those picks: the exact step on the same side of every near-tie in the pools."""
    import copy

    import numpy as np
    import torch

    from yololite_tpu_torch.engine.predictor import forward_nhwc
    from yololite_tpu_torch.engine.trainer import DetectionTrainer
    from yololite_tpu_torch.models.modules import SPPF

    tr = DetectionTrainer(overrides=ov, device="cuda")
    tr.set_model(copy.deepcopy(model).double())
    tr._setup_train()
    host = lambda: {k: v.detach().cpu().double().clone() for k, v in tr.model.state_dict().items()
                    if v.is_floating_point()}
    before = host()
    targets = {k: v.double() if v.is_floating_point() else v for k, v in tr._targets(batch).items()}
    x = torch.from_numpy(batch["img"]).cuda().double() / 255.0
    own, recorded = SPPF._pool, []
    SPPF._pool = patched_pool(recorded, picks)
    try:
        total, _, _ = tr.loss_fn.forward(forward_nhwc(tr.model, x.permute(0, 3, 1, 2).contiguous()
                                                      .permute(0, 2, 3, 1)), targets)
    finally:
        SPPF._pool = own
    total.backward()
    grads = {k: p.grad.detach().cpu().clone() for k, p in tr.model.named_parameters()}
    tr._apply_step(np.asarray(lr, np.float32), momentum)
    return {"grads": grads, "before": before, "after": host(), "picks": recorded or picks}


def rank_loader_numbers(card: str, ov, data) -> None:
    """Each rank's host loader ms per step (mosaic, batch 16 at 640, the default workers) with the row split (rank r
    of 2 builds its 8 image rows) and without it (the whole batch, as every rank built it before the split): the
    loaders run one at a time in this process, each from a fresh dataset, a first pass (each image decoded once) and a
    second (the images in the buffer). A rank's rows and labels are checked against the whole batch's."""
    import os

    import numpy as np

    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
    from yololite_tpu_torch.data.utils import check_det_dataset

    hyp = get_cfg(overrides={**ov, "mode": "train"})
    hyp.workers = get_cfg().workers
    dinfo = check_det_dataset(str(data))
    bs = int(hyp.batch)
    ms, first = {}, {}
    for rank, world in ((0, 1), (0, 2), (1, 2)):
        loader = build_dataloader(build_yolo_dataset(hyp, dinfo["train"], bs, dinfo, mode="train"), bs, hyp.workers,
                                  shuffle=True, seed=0, rank=rank, world=world)
        ms[rank, world] = []
        for _ in range(2):
            t0 = time.perf_counter()
            batches = list(loader)
            ms[rank, world].append((time.perf_counter() - t0) * 1e3 / len(batches))
            first.setdefault((rank, world), batches[0])
    whole = first[0, 1]
    for rank in (0, 1):
        got = first[rank, 2]
        rows = slice(rank * bs // 2, (rank + 1) * bs // 2)
        if got["img_rows"] != (rows.start, rows.stop, bs) or not np.array_equal(got["img"], whole["img"][rows]) or (
                not all(np.array_equal(got[k], whole[k]) for k in ("cls", "bboxes", "batch_idx"))):
            raise AssertionError(f"rank {rank} of 2: its loader's rows or labels differ from the whole batch's")
    log(f"parallel: each rank's host loader, ms a step (mosaic, batch {bs} at {hyp.imgsz}, {hyp.workers} workers, "
        f"{len(loader)} steps, one loader at a time; first pass, second pass): rank 0 of 2 with the row split "
        f"{ms[0, 2][0]:.1f}, {ms[0, 2][1]:.1f}; rank 1 of 2 {ms[1, 2][0]:.1f}, {ms[1, 2][1]:.1f}; without the split "
        f"(the whole batch on each rank) {ms[0, 1][0]:.1f}, {ms[0, 1][1]:.1f}; each rank's rows and labels equal to "
        f"the whole batch's; host {os.cpu_count()} CPUs, on {card}")


def seeded_batch(ov, data, seed: int):
    """The first batch of the train loader shuffled with `seed` (the step checks' batch)."""
    from yololite_tpu_torch.cfg import get_cfg
    from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
    from yololite_tpu_torch.data.utils import check_det_dataset

    hyp = get_cfg(overrides={**ov, "mode": "train"})
    dinfo = check_det_dataset(str(data))
    return next(iter(build_dataloader(build_yolo_dataset(hyp, dinfo["train"], ov["batch"], dinfo, mode="train"),
                                      ov["batch"], 0, shuffle=True, seed=seed)))


def step_against_float64(card: str, root: Path, data) -> None:
    """Phase 5: the one-process fp32 SGD step at 640, batch 16 (lr 100) held to the float64 step on the card at
    1e-3 relative L2 on every gradient leaf, with the trainer's batch (NCHW-contiguous when amp is off) and, for the
    record, with the channels-last batch it fed the card before, on three seeds (yolo11n init(seed), the loader
    shuffled with seed); on seed 0 each variant's mean step time over 5 steps."""
    import torch

    from yololite_tpu_torch.engine import trainer as T
    from yololite_tpu_torch.engine.predictor import forward_nhwc
    from yololite_tpu_torch.models.model import DetectionModel

    ov = {"data": str(data), "imgsz": 640, "batch": 16, "nbs": 16, "val": False, "save": False, "optimizer": "SGD",
          "amp": False, "project": str(root / "runs"), "name": "step64", "workers": 2}
    lr = [100.0] * 3

    def channels_last_forward(self, images):  # the trainer's card path before this fix
        x = images.float() * (1.0 / 255.0) if images.dtype == torch.uint8 else images
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bool(self.args.amp)):
            return forward_nhwc(self.model, x)

    nchw_forward = T.DetectionTrainer._forward
    lines = []
    for seed in (0, 1, 2):
        batch = seeded_batch(ov, data, seed)
        model = DetectionModel("yolo11n.yaml").init(seed)
        ref64 = float64_step(ov, model, batch, lr, 0.9)
        floor = 1e-5 * max(float(v.norm()) for v in ref64["grads"].values())
        got = {}
        names = ("NCHW batch", "channels-last batch", "NCHW batch again") if seed == 0 else ("NCHW batch",
                                                                                          "channels-last batch")
        for name in names:
            T.DetectionTrainer._forward = channels_last_forward if name.startswith("channels") else nchw_forward
            try:
                out = T.data_parallel_step(0, 1, torch.device("cuda:0"), ov, model, [batch], lr, 0.9,
                                           5 if seed == 0 else 0)
            finally:
                T.DetectionTrainer._forward = nchw_forward
            worst = max((float((out["grads"][k].double() - w).norm()) / max(float(w.norm()), floor), k)
                        for k, w in ref64["grads"].items())
            got[name] = (worst, out.get("step_s", float("nan")) * 1e3)
        for name in names:
            if name.startswith("NCHW") and got[name][0][0] > 1e-3:
                raise AssertionError(f"the one-process fp32 step ({name}, seed {seed}) lies {got[name][0]} from the "
                                     "float64 step")
        lines.append(f"seed {seed}: " + "; ".join(
            f"{name} {w[0]:.2e} ({w[1]})" + (f", {ms:.2f} ms" if seed == 0 else "") for name, (w, ms) in got.items()))
    log("train: one-process fp32 SGD step at 640, batch 16 (yolo11n init(seed), lr 100) against the float64 step on "
        "the card, worst gradient leaf's relative L2 (bound 1e-3 for the trainer's NCHW batch) and, on seed 0, the "
        "mean step of 5: " + " | ".join(lines) + f", on {card}")


def parallel_phase(card: str, frames):
    """Phase 8: data parallelism on the one card, rotated ops and deformable attention on the card vs the CPU.

    Returns K1's launches in the mesh's predict runs and K4's in its val run
    and in rank 0's EMA vals and final val of the 2-rank training run.
    """
    import math
    import tempfile

    import numpy as np
    import torch

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.trainer import data_parallel_step
    from yololite_tpu_torch.models import deformable as D
    from yololite_tpu_torch.models.model import DetectionModel
    from yololite_tpu_torch.models.transformer import Linear
    from yololite_tpu_torch.ops import rotated as R
    from yololite_tpu_torch.ops.boxes import make_anchors
    from yololite_tpu_torch.ops.kernels import blocked_nms_finalize, device_letterbox, greedy_nms_keep, select_decode
    from yololite_tpu_torch.parallel.mesh import launch

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    mesh = ["cuda:0", "cuda:0"]  # two replicas (inference) or two gloo ranks (train) on the one card
    k1 = k4 = k3 = k2 = 0

    # (a) inference over a mesh of two replicas: predict at batch 32, a tail of 31 frames, val at batch 16
    one, two = YOLOLite("yolo11n.yaml"), YOLOLite("yolo11n.yaml", device=mesh)
    for bs, src in ((32, frames), (31, frames[:31])):
        kw = dict(conf=1e-7, imgsz=640, batch=bs, save=False, verbose=False)
        want = one.predict(src, **kw)
        for _ in range(2):  # set up, warm up and run eagerly, then capture each replica's step
            two.predict(src, **kw)
        times = {}
        for name, m in (("one device", one), ("mesh", two)):
            greedy_nms_keep.launches = device_letterbox.launches = 0
            k3_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = m.predict(src, **kw)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
            if name == "mesh":
                n, n3, n2 = greedy_nms_keep.launches, select_decode.launches, device_letterbox.launches
                k3_tally(n3, f"mesh predict batch {bs}", only="finish")
        shards = 2 if bs % 2 == 0 else 1
        if (n, n3, n2) != (shards,) * 3 or len(two.predictor.replicas) != 2:  # K1, K3 and K2 once a shard
            raise AssertionError(f"mesh predict batch {bs}: {n} K1, {n3} K3 and {n2} K2 launches, "
                                 f"{len(two.predictor.replicas)} replicas")
        graphed = {k[1] for k in two.predictor._graphs._graphs}  # the modules with a captured step
        if graphed != {id(r) for r in two.predictor.replicas}:  # both replicas (the tail ran on the first)
            raise AssertionError(f"mesh predict batch {bs}: graphs for modules {graphed}")
        k1, k3, k2 = k1 + n, k3 + n3, k2 + n2
        unmatched = sum(len(a.boxes.data) + len(b.boxes.data) - 2 * match_sets(a.boxes.data, b.boxes.data)
                        for a, b in zip(want, got))
        if len(got) != bs or unmatched:
            raise AssertionError(f"mesh predict batch {bs}: {len(got)} results, {unmatched} unmatched detections")
        log(f"parallel: mesh of 2 replicas on cuda:0, predict 32 frames at 640, batch {bs}: {shards} shard(s), "
            f"K1, K3 and K2 {n} launches each, detections == one device (0 unmatched of "
            f"{sum(len(r) for r in got)}); one call "
            f"{times['mesh']:.2f} ms on the mesh, {times['one device']:.2f} ms on one device, on {card}")
    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)]
    val_data = write_val_dataset(root / "val64", shapes * 16, seed=15)
    kwv = dict(data=str(val_data), imgsz=640, batch=16, rect=True, conf=1e-7, plots=False, verbose=False,
               project=str(root / "runs"))
    rd1 = one.val(**kwv, name="one").results_dict
    greedy_nms_keep.launches = blocked_nms_finalize.launches = 0
    k3_zero()
    rd2 = two.val(**kwv, name="mesh").results_dict
    n1, n = greedy_nms_keep.launches, blocked_nms_finalize.launches
    if n1 or n != 8 or select_decode.launches != 8:  # 4 batches x 2 shards
        raise AssertionError(f"mesh val: {n1} K1, {select_decode.launches} K3 and {n} K4 launches for 4 batches of 2 "
                             "shards")
    k4 += n
    k3 += n
    k3_tally(n, "mesh val", only="cluster")
    worst = max(abs(rd2[k] - rd1[k]) for k in rd1)
    if worst > 1e-6:
        raise AssertionError(f"mesh val differs from one device by {worst}: {rd2} vs {rd1}")
    log(f"parallel: mesh val of 64 images at 640, batch 16, rect: 4 batches x 2 shards, each shard's shape seen "
        f"once, so eager (K3 and K4 {n} launches each, K1 0); mAP50-95 {rd2['metrics/mAP50-95(B)']:.6f}, every metric "
        f"within {worst:.1e} of one device")

    # (b) the data-parallel train step: two gloo ranks of 8 rows against one process on the global 16
    write_val_dataset(root / "ds", shapes * 16, seed=20, split="train")
    train_data = write_val_dataset(root / "ds", shapes * 4, seed=21, split="val")
    ov = {"data": str(train_data), "imgsz": 640, "batch": 16, "nbs": 16, "val": False, "save": False,
          "optimizer": "SGD", "amp": False, "project": str(root / "runs"), "name": "dp", "workers": 2}
    batch = seeded_batch(ov, train_data, 0)
    rank_loader_numbers(card, ov, train_data)
    model = DetectionModel("yolo11n.yaml").init(0)
    lr = [100.0] * 3  # far above the fp32 rounding of the new weights (see one_step_card_vs_cpu)
    ref = data_parallel_step(0, 1, torch.device("cuda:0"), ov, model, [batch], lr, 0.9, 5)
    ref64 = float64_step(ov, model, batch, lr, 0.9)
    t0 = time.perf_counter()
    ranks = launch(picked_rank_steps, mesh, "gloo", args=(ov, [model], [batch], lr, 0.9, 5))
    t_launch = time.perf_counter() - t0

    def worst(got, want, fl):
        return max((float((got[k].double() - w).norm()) / max(float(w.norm()), fl), k) for k, w in want.items())

    def floors(r64):
        u64 = {k: r64["after"][k] - r64["before"][k] for k in r64["after"]}
        return (1e-5 * max(float(v.norm()) for v in r64["grads"].values()), u64,
                1e-5 * max(float(v.norm()) for v in u64.values()))

    one_g = worst(ref["grads"], ref64["grads"], floors(ref64)[0])

    def held(name, per_rank, b, r64_own, mdl, check_one=True, bound=1e-3):
        """Gradients and updates against the float64 step taken on the ranks' own SPPF picks (the exact step on the
        same side of every near-tie in the max-pools), at `bound`; their distance to the float64 step on its own
        picks, and the picks that differ, logged beside; fg_mask and loss items against the one-process step."""
        outs = [o for o, _ in per_rank]
        picks = [torch.cat([p[i] for _, p in per_rank]) for i in range(3)]
        r64 = float64_step(ov, mdl, b, lr, 0.9, picks)
        fl, u64, ufl = floors(r64)
        gw = worst(outs[0]["grads"], r64["grads"], fl)
        uw = worst({k: outs[0]["after"][k].double() - outs[0]["before"][k].double() for k in u64}, u64, ufl)
        own = worst(outs[0]["grads"], r64_own["grads"], floors(r64_own)[0])
        flips = sum(int((p != q).sum()) for p, q in zip(picks, r64_own["picks"]))
        same = all(torch.equal(o["after"][k], outs[0]["after"][k]) for o in outs for k in u64)
        fg_ok, items = True, 0.0
        if check_one:
            fg = torch.cat([o["fg_mask"][0] for o in outs])
            fg_ok = torch.equal(fg, ref["fg_mask"][0])
            items = max(float(((o["items"][0] - ref["items"][0]).abs() / ref["items"][0].abs()).max()) for o in outs)
        if not fg_ok or items > 1e-4 or gw[0] > bound or uw[0] > bound or not same:
            raise AssertionError(f"{name}: fg equal {fg_ok}, items rel {items}, worst gradient {gw}, worst update "
                                 f"{uw} against the float64 step on the ranks' picks (bound {bound}), ranks equal "
                                 f"{same}; against float64's own picks {own} ({flips} picks differ)")
        log(f"parallel: {name} step on the global batch of 16 at 640 (yolo11n, fp32, SGD lr 100)"
            + (f": fg_mask equal to the one-process step's ({int(fg.sum())} anchors), loss items within "
               f"{items:.2e} of it" if check_one else "")
            + f"; against the float64 step on the ranks' SPPF picks: worst gradient rel L2 {gw[0]:.2e} ({gw[1]}), "
            f"worst update of a weight or BN statistic {uw[0]:.2e} ({uw[1]}), bound {bound:g}; against the float64 "
            f"step on its own picks ({flips} of {sum(p.numel() for p in picks)} picks differ): worst gradient "
            f"{own[0]:.2e} ({own[1]}); every rank's weights, statistics and EMA equal"
            + (f" (the one-process fp32 step: worst gradient {one_g[0]:.2e}, {one_g[1]})" if check_one else ""))

    held("2 gloo ranks on cuda:0", [r[0] for r in ranks], batch, ref64, model)
    log(f"parallel: train step at 640, global batch 16, mean of 5: one process {ref['step_s'] * 1e3:.2f} ms; 2 gloo "
        f"ranks on the one card {ranks[0][0][0]['step_s'] * 1e3:.2f} ms, of which the gradient all_reduce "
        f"{ranks[0][0][0]['sum_grads_s'] * 1e3:.2f} ms; spawn + set-up + steps {t_launch:.1f} s, on {card}")
    nccl = launch(picked_rank_steps, ["cuda:0"], "nccl", args=(ov, [model], [batch], lr, 0.9, 5))
    held("1 NCCL rank", [r[0] for r in nccl], batch, ref64, model)
    log(f"parallel: 1 NCCL rank initialised, stepped ({nccl[0][0][0]['step_s'] * 1e3:.2f} ms a step) and tore down")
    # two more seeds (yolo11n init(seed), the loader shuffled with seed), in one launch
    seeds = (1, 2)
    models = [DetectionModel("yolo11n.yaml").init(sd) for sd in seeds]
    batches = [seeded_batch(ov, train_data, sd) for sd in seeds]
    per_seed = launch(picked_rank_steps, mesh, "gloo", args=(ov, models, batches, lr, 0.9))
    for j, (sd, mdl, b) in enumerate(zip(seeds, models, batches)):
        held(f"2 gloo ranks on cuda:0, seed {sd}", [r[j] for r in per_seed], b, float64_step(ov, mdl, b, lr, 0.9),
             mdl, check_one=False)

    curves, runs = {}, {}
    for name, dev in (("one process", None), ("2 gloo ranks", mesh)):
        m = YOLOLite("yolo11n.yaml")
        with torch.no_grad():  # class biases -6, so the EMA val's conf 0.001 keeps candidates (see train_phase)
            for seq in m.model.detect.cv3:
                seq[2].bias.fill_(-6.0)
        t0 = time.perf_counter()
        m.train(data=str(train_data), epochs=1, imgsz=640, batch=16, amp=False, plots=False,
                project=str(root / "runs"), name=name.replace(" ", "_"), **({"device": dev} if dev else {}))
        runs[name] = (m.trainer, time.perf_counter() - t0)
        curves[name] = np.loadtxt(m.trainer.csv, delimiter=",", skiprows=1, ndmin=2)[:, 1:4]
    t2 = runs["2 gloo ranks"][0]
    n = t2.rank_kernel_launches["blocked_nms_finalize"]
    if not Path(t2.last).exists() or not n or not np.isfinite(curves["2 gloo ranks"]).all() or (
            t2.rank_kernel_launches["select_decode"] != n):
        raise AssertionError(f"2-rank train: last.npz {Path(t2.last).exists()}, rank 0's launches "
                             f"{t2.rank_kernel_launches}")
    feed = t2.rank_feed  # rank 0's batches reached its card through the feed, from page-locked buffers
    if not (feed["pinned"] and feed["batches"] == 64 // 16 and feed["pinned_bytes"] > 0):
        raise AssertionError(f"2-rank train: rank 0's feed {feed}")
    k4 += n
    k3 += n
    k3_tally(n, "2-rank train (rank 0's EMA vals and final val)", routes=t2.rank_select_routes, only="cluster")
    rel = float(np.abs(curves["2 gloo ranks"] / curves["one process"] - 1).max())
    if rel > 1e-3:
        raise AssertionError(f"2-rank loss curve {curves['2 gloo ranks']} vs one process {curves['one process']}")
    log(f"parallel: YOLOLite.train 1 epoch at 640, batch 16, fp32, 64 images, the default 8 loader threads (a rank "
        f"builds its rows): 2 gloo ranks {runs['2 gloo ranks'][1]:.1f}"
        f" s (epoch loop {t2.train_seconds[0]:.3f} s), one process {runs['one process'][1]:.1f} s (epoch loop "
        f"{runs['one process'][0].train_seconds[0]:.3f} s); loss items {curves['2 gloo ranks'][0].round(5).tolist()}"
        f" within {rel:.1e} of the one-process epoch; rank 0 saved last.npz and ran the EMA val and final val with "
        f"K4 {n} launches; rank 0 fed its {feed['batches']} batches from {feed['pinned_bytes'] / 2 ** 20:.1f} MiB of "
        f"page-locked buffers, on {card}")

    # (c) rotated ops: the card against the CPU
    rng = np.random.default_rng(30)

    def obbs(n):
        return torch.from_numpy(np.stack([rng.uniform(20, 620, n), rng.uniform(20, 620, n), rng.uniform(5, 60, n),
                                          rng.uniform(5, 60, n), rng.uniform(0, math.pi / 2, n)], -1)
                                .astype(np.float32))

    boxes, scores = obbs(2000), torch.from_numpy(rng.uniform(0.05, 1, 2000).astype(np.float32))
    bc, sc = boxes.cuda(), scores.cuda()
    err = float((R.batch_probiou(bc, bc).cpu() - R.batch_probiou(boxes, boxes)).abs().max())
    t_iou = cuda_ms(lambda: R.batch_probiou(bc, bc), 10)
    ki, kv = R.nms_rotated(bc, sc, 0.45, 300)
    ci, cv = R.nms_rotated(boxes, scores, 0.45, 300)
    t_nms = cuda_ms(lambda: R.nms_rotated(bc, sc, 0.45, 300), 10)
    anchors, strides = make_anchors([(80, 80), (40, 40), (20, 20)], [8, 16, 32], 0.5)
    anchors = anchors * strides  # image pixels
    B, A, M, nc = 16, 8400, 32, 80
    gt = obbs(B * M).reshape(B, M, 5)
    pd = torch.cat([anchors[None].expand(B, -1, -1) + torch.from_numpy(rng.uniform(-4, 4, (B, A, 2)).astype(
        np.float32)), obbs(B * A).reshape(B, A, 5)[..., 2:]], -1)
    ins = (torch.from_numpy(rng.uniform(0, 1, (B, A, nc)).astype(np.float32)), pd, anchors,
           torch.from_numpy(rng.integers(0, nc, (B, M, 1)).astype(np.int64)), gt,
           torch.from_numpy((rng.uniform(size=(B, M, 1)) > 0.2).astype(np.float32)))
    tal = R.RotatedTaskAlignedAssigner(topk=10, num_classes=nc, alpha=0.5, beta=6.0)
    on_cpu = tal(*ins)
    on_card = tal(*(x.cuda() for x in ins))
    t_tal = cuda_ms(lambda: tal(*(x.cuda() for x in ins)), 5)
    tal_err = max(float((a.cpu().float() - b.float()).abs().max()) for a, b in zip(on_card[1:3], on_cpu[1:3]))
    same = [torch.equal(a.cpu(), b) for i, (a, b) in enumerate(zip(on_card, on_cpu)) if i in (0, 3, 4)]
    if err > 1e-5 or not (torch.equal(ki.cpu(), ci) and torch.equal(kv.cpu(), cv)) or not all(same) or tal_err > 1e-5:
        raise AssertionError(f"rotated card vs CPU: probiou err {err}, nms keep equal {torch.equal(ki.cpu(), ci)}, "
                             f"assigner labels/fg/gt_idx equal {same}, targets err {tal_err}")
    log(f"parallel: rotated ops card == CPU: batch_probiou 2000x2000 max err {err:.1e} ({t_iou:.3f} ms), "
        f"nms_rotated keep equal ({int(kv.sum())} kept, {t_nms:.3f} ms), RotatedTaskAlignedAssigner B={B} A={A} "
        f"M={M}: labels, fg_mask ({int(on_cpu[3].sum())}) and gt indices equal, targets within {tal_err:.1e} "
        f"({t_tal:.3f} ms), on {card}")

    # (d) deformable attention at RT-DETR-L's decoder widths: the card against the CPU
    d, heads, levels, points, queries, ffn, layers, b = 256, 8, 3, 4, 300, 1024, 6, 8
    dec = D.DeformableTransformerDecoder(d, lambda: D.DeformableTransformerDecoderLayer(d, heads, ffn, 0.0, levels,
                                                                                          points), layers).init(0)
    wrng = np.random.default_rng(31)
    bbox_heads = torch.nn.ModuleList(Linear(d, 4) for _ in range(layers))
    score_heads = torch.nn.ModuleList(Linear(d, 80) for _ in range(layers))
    pos_mlp = Linear(4, d)
    parts = torch.nn.ModuleList([dec, bbox_heads, score_heads, pos_mlp])
    with torch.no_grad():
        for p in parts.parameters():  # off the init's zeros, so offsets and weights depend on the queries
            p.add_(torch.from_numpy(wrng.normal(0, 0.02, tuple(p.shape)).astype(np.float32)))
    fshapes = [(80, 80), (40, 40), (20, 20)]
    xs = [torch.from_numpy(wrng.standard_normal(shape).astype(np.float32)) for shape in
          ((b, queries, d), (b, queries, 4), (b, sum(h * w for h, w in fshapes), d))]

    def run(dev):
        parts.to(dev).eval()
        with torch.no_grad():
            return dec(*(x.to(dev) for x in xs), fshapes, bbox_heads=bbox_heads, score_heads=score_heads,
                       pos_mlp=pos_mlp)

    cpu_out = run("cpu")
    card_out = run("cuda")
    t_dec = cuda_ms(lambda: run("cuda"), 10)
    errs = [rel_l2(a.cpu(), c) for a, c in zip(card_out, cpu_out)]
    if max(errs) > 1e-4 or not all(torch.isfinite(a).all() for a in card_out):
        raise AssertionError(f"deformable decoder card vs CPU: relative L2 {errs}")
    log(f"parallel: deformable decoder (d 256, 8 heads, 3 levels 80/40/20, 4 points, 300 queries, d_ffn 1024, 6 "
        f"layers, batch 8) card == CPU: boxes and logits relative L2 {errs[0]:.1e}, {errs[1]:.1e}; forward "
        f"{t_dec:.3f} ms, on {card}")
    tmp.cleanup()
    return {"greedy_nms_keep": k1, "blocked_nms_finalize": k4, "select_decode": k3, "device_letterbox": k2}


def feed_phase(card: str, model, frames) -> None:
    """Phase 9: the feed to the card on predict, val and the pipeline, each run once warm under torch.profiler: its
    host-to-device copies by the source memory's kind, failing on any batch copied from pageable memory
    (`htod_copies`); the hand-over's host ms, each batch's copy ms and GB/s on the card (the trace), and the
    share of each batch's copy that kernels overlapped. Train's and the EMA val's copies are counted in phase 5's
    profiles, rank 0's feed in phase 8. The kernels' launch counts are restored at the end: these runs are
    measurements, not the main paths' runs that the kernels line counts."""
    import tempfile

    import cv2
    import torch

    from yololite_tpu_torch.engine.predictor import DetectionPredictor
    from yololite_tpu_torch.ops.kernels import COUNTED, select_decode
    from yololite_tpu_torch.runtime import InferencePipeline

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    counts, routes = [w.launches for w in COUNTED], select_decode.by_route.as_dict()

    def profiled(what: str, fn, n_img: int, calls: int = 3):
        fn()
        fn()  # a key's first sight runs eagerly, its second captures: the calls below replay
        with htod_profile() as (prof, uploads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        copies = htod_copies(prof, uploads, what)
        log(f"feed: {what}, graphed, {calls} calls under torch.profiler: {calls * n_img / wall:.1f} img/s; "
            f"{copies_text(copies)}; {handover_text(uploads)}, on {card}")

    (root / "frames").mkdir()
    for i in range(128):
        if not cv2.imwrite(str(root / "frames" / f"f{i:03d}.jpg"), frames[i % len(frames)]):
            raise RuntimeError("could not write a frame")
    kw = dict(conf=1e-7, imgsz=640, save=False, verbose=False)
    for what, src, bs, n_img in (("predict yolo11n fp32 at 640, batch 1, one in-memory frame a call", frames[:1], 1, 1),
                                 ("predict yolo11n fp32 at 640, batch 32, 32 in-memory frames a call", frames, 32, 32),
                                 ("predict yolo11n fp32 at 640, batch 32, a folder of 128 480x640 JPEG frames (4 "
                                  "batches a call, decoded on the predictor's Prefetcher thread)", str(root / "frames"),
                                  32, 128)):
        profiled(what, lambda: model.predict(src, batch=bs, **kw), n_img)

    shapes = [(480, 640), (640, 480), (640, 640), (360, 640)] * 8  # rect at batch 16: buckets of 8 to 16
    data = write_val_dataset(root / "val32", shapes, seed=15)
    profiled("val yolo11n fp32 at 640, batch 16, rect, 32 PNGs (the facade: a validator a call)",
             lambda: model.val(data=str(data), imgsz=640, batch=16, rect=True, conf=1e-7, plots=False, verbose=False,
                               project=str(root / "runs"), name="feed"), len(shapes))

    pred = DetectionPredictor(overrides={"conf": 1e-7, "batch": 8, "imgsz": 640, "mode": "predict", "verbose": False,
                                         "save": False})
    pred.setup_model(model.model)
    subs = [frames[(8 * i) % 32:(8 * i) % 32 + 8] for i in range(16)]

    def pipeline():
        pipe = InferencePipeline(pred, imgsz=640).start()
        for b in subs:
            pipe.submit(b)
        pipe.close()
        if len(list(pipe.results())) != len(subs):
            raise AssertionError("pipeline: a submission's result is missing")

    profiled("InferencePipeline yolo11n fp32 at 640, batch 8, 16 submissions (letterboxed on its host thread)",
             pipeline, 8 * len(subs), calls=1)
    for w, n in zip(COUNTED, counts):
        w.launches = n
    for r, n in routes.items():
        setattr(select_decode.by_route, r, n)
    tmp.cleanup()


def main() -> int:
    import os

    # phase 5 holds the train graphs to the eager steps in deterministic mode, which needs cuBLAS's fixed
    # workspace; cuBLAS reads this before its first call in the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from yololite_tpu_torch.engine import graphs
    from yololite_tpu_torch.ops import cuda_build, nms
    from yololite_tpu_torch.ops.kernels import (_select_decode_launch, blocked_nms_finalize, device_letterbox,
                                               device_letterbox_plain, greedy_nms_keep, greedy_nms_keep_plain,
                                               letterbox_geometry, select_decode, select_decode_plain,
                                               select_decode_plan, sigmoid_monotone)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"host: {os.cpu_count()} CPUs")
    card = f"{card}, host {os.cpu_count()} CPUs"  # every number's line names the card, its power limit and the host
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build ----
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = cuda_build.build(sources)
    log(f"build: {len(sources)} kernel source(s) {sources} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        report = path.with_suffix(".log")
        if name == "int8_conv":
            text, gmma = k8_build_report(path)
            if not gmma:
                raise AssertionError("K8's library has no warpgroup MMA instruction in its SASS")
            log(f"  {name}: {text}")
        elif name == "blocked_nms":
            log(f"  {name}: {k4_build_report(path)}")
        elif name in ("dfl", "bce_sum", "topk_rows", "compact_rows"):
            text = loss_tail_build_report(path)
            log(f"  {name}: ptxas per kernel: {text}")
            framed = re.findall(r"(\S*(?:fwd16|bwd16)\S*): \d+ regs, ([1-9]\d*) B stack", text)
            if framed or (name == "dfl" and len(re.findall(r"(?:fwd16|bwd16)", text)) != 12):
                raise AssertionError(f"dfl: the R = 16 kernels (4 of them, 3 types) want no stack frame: {framed}")
        elif report.exists():
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
        ms = graph_ms(lambda: greedy_nms_keep(boxes, valid, 0.45))
        launch_ms = cuda_ms(lambda: greedy_nms_keep(boxes, valid, 0.45), 100)
        plain = cuda_ms(lambda: greedy_nms_keep_plain(boxes, valid, 0.45), 10)
        log(f"kernel: greedy_nms_keep B={b} K={k} (crowded scene): {ms:.4f} ms device (graph replay), "
            f"{launch_ms:.4f} ms a call back to back, plain {plain:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
            f"on {card}")

    # K4 against its plain version: crowded, spread (the first block keeps more than max_det), first block only,
    # all invalid, NaN boxes, disjoint boxes (max_det reached on a step's last candidate), IoUs within a few ulps
    # of the threshold; max_det 1, 300 and K (and 256, 512, 1024 on the disjoint scene); B 40 holds more clusters
    # than the card runs at once
    k4_checks = 0
    k4_shapes = ((1, 8192), (16, 8192), (16, 1500), (4, 2048), (40, 8192), (1, 1025), (16, 8191))
    k4_cases = ("crowded", "spread", "first-block", "invalid", "nan", "disjoint", "near-threshold")
    for b, k in k4_shapes:
        for case in k4_cases:
            args = k4_scene(b * k + len(case), b, k, case)
            for max_det in (1, 300, k) + tuple(d for d in (256, 512, 1024) if case == "disjoint" and d < k):
                got = blocked_nms_finalize(*args, 0.5, max_det)
                want = k4_plain(*args, 0.5, max_det)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    raise AssertionError(f"blocked_nms_finalize != plain at B={b} K={k} {case} max_det {max_det}: "
                                         f"{int((got != want).any(-1).sum())} rows differ")
                k4_checks += 1
    log(f"kernel: blocked_nms_finalize bit-equal to its plain version in {k4_checks} checks: B x K in {k4_shapes}; "
        f"scenes {k4_cases}; max_det 1, 300 and K (256, 512, 1024 on the disjoint scene)")
    k4_crowded = {b: k4_numbers(card, k4_scene(7, b, 8192, "crowded"), 0.7, 300, "crowded scene") for b in (16, 8, 1)}

    # K3 against its plain version on every scene of K3_CASES; K2 on frames of four sizes, both layouts, bgr or not
    if not sigmoid_monotone(torch.device("cuda")):  # what the single-label score pass relies on (ClassMax)
        raise AssertionError("select_decode: its score function is not monotone over every fp32 on this card")
    k3_bits, k3_routes, k3_other = [], {}, []
    for case in K3_CASES:
        args = k3_args(case)
        route = select_decode_plan(args[0], args[2], args[3], args[5], args[8])["route"]
        if route != K3_ROUTES[case[0]]:
            raise AssertionError(f"select_decode scene {case[0]}: route {route}, not {K3_ROUTES[case[0]]}")
        k3_routes[case[0]] = route
        got = select_decode(*args)
        want = select_decode_plain(*args)
        torch.cuda.synchronize()
        if k3_check(got, want, case[0]):
            k3_bits.append(case[0])
        other = {"cluster": "passes", "passes": "cluster"}.get(route)  # the other long-row route, where it can run
        if other and select_decode_plan(args[0], args[2], args[3], args[5], args[8], route=other)["route"]:
            k3_check(_select_decode_launch(*args, route=other)[0], want, f"{case[0]} ({other} route)")
            k3_other.append(f"{case[0]} [{other}]")
    log(f"kernel: select_decode equal to its plain version in {len(K3_CASES)} scenes "
        f"({', '.join(f'{n} [{r}]' for n, r in k3_routes.items())}): "
        f"vals, bidx, cls, valid bit for bit; boxes bit-equal in {len(k3_bits)} of them, within 1e-6 relative in all; "
        f"the other long-row route (select_decode_pick) equal too where it can take the shapes: "
        f"{', '.join(k3_other)}")
    k2_checks = 0
    lb_rng = np.random.default_rng(8)
    for (h0, w0), s in (((480, 640), 640), ((720, 1280), 640), ((333, 517), 320), ((100, 120), 320)):
        raw = torch.from_numpy(lb_rng.integers(0, 256, (3, h0, w0, 3), dtype=np.uint8)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            for bgr in (False, True):
                for channels_last in (False, True):
                    got = device_letterbox(raw, s, dtype, bgr=bgr, channels_last=channels_last)
                    want32 = device_letterbox_plain(raw, s, torch.float32, bgr)
                    err = float((got.float() - want32).abs().max().item())
                    resize = tuple(letterbox_geometry(h0, w0, s)[:2]) != (h0, w0)
                    if err > (1e-5 if dtype == torch.float32 else 2.0 ** -9 + 1e-5) or (
                            not resize and not same_bits(got.contiguous(), want32.to(dtype))):
                        raise AssertionError(f"device_letterbox {h0}x{w0} -> {s} {dtype} bgr {bgr} channels_last "
                                             f"{channels_last}: max |diff| {err:.3g} from its plain version")
                    k2_checks += 1
    log(f"kernel: device_letterbox equal to its plain version in {k2_checks} checks (480x640 and 720x1280 -> 640, "
        f"333x517 and 100x120 -> 320; fp32, bf16; bgr; both layouts): no resize bit for bit, a resize within 1e-5")
    # K2 timed at predict's batch (B 32, 480x640 -> 640, no resize: the smoke's frames) in the layouts predict
    # writes (fp32 NCHW, bf16 channels-last), and at a resizing shape
    frames32 = torch.from_numpy(lb_rng.integers(0, 256, (32, 480, 640, 3), dtype=np.uint8)).cuda()
    k2 = {"fp32": k2_numbers(card, frames32, 640, torch.float32, False, True, "predict's batch, fp32"),
          "bf16": k2_numbers(card, frames32, 640, torch.bfloat16, True, True, "predict's batch, bf16")}
    hd = torch.from_numpy(lb_rng.integers(0, 256, (32, 720, 1280, 3), dtype=np.uint8)).cuda()
    k2["fp32_720x1280"] = k2_numbers(card, hd, 640, torch.float32, False, True, "a 720p batch, fp32")
    del hd, frames32

    # the loss tail (K5, K6a, K6b with their backwards, K7) and K9 against their plain versions
    tail_checks = loss_tail_checks(card)
    k9_checks = compact_rows_checks(card)
    # K10 (the apply) against its plain version, and timed at yolo11n beside its bound and the library's forms
    k10_check = k10_checks(card)
    k10 = k10_numbers(card)

    # ---- 3. slice: yolo11n predict at 640 through the facade ----
    from yololite_tpu_torch.engine.predictor import fp32_convs

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
    k3_launches = k2_launches = 0  # K3's and K2's launches on the main paths
    k3_pred, nms_pred = {}, {}  # K3's numbers and nms_from_feats's times on predict's batch-32 maps, by dtype
    for half in (False, True):
        for bs in (1, 32):
            config = (half, bs)
            src = frames[:bs]
            kw = dict(conf=1e-7, imgsz=640, batch=bs, half=half, save=False, verbose=False)
            for _ in range(2):  # set up and warm up (the first call runs eagerly), then capture (the second)
                model.predict(src, **kw)
            nms._exact_keep = recording_keep
            try:
                with graphs.eager():  # the eager call: the exact keep's inputs, and its time below
                    eager_results = model.predict(src, **kw)
            finally:
                nms._exact_keep = exact_keep
            greedy_nms_keep.launches = device_letterbox.launches = 0
            k3_zero()
            n_graphs = len(model.predictor._graphs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                results = model.predict(src, **kw)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / reps
            n = greedy_nms_keep.launches
            if (n, select_decode.launches, device_letterbox.launches) != (reps,) * 3:
                # one letterbox, one select of K = 512 and one exact keep per predict call, counted at each replay
                raise AssertionError(f"K1, K3 and K2 launched {n}, {select_decode.launches} and "
                                     f"{device_letterbox.launches} times in {reps} predict calls")
            k3_launches += reps
            k3_tally(reps, f"predict {'bf16' if half else 'fp32'} batch {bs}", only="finish")
            k2_launches += reps
            if len(model.predictor._graphs) != n_graphs or not n_graphs:  # replays only, no capture
                raise AssertionError(f"{len(model.predictor._graphs) - n_graphs} graphs captured in the timed calls")
            with graphs.eager():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    eager_results = model.predict(src, **kw)
                torch.cuda.synchronize()
                dt_eager = (time.perf_counter() - t0) / reps
            for a, b in zip(results, eager_results):
                if not np.array_equal(a.boxes.data, b.boxes.data):
                    raise AssertionError(f"graphed predict differs from eager at batch {bs} ({'bf16' if half else 'fp32'})")
            wall, busy, events = profile_calls(lambda: model.predict(src, **kw), 3)
            idle = "not measured (the profiler saw no device activity)" if busy is None else \
                f"{1 - busy / wall:.3f} ({busy / 3:.2f} ms busy of {wall / 3:.2f} ms a call, {events} device events)"
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
            log(f"slice: yolo11n {dtype} batch {bs} at 640, graphed: {dt * 1e3:.2f} ms/batch, "
                f"{bs / dt:.1f} img/s, {sum(len(r) for r in results) / bs:.1f} detections/img, "
                f"{n} launches of K1, K3 and K2 each in {reps} calls; eager {dt_eager * 1e3:.2f} ms/batch, "
                f"{bs / dt_eager:.1f} "
                f"img/s; detections equal; device idle share of a graphed call {idle}, on {card}")

            pred = model.predictor
            raw = torch.from_numpy(np.stack(src)).cuda().flip(-1)
            dets = pred.infer_uint8(raw, 640)
            if tuple(dets.shape) != (bs, pred.max_det, 6) or not torch.isfinite(dets).all():
                raise AssertionError(f"predict tensor {tuple(dets.shape)} not finite or not (B, max_det, 6)")
            with graphs.eager():
                if not same_bits(dets, pred.infer_uint8(raw, 640)):
                    raise AssertionError(f"the graphed step's tensor differs from the eager step's ({dtype}, {bs})")
            t_step = cuda_ms(lambda: pred.infer_uint8(raw, 640), 10)
            with graphs.eager():
                t_step_eager = cuda_ms(lambda: pred.infer_uint8(raw, 640), 10)
            log(f"slice: the step alone (infer_uint8: letterbox, forward, NMS; {dtype}, batch {bs}), bit-equal: "
                f"graph replay {t_step:.3f} ms, eager {t_step_eager:.3f} ms, on {card}")
            # on this batch's Detect maps: the kernel against the plain keep inside nms_from_feats,
            # then each stage of the predict graph timed alone
            layout = pred.letterbox_channels_last(raw.device)
            with torch.inference_mode(), fp32_convs(raw.device):
                x = device_letterbox(raw, 640, pred.dtype, channels_last=layout)
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
                t_lb = cuda_ms(lambda: device_letterbox(raw, 640, pred.dtype, channels_last=layout), 10)
                t_fw = cuda_ms(lambda: pred._forward(x), 10)
                t_nms = cuda_ms(lambda: nms.nms_from_feats(*args, **kw_nms), 10)
                if bs == 32:  # the forward on the other input layout, which K2 could write instead
                    x_other = device_letterbox(raw, 640, pred.dtype, channels_last=not layout)
                    t_fw_other = cuda_ms(lambda: pred._forward(x_other), 10)
                    log(f"slice: forward ({dtype}, batch 32) on an NCHW-contiguous input "
                        f"{t_fw if not layout else t_fw_other:.3f} ms, on a channels-last input "
                        f"{t_fw_other if not layout else t_fw:.3f} ms (K2 writes "
                        f"{'channels-last' if layout else 'NCHW'}), on {card}")
                    del x_other
                if bs == 32:  # K3 on this batch's maps, and nms_from_feats with K3 against with its plain version
                    k3_pred[dtype] = k3_numbers(card, (feats, *args[1:], pred.conf, pred.pred_max_cand, None,
                                                       pred.half, False, False), f"predict's {dtype} maps")
                    with plain_select():
                        same = torch.equal(with_kernel, nms.nms_from_feats(*args, **kw_nms))
                        t_plain = cuda_ms(lambda: nms.nms_from_feats(*args, **kw_nms), 10)
                    nms_pred[dtype] = {"k3": t_nms, "plain_select": t_plain,
                                       "k3_graph": graph_ms(lambda: nms.nms_from_feats(*args, **kw_nms))}
                    log(f"slice: nms_from_feats K={pred.pred_max_cand} ({dtype}, batch 32) with K3 {t_nms:.3f} ms "
                        f"(device time, graph replay: {nms_pred[dtype]['k3_graph']:.4f} ms), with K3's plain version "
                        f"(the path before K3) {t_plain:.3f} ms, back-to-back calls; detections "
                        f"{'equal' if same else 'NOT equal'}, on {card}")
            busy = t_lb + t_fw + t_nms
            log(f"slice: stages alone ({dtype}, batch {bs}, input {'channels-last' if layout else 'NCHW'}): "
                f"letterbox {t_lb:.3f} ms, forward {t_fw:.3f} ms, "
                f"nms_from_feats {t_nms:.3f} ms; their sum is {busy / (dt * 1e3):.1%} of the "
                f"{dt * 1e3:.2f} ms predict call, on {card}")

    mixed_sizes_stream(card)

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

    # ---- 4. val: yolo11n val at 640 through the facade ----
    k4_launches, k3_val, val_k4 = val_phase(card, model)
    k3_launches += k3_val["launches"]

    # ---- 9 (run here, before the processes of phase 8): the feed on predict, val and the pipeline, profiled; no batch
    # from pageable memory (measurements only: its launches are taken back, they are not the main paths') ----
    feed_phase(card, model, frames)

    # ---- 5. train: yolo11n train at 640 through the facade ----
    counts = train_phase(card)

    # ---- 6. serving: .pt, ensembles, int8 with K8, export, the pipeline, embed ----
    serving_k1, k8_launches, k8, serving_k32 = serving_phase(card, frames)
    launches += serving_k1
    k3_launches += serving_k32["select_decode"]
    k2_launches += serving_k32["device_letterbox"]

    # ---- 7. zoo: YOLOv10-N and GELAN-T at full width: predict, val, train, .pt, int8 refusal, card vs CPU ----
    # ---- 8. data parallelism on the card (mesh predict and val, ranks' train step and train), rotated ops,
    # deformable attention ----
    for more in (counts, zoo_phase(card, frames), parallel_phase(card, frames)):
        launches += more["greedy_nms_keep"]
        k4_launches += more["blocked_nms_finalize"]
        k3_launches += more["select_decode"]
        k2_launches += more["device_letterbox"]

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
        ms = graph_ms(lambda: greedy_nms_keep(boxes, valid, thr))
        launch_ms = cuda_ms(lambda: greedy_nms_keep(boxes, valid, thr), 100)
        plain = cuda_ms(lambda: greedy_nms_keep_plain(boxes, valid, thr), 20)
        log(f"kernel: greedy_nms_keep B={b} K={k} (the main path's fp32 inputs, {int(want.sum())} kept): "
            f"{ms:.4f} ms device (graph replay), {launch_ms:.4f} ms a call back to back, plain {plain:.4f} ms, "
            f"bound {bound:.5f} ms ({bound_by}), on {card}")
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
        "launch_ms": launch_ms,  # back-to-back launches timed by CUDA events, as PRs 1-8 reported "ms"
        "shape": [b, k],
    }
    k4_entry = {
        "name": "blocked_nms_finalize",
        "route": "cuda",
        "source": "yololite_tpu_torch/csrc/blocked_nms.cu",
        "replaces": "yololite_tpu/ops/nms.py:164",  # _blocked_keep, then :281 _finalize: XLA ops, not Pallas
        "launches": k4_launches,
        "max_abs_err": val_k4["val_max_abs_err"],
        "ms": val_k4["val_ms"],
        "launch_ms": val_k4["val_launch_ms"],
        "plain_ms": val_k4["val_plain_ms"],
        "bound_ms": val_k4["val_bound_ms"],
        "bound_by": val_k4["val_bound_by"],
        "library_ms": None,  # no PyTorch call computes greedy NMS
        "shape": val_k4["val_shape"],  # [B, K, max_det] of val's first fp32 batch
        "cluster": val_k4["val_cluster"],  # CTAs an image (csrc/blocked_nms.cu cluster_for)
        "step": val_k4["val_step"],  # candidates a step
        "max_active_clusters": val_k4["val_max_active_clusters"],
        "crowded": {f"B{b}": {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "cluster", "max_active_clusters")}
                    for b, v in k4_crowded.items()},  # chip_smoke's crowded scene at K 8192, iou 0.7, max_det 300
        **{k: v for k, v in val_k4.items() if not k.startswith("val_") or k.startswith("val_nms")},
    }
    k8_entry = {
        "name": "int8_conv",
        "route": "cuda",
        "source": "yololite_tpu_torch/csrc/int8_conv.cu",
        "replaces": "yololite_tpu/models/modules.py:176",  # Conv's int8 branch: an XLA op, not a Pallas kernel
        "launches": k8_launches,
        "library_ms": None,  # no PyTorch call computes an int8 convolution with this epilogue (int_mm_1x1_ms below)
        "shape": "the 76 quantized convs of one yolo11n forward at 640, batch 32, summed (device time)",
        **k8,
    }
    if sum(K3_MAIN_ROUTES.values()) != k3_launches:
        raise AssertionError(f"select_decode: the main paths' {k3_launches} launches, by route {K3_MAIN_ROUTES}")
    log(f"kernel: select_decode launches on the main paths by the route taken (each window's counts zeroed at its "
        f"start; graph replays included): {K3_MAIN_ROUTES} of {k3_launches}; every val and EMA val launch on the "
        f"cluster route, every predict launch on the finish route, on {card}")
    k3_entry = {
        "name": "select_decode",
        "route": "cuda",
        "source": "yololite_tpu_torch/csrc/select_decode.cu",
        "replaces": "yololite_tpu/ops/nms.py:357",  # nms_from_feats steps 1-4 (:409-494): XLA ops shaped by hand
        "launches": k3_launches,
        # on val's first fp32 batch (B 16, K 8,192 multi-label); predict's batch-32 maps under "predict"
        **{key: k3_val["numbers"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "shape", "boxes_bit_equal", "kernels_a_call",
                                                    "score_ms", "score_tb_s", "list_lengths")},
        "k3_route": k3_val["numbers"]["route"],  # select_decode_plan's route; "route" is the contract's "cuda"
        # the three routes: finish on predict's fp32 maps, cluster and passes (select_decode_pick, in turns) on
        # val's fp32 and bf16 maps, the sparse, bunched, B 72 and B 136 scenes and the EMA val's own maps in phase
        # 5's fp32 and bf16 trains; and the main paths' launches by the route taken
        "routes": {"finish": {key: k3_pred["fp32"][key] for key in ("ms", "kernels_a_call")},
                   **{r: {**{d: v[r] for d, v in k3_val["routes"].items() if r in v},
                          **{f"ema_{d}": v[r] for d, v in K3_EMA_ROUTES.items() if r in v}}
                      for r in ("cluster", "passes")}},
        "launches_by_route": dict(K3_MAIN_ROUTES),
        "library": "torch.topk on the gated row (its tie order is not lax.top_k's: a yardstick)",
        "predict": {d: {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "boxes_bit_equal",
                                                "route", "kernels_a_call", "score_ms", "score_tb_s")}
                    for d, v in k3_pred.items()},
        "nms_from_feats_ms": {"val": {"with_k3": k3_val["nms_ms"], "with_k3_device": k3_val["nms_graph_ms"],
                                      "plain_select": k3_val["nms_plain_select_ms"]},
                              **{f"predict_{d}": {"with_k3": v["k3"], "with_k3_device": v["k3_graph"],
                                                  "plain_select": v["plain_select"]} for d, v in nms_pred.items()}},
    }
    k2_entry = {
        "name": "device_letterbox",
        "route": "cuda",
        "source": "yololite_tpu_torch/csrc/letterbox.cu",
        "replaces": "yololite_tpu/ops/pallas_kernels.py:89",  # device_letterbox: XLA ops, not a Pallas kernel
        "launches": k2_launches,
        # B 32, 480x640 -> 640 (no resize), fp32 NCHW out, as predict's fp32 path writes it
        **{key: k2["fp32"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                             "shape")},
        "library": "F.interpolate bilinear (align_corners False) of the resize alone",
        "bf16": {key: k2["bf16"][key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "fp32_720x1280": {key: k2["fp32_720x1280"][key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                                     "max_abs_err")},
    }
    tail = counts["loss_tail"]  # the loss tail at the train step's shapes (loss_tail_numbers); launches: phase 5 (b)
    keys = ("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")  # ms warm, cold_ms cold

    def tail_entry(name, backward, source, replaces, library):
        f, h = tail[name]["float32"], tail[name]["bfloat16"]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": counts[name],
                 **{k: f[k] for k in keys}, "shape": f["shape"], "library": library,
                 "bf16": {k: h[k] for k in keys}}
        if backward:  # the backward kernel of the same source: its own wrapper, launches and numbers
            fb, hb = tail[backward]["float32"], tail[backward]["bfloat16"]
            entry["backward"] = {"name": backward, "launches": counts[backward], **{k: fb[k] for k in keys},
                                 "bf16": {k: hb[k] for k in keys}}
        return entry

    k5_entry = tail_entry("dfl_expectation", "dfl_expectation_backward", "yololite_tpu_torch/csrc/dfl.cu",
                          "yololite_tpu/ops/decode.py:75", None)  # the custom vjp of dfl_expectation_mm: XLA ops
    # no one call computes K5; two do (loss_tail_numbers), timed beside it
    k5_entry["yardstick"] = "softmax over the 16 bins into fp32, then a matmul with the bin indices: two calls"
    k5_entry["yardstick_ms"] = tail["dfl_expectation"]["float32"]["yardstick_ms"]
    k5_entry["bf16"]["yardstick_ms"] = tail["dfl_expectation"]["bfloat16"]["yardstick_ms"]
    k6a_entry = tail_entry("dfl_ce_mean", "dfl_ce_backward", "yololite_tpu_torch/csrc/dfl.cu",
                           "yololite_tpu/utils/loss.py:237", "F.cross_entropy with the two-hot probabilities")
    k6b_entry = tail_entry("bce_sum", "bce_sum_backward", "yololite_tpu_torch/csrc/bce_sum.cu",
                           "yololite_tpu/utils/loss.py:283", "F.binary_cross_entropy_with_logits, reduction sum")
    k6b_entry["sum_rel_err"] = tail_checks["bce_sum_rel_err"]  # the largest over phase 2's checks, vs BCE_SUM_RTOL
    k6b_entry["sum_rel_err_least"] = tail_checks["bce_sum_rel_err_least"]
    t32, t64, t320 = (tail["topk_rows"][key] for key in ("M32", "M64", "M32_A2100"))
    from yololite_tpu_torch.ops.loss_kernels import topk_rows_plan

    k7_plan = topk_rows_plan(torch.zeros(t32["shape"][:3], device="cuda"), t32["shape"][3])  # the step's layout
    k7_entry = {"name": "topk_rows", "route": "cuda", "source": "yololite_tpu_torch/csrc/topk_rows.cu",
                "replaces": "yololite_tpu/utils/tal.py:61",  # topk_blockmax_gather (and :97 topk_hierarchical)
                "launches": counts["topk_rows"], **{k: t32[k] for k in keys}, "shape": t32["shape"],
                "plan": {k: k7_plan[k] for k in ("route", "items")},
                "library": "torch.topk (its tie order is not lax.top_k's: a yardstick)",
                "M64": {**{k: t64[k] for k in keys}, "shape": t64["shape"]},
                "M32_A2100": {**{k: t320[k] for k in keys}, "shape": t320["shape"]}}
    k9 = counts["compact_rows_numbers"]  # B 16, A 8,400, K 320 on the assigner's masks; launches: phase 5 (b)
    f9, h9 = k9["compact_rows"]["float32"], k9["compact_rows"]["bfloat16"]
    fb9, hb9 = k9["compact_rows_backward"]["float32"], k9["compact_rows_backward"]["bfloat16"]
    k9_entry = {"name": "compact_rows", "route": "cuda", "source": "yololite_tpu_torch/csrc/compact_rows.cu",
                "replaces": "yololite_tpu/utils/loss.py:162",  # lax.top_k and the one-hot contraction (:162-172)
                "launches": counts["compact_rows"], **{k: f9[k] for k in keys}, "shape": f9["shape"],
                "nfg": f9["nfg"], "library": "a stable torch.sort of fg, then torch.gather (two calls: a yardstick)",
                "floor_ms": f9["floor_ms"], "kernels_a_call": k9_checks["kernels_a_call"],  # phase 2's count
                "bf16": {k: h9[k] for k in keys},
                "backward": {"name": "compact_rows_backward", "launches": counts["compact_rows_backward"],
                             **{k: fb9[k] for k in keys}, "bf16": {k: hb9[k] for k in keys}}}
    k10a, k10s = k10["AdamW"], k10["SGD"]  # yolo11n's apply; launches: phase 5 (b)'s graphed runs and the resume
    k10_keys = ("ms", "warm_ms", "apply_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "parent_apply_ms",
                "mbytes", "device_kernels_an_apply", "parent_device_kernels_an_apply")
    k10_entry = {"name": "optim_apply", "route": "cuda", "source": "yololite_tpu_torch/csrc/optim_apply.cu",
                 # apply_step (:342-350) and fused_step's tail (:374-378): XLA ops, not a Pallas kernel
                 "replaces": "yololite_tpu/engine/trainer.py:342",
                 "launches": counts["optim_apply"], "max_abs_err": k10_check["max_abs_err"],
                 **{k: k10a[k] for k in k10_keys}, "norm_rel_err": k10_check["norm_rel_err"],
                 "shape": f"yolo11n AdamW: {k10a['trainable']} trainable tensors, {k10a['values']} values",
                 "library": "torch.optim.AdamW(fused=True) stepping alone (parent_apply_ms: the parent's whole apply "
                            "as a graph)",
                 "SGD": {k: k10s[k] for k in k10_keys}}
    log(json.dumps({"kernels": [entry, k3_entry, k2_entry, k4_entry, k8_entry, k5_entry, k6a_entry, k6b_entry,
                                k7_entry, k9_entry, k10_entry]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
