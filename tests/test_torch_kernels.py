"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor yololite_tpu, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from chip_smoke import (COMPACT_CASES, COMPACT_ROUTES, K3_CASES, K3_RECT, K3_ROUTES, K10_RULES, LOSS_TAIL_EDGE_SHAPES,
                        LOSS_TAIL_ROUTES, LOSS_TAIL_SHAPES, TOPK_CASES, bce_sum_kernel_order, compact_case_check,
                        compact_gradient, compact_kernels_a_call, compact_layout, compact_mask, e2e_loss_check,
                        k10_rule_check, k3_args, k3_check, k3_maps, k4_scene, loss_tail_case, loss_tail_case_checks,
                        loss_tail_check, loss_tail_inputs, loss_tail_metrics, loss_tail_pairs, loss_tail_step_check,
                        replays_from_third_sight, same_bits, topk_case_check)
from yololite_tpu_torch.engine import graphs
from yololite_tpu_torch.ops import loss_kernels as L
from yololite_tpu_torch.ops.kernels import (blocked_nms_finalize, blocked_nms_finalize_plain, device_letterbox,
                                           device_letterbox_plain, greedy_nms_keep, greedy_nms_keep_plain, int8_conv,
                                           int8_conv_plain, select_decode, select_decode_plain)

pytestmark = pytest.mark.cuda

# the train graphs are held to the eager steps in deterministic mode, which needs cuBLAS's fixed workspace; cuBLAS
# reads this before its first call in the process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(rng, b, k, chain):
    """(B, K, 4) boxes and (B, K) valid: crowded random boxes, or alternating suppression chains."""
    if chain:  # box i overlaps i+1 (IoU 9/17) and i+2 little (5/21): keeps alternate, holes flip the parity
        x = np.arange(k, dtype=np.float32) * 4.0
        boxes = np.broadcast_to(np.stack([x, np.zeros(k), x + 13.0, np.full(k, 10.0)], 1), (b, k, 4))
        return np.ascontiguousarray(boxes, np.float32), rng.uniform(size=(b, k)) > 0.05
    c = rng.uniform(20, 600, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32), rng.uniform(size=(b, k)) > 0.1


@pytest.mark.parametrize("chain", [False, True], ids=["crowded", "chain"])
@pytest.mark.parametrize("k", [1, 63, 65, 128, 300, 1024])
def test_keep_kernel_matches_plain(card, k, chain):
    """Keep masks from boxes bit-equal to the plain version; one launch per call.

    K = 1024 takes 148 KB of shared memory, past the 48 KB a launch gets
    without asking; 1, 63 and 65 leave ragged words.
    """
    boxes, valid = _scene(np.random.default_rng(k + chain), 8, k, chain)
    bx = torch.from_numpy(boxes).to(card)
    v = torch.from_numpy(valid).to(card)
    before = greedy_nms_keep.launches
    got = greedy_nms_keep(bx, v, 0.45)
    torch.cuda.synchronize()
    assert greedy_nms_keep.launches == before + 1
    want = greedy_nms_keep_plain(bx, v, 0.45)
    assert torch.equal(got, want)
    if k > 1:
        assert 0 < int(want.sum()) < int(v.sum())


def test_keep_kernel_rejects_what_it_does_not_take(card):
    boxes = torch.zeros(2, 64, 4, device=card)
    valid = torch.ones(2, 64, dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        greedy_nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(TypeError):
        greedy_nms_keep(boxes, valid.float(), 0.5)
    with pytest.raises(ValueError):
        greedy_nms_keep(boxes[..., :3].contiguous(), valid, 0.5)
    with pytest.raises(ValueError):
        greedy_nms_keep(torch.zeros(2, 4, 64, device=card).transpose(1, 2), valid, 0.5)
    with pytest.raises(ValueError):
        greedy_nms_keep(boxes, valid.cpu(), 0.5)
    big = torch.zeros(1, 1025, 4, device=card)
    with pytest.raises(ValueError):
        greedy_nms_keep(big, torch.ones(1, 1025, dtype=torch.bool, device=card), 0.5)


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_predict_through_the_kernel_equals_the_plain_keep(card, half, monkeypatch):
    """yolo11n predict on the card launches the kernel, and its detections equal those of the plain keep."""
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.ops import nms

    rng = np.random.default_rng(0)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    kw = dict(conf=1e-7, imgsz=160, batch=2, half=half, save=False, verbose=False)
    model = YOLOLite("yolo11n.yaml")
    before = greedy_nms_keep.launches
    with_kernel = model.predict(src, **kw)
    assert greedy_nms_keep.launches > before
    monkeypatch.setattr(nms, "greedy_nms_keep", greedy_nms_keep_plain)
    with graphs.eager():  # a replay would run the captured kernel, not the plain keep
        with_plain = model.predict(src, **kw)
    for a, b in zip(with_kernel, with_plain):
        assert len(a) > 0 and np.isfinite(a.boxes.data).all()
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_val_nms_through_the_kernel_equals_the_plain_keep(card, half, monkeypatch):
    """One val batch's K = 8192 multi-label nms_from_feats: through K4, one launch and no K1, as through the plain
    version (the blocked keep with the plain keep, then _finalize)."""
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs, inference_net
    from yololite_tpu_torch.ops import nms

    model = YOLOLite("yolo11n.yaml").model
    net = inference_net(model, card, half)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 256, 320, 3), np.uint8)).to(card)
    with torch.inference_mode(), fp32_convs(card):
        x = (x.float() * (1.0 / 255.0)).to(torch.bfloat16 if half else torch.float32)
        feats = [f.float() for f in forward_nhwc(net, x)]
        kw = dict(conf_thres=1e-7, iou_thres=0.7, max_det=300, max_cand=8192, multi_label=True)
        k1, k4 = greedy_nms_keep.launches, blocked_nms_finalize.launches
        with_kernel = nms.nms_from_feats(feats, model.strides, model.nc, model.reg_max, **kw)
        torch.cuda.synchronize()
        assert (greedy_nms_keep.launches - k1, blocked_nms_finalize.launches - k4) == (0, 1)
        monkeypatch.setattr(nms, "greedy_nms_keep", greedy_nms_keep_plain)
        monkeypatch.setattr(nms, "blocked_nms_finalize", blocked_nms_finalize_plain)
        with_plain = nms.nms_from_feats(feats, model.strides, model.nc, model.reg_max, **kw)
    assert int((with_kernel[..., 4] > 0).sum()) > 0
    assert torch.equal(with_kernel, with_plain)


def test_mesh_predict_launches_the_kernel_once_per_shard(card):
    """A mesh of two replicas on cuda:0: a batch of 4 runs as two shards, K1 once in each, with the one-device
    detections; a batch of 3 does not divide and runs whole on the first device, K1 once."""
    from yololite_tpu_torch import YOLOLite

    rng = np.random.default_rng(2)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(4)]
    one, two = YOLOLite("yolo11n.yaml"), YOLOLite("yolo11n.yaml", device=["cuda:0", "cuda:0"])
    for n in (4, 3):
        kw = dict(conf=1e-7, imgsz=160, batch=n, save=False, verbose=False)
        want = one.predict(src[:n], **kw)
        for _ in range(2):  # set up and warm up (eagerly), then capture
            two.predict(src[:n], **kw)
        before = greedy_nms_keep.launches
        got = two.predict(src[:n], **kw)
        assert greedy_nms_keep.launches - before == (2 if n % 2 == 0 else 1)
        assert two.predictor.mesh is not None and len(two.predictor.replicas) == 2
        for a, b in zip(want, got):
            assert len(a) > 0 and len(a) == len(b)
            np.testing.assert_allclose(b.boxes.data, a.boxes.data, rtol=1e-4, atol=0.05)


def test_keep_op_equals_the_direct_launch(card):
    """The K1 op through torch.library (torch.ops) equals the wrapper's launch and counts one launch."""
    boxes, valid = _scene(np.random.default_rng(5), 16, 512, False)
    bx, v = torch.from_numpy(boxes).to(card), torch.from_numpy(valid).to(card)
    before = greedy_nms_keep.launches
    via_op = torch.ops.yololite_tpu_torch.greedy_nms_keep(bx, v, 0.45)
    direct = greedy_nms_keep(bx, v, 0.45)
    torch.cuda.synchronize()
    assert greedy_nms_keep.launches == before + 2
    assert torch.equal(via_op, direct) and torch.equal(direct, greedy_nms_keep_plain(bx, v, 0.45))


# (name, batch, Cin, H, W, Cout, k, stride, groups, act, sout, x dtype, route): yolo11n's kinds of quantized
# conv, each route of csrc/int8_conv.cu, and their edges (Cin tails, wide and narrow Cout, odd frames, partial
# tiles, batch 1, float inputs quantized in the load, bf16 out, every activation). The 3x3 convs of groups 1 take
# route 1 (yolo11's 160x160, 320x320 and 40x40 shapes at batch 32, Cin tails of 8 and 48 inside a chunk, a Cin of 40
# in 8-byte copies); the 1x1 convs of Cin a multiple of 16 take gemm1x1 where csrc/int8_conv.cu prefer_1x1 picks it
# (yolo11m's float edges, M and K tails, Cout 256 and 512, Cin 1024), the others keep route 1, as does Cin 8 (a tensor
# map's row pitch is a multiple of 16 bytes). Every case is also held on each other route that can run it.
I8, BF16, FP32 = torch.int8, torch.bfloat16, torch.float32
K8_CASES = [
    ("stem-fp32", 1, 3, 64, 64, 16, 3, 2, 1, 1, 0.05, FP32, "direct"),
    ("stem-bf16", 2, 3, 33, 31, 16, 3, 2, 1, 1, 0.05, BF16, "direct"),
    ("stem-cout8-bf16-out", 1, 3, 20, 21, 8, 3, 2, 1, 2, 0.0, FP32, "direct"),
    ("1x1-cin3", 2, 3, 9, 7, 64, 1, 1, 1, 0, 0.05, I8, "direct"),
    ("1x1", 32, 64, 20, 20, 64, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("1x1-b32-160", 32, 32, 160, 160, 32, 1, 1, 1, 1, 0.05, I8, "gemm1x1"),
    ("3x3-s2", 1, 64, 40, 40, 128, 3, 2, 1, 1, 0.05, I8, "gemm"),
    ("3x3-s2-odd-hw", 3, 16, 15, 11, 32, 3, 2, 1, 1, 0.05, I8, "gemm"),
    ("odd-hw", 2, 32, 13, 9, 48, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("m-tail", 1, 64, 7, 9, 128, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("cin8", 2, 8, 24, 24, 16, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("cin16", 2, 16, 24, 20, 32, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("cin48-cout8", 4, 48, 20, 20, 8, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("cin80-cout80-bf16-in-out", 32, 80, 20, 20, 80, 1, 1, 1, 1, 0.0, BF16, "gemm1x1"),
    ("1x1-cin256-bf16-in", 8, 256, 20, 20, 256, 1, 1, 1, 1, 0.05, BF16, "gemm1x1"),
    ("3x3-fp32-in", 2, 64, 12, 12, 64, 3, 1, 1, 1, 0.05, FP32, "gemm"),
    ("cout512", 2, 256, 10, 10, 512, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("cout256-3x3-cin512", 2, 512, 20, 20, 256, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("bf16-out", 32, 128, 10, 10, 64, 3, 1, 1, 1, 0.0, I8, "gemm"),
    ("identity", 2, 16, 8, 8, 24, 1, 1, 1, 0, 0.05, I8, "gemm"),
    ("relu", 2, 32, 16, 16, 64, 3, 1, 1, 2, 0.05, I8, "gemm"),
    ("dwconv", 32, 80, 20, 20, 80, 3, 1, 80, 1, 0.0, I8, "depthwise"),
    ("dwconv-s2-int8-out", 2, 64, 17, 13, 64, 3, 2, 64, 1, 0.05, I8, "depthwise"),
    ("dwconv-bf16-in", 1, 32, 9, 9, 32, 3, 1, 32, 0, 0.05, BF16, "depthwise"),
    ("groups2", 2, 16, 8, 8, 32, 3, 1, 2, 1, 0.05, I8, "direct"),
    ("cin12", 1, 12, 10, 10, 16, 3, 1, 1, 2, 0.0, I8, "direct"),
    ("1x1-m-bf16-edge-80x80", 32, 256, 80, 80, 256, 1, 1, 1, 1, 0.0, BF16, "gemm1x1"),
    ("1x1-m-bf16-edge-int8-out", 32, 512, 20, 20, 512, 1, 1, 1, 1, 0.05, BF16, "gemm1x1"),
    ("1x1-fp32-in-relu", 2, 64, 12, 12, 64, 1, 1, 1, 2, 0.05, FP32, "gemm1x1"),
    ("1x1-cin8", 2, 8, 24, 24, 16, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("1x1-m-tail", 3, 64, 7, 9, 128, 1, 1, 1, 1, 0.05, I8, "gemm1x1"),
    ("1x1-cout256", 4, 128, 16, 16, 256, 1, 1, 1, 1, 0.05, I8, "gemm1x1"),
    ("1x1-cout512-cin384", 2, 384, 20, 20, 512, 1, 1, 1, 1, 0.05, I8, "gemm1x1"),
    ("1x1-cin1024-cout256-bf16-out", 4, 1024, 20, 20, 256, 1, 1, 1, 1, 0.0, I8, "gemm1x1"),
    ("1x1-cin1024-cout512", 4, 1024, 20, 20, 512, 1, 1, 1, 1, 0.05, I8, "gemm1x1"),
    ("1x1-40x40-cout128-keeps-gemm", 32, 256, 40, 40, 128, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("1x1-cin512-cout512-keeps-gemm", 32, 512, 20, 20, 512, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("1x1-b1-cout80-keeps-gemm", 1, 64, 80, 80, 80, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("1x1-cin48-cout80-k-tail", 4, 48, 20, 20, 80, 1, 1, 1, 1, 0.05, I8, "gemm"),
    ("1x1-cin48-bf16-k-tail", 4, 48, 20, 20, 64, 1, 1, 1, 0, 0.05, BF16, "gemm1x1"),
    ("3x3-cin16-160-b32", 32, 16, 160, 160, 8, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("3x3-cin32-s2-320", 4, 32, 320, 320, 64, 3, 2, 1, 1, 0.05, I8, "gemm"),
    ("3x3-cin128-40-b32", 32, 128, 40, 40, 128, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("3x3-cin48-k-tail", 2, 48, 20, 20, 64, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("3x3-cin40-granule8", 2, 40, 12, 12, 32, 3, 1, 1, 1, 0.05, I8, "gemm"),
    ("3x3-bf16-in-cin16-s2", 2, 16, 21, 19, 32, 3, 2, 1, 1, 0.0, BF16, "gemm"),
    ("3x3-bf16-in-cin8", 2, 8, 20, 24, 16, 3, 1, 1, 1, 0.05, BF16, "gemm"),
    ("3x3-b1-20x20-cout256", 1, 256, 20, 20, 256, 3, 1, 1, 1, 0.05, I8, "gemm"),
]


def _k8_inputs(rng, card, b, cin, h, w, cout, k, groups, xdtype, pitch=None, offset=0):
    """x (B, Cin, H, W) channels-last on the card (a channel slice [offset, offset + Cin) of a channels-last tensor of
    `pitch` channels where given), int8 or a float quantized at 1/64 (some values clamp at +-127), and the weights."""
    full = pitch or cin
    if xdtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (b, full, h, w)).astype(np.int8)).to(card)
    else:  # an image or a bf16 island's output
        x = torch.from_numpy(rng.uniform(-0.5, 2.5, (b, full, h, w)).astype(np.float32)).to(card, xdtype)
    x = x.contiguous(memory_format=torch.channels_last)[:, offset:offset + cin]
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin // groups)).astype(np.int8)).to(card)
    scale = torch.from_numpy(rng.uniform(2e-6, 2e-5, cout).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32)).to(card)
    return x, wq, scale, bias


def _k8_every_route(args, want, groups, stride, padding):
    """Each route of int8_conv_pick that can run this conv ("gemm" route 1, "gemm1x1") equals `want`; returns the
    routes that ran."""
    from yololite_tpu_torch.ops.kernels import _int8_conv_launch, int8_conv_plan

    ran = []
    for pick in ("gemm", "gemm1x1"):
        if int8_conv_plan(args[0], args[1], want, groups, stride, padding, pick=pick)["route"] is None:
            continue
        got = _int8_conv_launch(*args, pick=pick)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        assert differ == 0, f"{pick}: {differ} of {want.numel()} outputs differ"
        ran.append(pick)
    return ran


@pytest.mark.parametrize("case", K8_CASES, ids=[c[0] for c in K8_CASES])
def test_int8_conv_kernel_matches_plain(card, case):
    """K8 against its plain version on the same inputs: every output equal (0 int8 LSB, 0 bf16 ulp); one launch
    down the expected route, no copy of a channels-last x; every other route that can run it equal too."""
    from yololite_tpu_torch.ops.kernels import int8_conv_plan

    _, b, cin, h, w, cout, k, stride, groups, act, sout, xdtype, route = case
    rng = np.random.default_rng(cin + h + cout)
    x, wq, scale, bias = _k8_inputs(rng, card, b, cin, h, w, cout, k, groups, xdtype)
    args = (x, wq, scale, bias, stride, k // 2, groups, act, sout, 1.0 / 64)
    before, copies = int8_conv.launches, int8_conv.copies
    got = int8_conv(*args)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1 and int8_conv.copies == copies
    assert int8_conv_plan(x, wq, got, groups, stride, k // 2)["route"] == route
    want = int8_conv_plain(x, *args[1:])
    assert got.shape == want.shape and got.dtype == want.dtype
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {want.numel()} outputs differ"
    if sout > 0:
        assert 0 < int((want != 0).sum()) and int((want.abs() == 127).sum()) < want.numel()
    assert route in _k8_every_route(args, want, groups, stride, k // 2) or route in ("direct", "depthwise")


# (name, batch, Cin, pitch (the whole tensor's channels), channel offset, H, W, Cout, k, stride, act, sout): the
# channel-split halves that C3k2 hands its Bottleneck's 3x3 cv1 (yolo11n) and its C3k's 1x1 cv1 and cv2 (yolo11m),
# and the other half, read in place by route 1 and gemm1x1
K8_SPLIT_CASES = [
    ("n-bottleneck-cv1-160", 32, 16, 32, 16, 160, 160, 8, 3, 1, 1, 0.05),
    ("n-bottleneck-cv1-80", 8, 32, 64, 32, 80, 80, 32, 3, 1, 1, 0.05),
    ("first-half-3x3", 2, 32, 64, 0, 20, 20, 32, 3, 1, 1, 0.05),
    ("3x3-s2-half", 2, 64, 128, 64, 40, 40, 64, 3, 2, 1, 0.0),
    ("3x3-cin8-of-16", 2, 8, 16, 0, 24, 24, 16, 3, 1, 1, 0.05),
    ("m-c3k-cv1-80", 8, 64, 128, 64, 80, 80, 32, 1, 1, 1, 0.05),
    ("m-c3k-cv2-40", 32, 128, 256, 128, 40, 40, 64, 1, 1, 1, 0.05),
    ("1x1-first-half-bf16-out", 4, 64, 128, 0, 20, 20, 64, 1, 1, 1, 0.0),
]


@pytest.mark.parametrize("xdtype", [I8, BF16, FP32], ids=["int8", "bf16", "fp32"])
@pytest.mark.parametrize("case", K8_SPLIT_CASES, ids=[c[0] for c in K8_SPLIT_CASES])
def test_int8_conv_reads_split_views_in_place(card, case, xdtype):
    """A channel-split view (a channel slice of a channels-last tensor, pixels `pitch` channels apart) reaches the
    kernel as it is: no copy, a GEMM route planned for it (route 1, or gemm1x1 for a 1x1), and every route that can run
    it equal to the plain version on the view's contiguous copy, bit for bit."""
    from yololite_tpu_torch.ops.kernels import int8_conv_plan, x_pitch

    _, b, cin, pitch, offset, h, w, cout, k, stride, act, sout = case
    rng = np.random.default_rng(cin + pitch + h + k)
    x, wq, scale, bias = _k8_inputs(rng, card, b, cin, h, w, cout, k, 1, xdtype, pitch, offset)
    assert x_pitch(x) == pitch and not x.is_contiguous(memory_format=torch.channels_last)
    args = (x, wq, scale, bias, stride, k // 2, 1, act, sout, 1.0 / 64)
    copies = int8_conv.copies
    got = int8_conv(*args)
    torch.cuda.synchronize()
    assert int8_conv.copies == copies
    want = int8_conv_plain(x.contiguous(memory_format=torch.channels_last), *args[1:])
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {want.numel()} outputs differ"
    route = int8_conv_plan(x, wq, got, 1, stride, k // 2)["route"]
    assert route in ("gemm", "gemm1x1")  # a GEMM route, not the scalar fallback
    assert route in _k8_every_route(args, want, 1, stride, k // 2)


# (name, batch, Cin, pitch, channel offset, H, W, Cout, int8 out, gemm1x1's blocks an SM or None, route): 1x1 convs
# with N tiles of 128 whose items span three rounds or more of two blocks an SM, which take gemm1x1's instance built
# for two blocks an SM (yolo11m's 160x160 and 80x80 shapes at batch 32, a split half read in place), and a Cin of 96
# (a 32-byte K step) whose gemm1x1 plan keeps one block, and so route 1
K8_TWO_BLOCK_CASES = [
    ("m-160x160-cout128", 32, 128, 128, 0, 160, 160, 128, True, 2, "gemm1x1"),
    ("m-80x80-cout256", 32, 256, 256, 0, 80, 80, 256, True, 2, "gemm1x1"),
    ("m-80x80-cin384-cout512", 32, 384, 384, 0, 80, 80, 512, True, 2, "gemm1x1"),
    ("split-half-80x80-cout128", 16, 128, 256, 128, 80, 80, 128, True, 2, "gemm1x1"),
    ("80x80-cout256-bf16-out", 32, 256, 256, 0, 80, 80, 256, False, None, "gemm1x1"),
    ("n-80x80-cin96-keeps-one-block", 32, 96, 96, 0, 80, 80, 128, True, 1, "gemm"),
]


@pytest.mark.parametrize("case", K8_TWO_BLOCK_CASES, ids=[c[0] for c in K8_TWO_BLOCK_CASES])
def test_int8_conv_1x1_two_blocks_an_sm(card, case):
    """gemm1x1 with N tiles of 128: its plan takes the instance built for two blocks an SM where two fit and the
    items span three rounds or more, and the conv equals its plain version bit for bit on the route planned and on
    gemm1x1."""
    from yololite_tpu_torch.ops.kernels import _int8_conv_launch, int8_conv_plan

    _, b, cin, pitch, offset, h, w, cout, q8, blocks, route = case
    rng = np.random.default_rng(cin + cout + h + offset)
    x, wq, scale, bias = _k8_inputs(rng, card, b, cin, h, w, cout, 1, 1, I8, pitch, offset)
    args = (x, wq, scale, bias, 1, 0, 1, 1, 0.05 if q8 else 0.0, 1.0 / 64)
    got = int8_conv(*args)
    torch.cuda.synchronize()
    assert int8_conv_plan(x, wq, got, 1, 1, 0)["route"] == route
    plan = int8_conv_plan(x, wq, got, 1, 1, 0, pick="gemm1x1")
    assert plan["n_tile"] == 128 and (blocks is None or plan["blocks_per_sm"] == blocks), plan
    want = int8_conv_plain(x.contiguous(memory_format=torch.channels_last), *args[1:])
    for out in (got, _int8_conv_launch(*args, pick="gemm1x1")):
        differ = int((out != want).sum())
        assert differ == 0, f"{differ} of {want.numel()} outputs differ"


def test_int8_conv_copies_only_what_it_cannot_read(card):
    """An NCHW x is copied to channels-last (counted), a channels-last one or a channel slice of one is not; the
    launch helper raises on a layout the kernel cannot read instead of copying it."""
    from yololite_tpu_torch.ops.kernels import _int8_conv_launch

    rng = np.random.default_rng(9)
    x, wq, scale, bias = _k8_inputs(rng, card, 2, 32, 12, 12, 32, 3, 1, I8)
    args = (wq, scale, bias, 1, 1, 1, 1, 0.05)
    copies = int8_conv.copies
    want = int8_conv(x, *args)
    assert int8_conv.copies == copies
    nchw = x.contiguous()
    assert torch.equal(int8_conv(nchw, *args), want) and int8_conv.copies == copies + 1
    with pytest.raises(ValueError):
        _int8_conv_launch(nchw, *args)


@pytest.mark.parametrize("act", [0, 1, 2], ids=["none", "silu", "relu"])
def test_requant_table_equals_the_arithmetic(card, act):
    """K8's activation + requant table, built by its kernel: every bf16 y's entry equals the plain version's
    activation and requant on the card; valid at real scales; at a tiny sout invalid, and a conv is then
    still equal to its plain version (through the arithmetic)."""
    import torch.nn.functional as F

    from yololite_tpu_torch.ops.kernels import _requant_table, quantize_act

    bits = torch.from_numpy(np.arange(65536, dtype=np.int64)).to(card)
    y = torch.from_numpy(np.arange(65536).astype(np.uint16).view(np.int16)).view(torch.bfloat16).to(card)
    y = F.silu(y) if act == 1 else F.relu(y) if act == 2 else y
    e = (bits >> 7) & 0xFF
    idx = ((bits >> 15) * 27 + (e - 110).clamp(0, 25) + ((e + 1) >> 8)) * 128 + (bits & 0x7F)
    own = ((e > 110) & (e < 135)) | (e == 255)
    for sout, valid in ((0.0371, True), (0.004, True), (1e-6, False)):
        table = _requant_table(card, act, sout)
        want = quantize_act(y, torch.tensor(sout, dtype=torch.float32, device=card))
        got = table[:6912].view(torch.int8)[idx]
        assert bool(table[6912:6916].view(torch.int32)[0] == 0) == valid
        assert torch.equal(got[own], want[own])
        if valid:
            assert torch.equal(got, want)
    rng = np.random.default_rng(act)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 32, 12, 12)).astype(np.int8)).to(card)
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 3, 3, 32)).astype(np.int8)).to(card)
    scale = torch.from_numpy(rng.uniform(2e-6, 2e-5, 64).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32)).to(card)
    for sout in (0.0371, 1e-6):
        args = (x, wq, scale, bias, 1, 1, 1, act, sout)
        assert torch.equal(int8_conv(*args), int8_conv_plain(x.contiguous(memory_format=torch.channels_last),
                                                             *args[1:]))


def test_int8_predict_launches_the_kernel(card, monkeypatch):
    """predict(int8=True) on the card runs every quantized conv through K8 (76 a yolo11n forward); the float
    inputs (the image, the bf16 islands' outputs) reach K8 unquantized: no quantize_act runs on the card."""
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.ops import kernels

    rng = np.random.default_rng(0)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    model = YOLOLite("yolo11n.yaml")
    kw = dict(conf=1e-7, imgsz=160, batch=2, int8=True, save=False, verbose=False)
    model.predict(src, **kw)  # set up, quantize, the frames' key runs eagerly
    model.predict(src, **kw)  # captured
    quantizes = []
    real = kernels.quantize_act
    monkeypatch.setattr(kernels, "quantize_act", lambda *a: quantizes.append(1) or real(*a))
    before = int8_conv.launches
    res = model.predict(src, **kw)  # a replay
    assert int8_conv.launches - before == 76
    with graphs.eager():  # the eager call runs the Python that would quantize
        model.predict(src, **kw)
    assert int8_conv.launches - before == 2 * 76
    assert not quantizes
    assert all(len(r) > 0 and np.isfinite(r.boxes.data).all() for r in res)


# ---------------- K4: blocked greedy NMS + compaction ----------------


def _same_bits(a, b) -> bool:
    """Equal bit for bit (NaN rows included, which torch.equal calls unequal)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def _k4_plain(*args):
    """K4's plain version with the plain keep inside (no K1 launch)."""
    from yololite_tpu_torch.ops import nms

    real = nms.greedy_nms_keep
    nms.greedy_nms_keep = greedy_nms_keep_plain
    try:
        return blocked_nms_finalize_plain(*args)
    finally:
        nms.greedy_nms_keep = real


K4_CASES = ["crowded", "spread", "first-block", "invalid", "nan", "disjoint", "near-threshold"]


@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("b,k", [(1, 8192), (16, 8192), (16, 1500), (4, 2048), (2, 6720), (40, 8192), (1, 1025),
                                 (40, 1025), (16, 8191)])
def test_blocked_nms_kernel_matches_plain(card, b, k, case):
    """K4 bit-equal to its plain version at max_det 1, 300 and K (and, where a step's last candidate is the row that
    reaches it, 256, 512 and 1024); one launch per call. B 40 holds more clusters than the card runs at once."""
    args = k4_scene(b * k + len(case), b, k, case)
    dets = (1, 300, k) + tuple(d for d in (256, 512, 1024) if case == "disjoint" and d < k)
    for max_det in dets:
        before = blocked_nms_finalize.launches
        got = blocked_nms_finalize(*args, 0.5, max_det)
        torch.cuda.synchronize()
        assert blocked_nms_finalize.launches == before + 1
        want = _k4_plain(*args, 0.5, max_det)
        assert _same_bits(got, want), f"max_det {max_det}: {int((got != want).any(-1).sum())} rows differ"
        if case == "invalid":
            assert not got.any()
        elif case == "disjoint":
            assert int((got[..., 4] > 0).sum()) == b * min(max_det, int((args[2][0] > 0).sum()))
        elif case == "near-threshold" and max_det == k:  # both sides of the threshold occur
            assert 0 < int((got[..., 4] > 0).sum()) < int((args[2] > 0).sum())


def _k4_launch(args, thr, max_det, cluster):
    """K4 at a chosen cluster size (csrc/blocked_nms.cu blocked_nms_finalize_ex), on the current stream."""
    from yololite_tpu_torch.ops import kernels

    shifted, boxes, vals, cls, valid = args
    b, k = valid.shape
    out = torch.empty((b, max_det, 6), dtype=torch.float32, device=shifted.device)
    ws = torch.empty((b, k, 4), dtype=torch.float32, device=shifted.device)
    lib = kernels._blocked_lib()
    rc = lib.blocked_nms_finalize_ex(*(t.data_ptr() for t in (*args, out, ws)), b, k, thr, max_det, cluster,
                                     shifted.device.index or 0, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, lib.blocked_nms_error_string(rc).decode()
    return out


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8, 11, 16])
def test_blocked_nms_kernel_any_cluster_size(card, cluster):
    """Every cluster size the C interface offers gives the plain version's bits; at cluster 1 the spread scene's
    7,000-odd kept boxes overflow a CTA's shared share into the workspace."""
    from yololite_tpu_torch.ops.kernels import blocked_nms_plan

    for case, thr in (("spread", 0.5), ("crowded", 0.7), ("near-threshold", 0.5)):
        args = k4_scene(cluster * 100 + len(case), 2, 8192, case)
        for max_det in (300, 8192):
            got = _k4_launch(args, thr, max_det, cluster)
            torch.cuda.synchronize()
            assert _same_bits(got, _k4_plain(*args, thr, max_det)), f"{case} max_det {max_det}"
    plan = blocked_nms_plan(2, 8192, cluster=cluster)
    assert plan["cluster"] == cluster and plan["step"] == 512 and plan["max_active_clusters"] >= 1
    assert plan["share_cap"] == min(-(-8192 // cluster), 5120)  # 100 KB of 20-byte boxes, the rest in the workspace


def test_blocked_nms_plan_fills_the_card_in_one_wave(card):
    """The default cluster size is the largest the card runs B of at once; it is > 1 at val's B 16."""
    from yololite_tpu_torch.ops.kernels import blocked_nms_plan

    for b in (1, 8, 16, 40):
        plan = blocked_nms_plan(b, 8192)
        assert plan["max_active_clusters"] >= b or plan["cluster"] == 1
        if plan["cluster"] < 16:
            assert blocked_nms_plan(b, 8192, cluster=plan["cluster"] + 1)["max_active_clusters"] < b
    assert blocked_nms_plan(16, 8192)["cluster"] > 1


def test_blocked_nms_kernel_replays_in_a_graph(card):
    """K4 captured in a CUDA graph replays to the eager call's bits (it allocates nothing and syncs nothing)."""
    args = k4_scene(11, 16, 8192, "crowded")
    want = blocked_nms_finalize(*args, 0.7, 300)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        blocked_nms_finalize(*args, 0.7, 300)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = blocked_nms_finalize(*args, 0.7, 300)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(got, want) and _same_bits(want, _k4_plain(*args, 0.7, 300))


def test_blocked_nms_kernel_rejects_what_it_does_not_take(card):
    shifted, boxes, vals, cls, valid = k4_scene(0, 2, 2048, "crowded")
    with pytest.raises(TypeError):
        blocked_nms_finalize(shifted.double(), boxes, vals, cls, valid, 0.5, 300)
    with pytest.raises(TypeError):
        blocked_nms_finalize(shifted, boxes, vals, cls, valid.float(), 0.5, 300)
    with pytest.raises(ValueError):
        blocked_nms_finalize(shifted[:, :100], boxes, vals, cls, valid, 0.5, 300)
    with pytest.raises(ValueError):
        blocked_nms_finalize(shifted, boxes, vals, cls, valid.cpu(), 0.5, 300)
    with pytest.raises(ValueError):
        blocked_nms_finalize(shifted.transpose(0, 1).contiguous().transpose(0, 1), boxes, vals, cls, valid, 0.5, 300)


def test_blocked_nms_op_equals_the_direct_launch(card):
    args = k4_scene(9, 4, 2048, "crowded")
    before = blocked_nms_finalize.launches
    via_op = torch.ops.yololite_tpu_torch.blocked_nms_finalize(*args, 0.45, 300)
    direct = blocked_nms_finalize(*args, 0.45, 300)
    torch.cuda.synchronize()
    assert blocked_nms_finalize.launches == before + 2 and torch.equal(via_op, direct)


# ---------------- graphed predict and val against eager ----------------


def _counts():
    return greedy_nms_keep.launches, blocked_nms_finalize.launches, int8_conv.launches


def _facade(name, tmp_path):
    """A facade and predict arguments for each serving mode at imgsz 160, batch 2."""
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.cfg.dicts import YOLOV10N
    from yololite_tpu_torch.models.model import DetectionModel

    extra = {"bf16": {"half": True}, "int8": {"int8": True}, "tta": {"augment": True}}.get(name, {})
    if name == "ensemble":
        path = tmp_path / "pair.pt"
        torch.save({"model": torch.nn.ModuleList([DetectionModel("yolo11n.yaml").init(0),
                                                  DetectionModel("yolo11n.yaml").init(1)]),
                    "train_args": {"imgsz": 160}}, str(path))
        model = YOLOLite(str(path))
    else:
        model = YOLOLite(YOLOV10N if name == "yolov10n" else "yolo11n.yaml")
    return model, dict(conf=1e-7, imgsz=160, batch=2, save=False, verbose=False, **extra)


PER_STEP = {"fp32": (1, 0, 0), "bf16": (1, 0, 0), "int8": (1, 0, 76), "tta": (1, 0, 0), "ensemble": (1, 0, 0),
            "yolov10n": (0, 0, 0)}  # K1, K4 and K8 launches of one predict step


@pytest.mark.parametrize("name", list(PER_STEP))
def test_graphed_predict_equals_eager(card, name, tmp_path):
    """Each serving mode's step replays a CUDA graph whose detections equal the eager call's bit for bit, on the
    uint8 letterbox path and on the float path; each replay adds its capture's launches to the counters."""
    model, kw = _facade(name, tmp_path)
    rng = np.random.default_rng(3)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    model.predict(src, **kw)  # set up (int8: quantize), warm up, the first sight of the frames' key runs eagerly
    pred = model.predictor
    raw = torch.from_numpy(np.stack(src)).to(card).flip(-1)
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)).to(card)
    for step, inp in ((lambda t: pred.infer_uint8(t, 160), raw), (pred.infer, x)):
        step(inp)
        step(inp)  # a key's first call runs eagerly (unless set-up made it), its second captures
        n = len(pred._graphs)
        before = _counts()
        got = step(inp)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_counts(), before)) == PER_STEP[name]
        assert len(pred._graphs) == n  # a replay, not a capture
        with graphs.eager():
            want = step(inp)
        assert _same_bits(got, want)
        assert int((got[..., 4] > 0).sum()) > 0


def test_graphed_val_equals_eager(card, tmp_path):
    """Standalone val runs a batch shape eagerly at its first sight, captures it at its second and replays it after;
    its detections and metrics equal the eager run's, with K4 once a batch and K1 never."""
    import cv2

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.engine.validator import DetectionValidator

    root = tmp_path / "ds"
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(120, 160), (160, 120), (120, 160), (160, 120), (160, 160)]):
        cv2.imwrite(str(root / "images" / "val" / f"im{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
        (root / "labels" / "val" / f"im{i}.txt").write_text("1 0.5 0.5 0.3 0.3\n7 0.3 0.6 0.2 0.1")
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnc: 80\n")
    model = YOLOLite("yolo11n.yaml")
    kw = dict(data=str(root / "data.yaml"), imgsz=160, batch=2, rect=True, conf=1e-7, plots=False, verbose=False,
              project=str(tmp_path / "runs"), mode="val")
    v = DetectionValidator(args={**kw, "name": "graphed"})
    runs = {}
    captures, warmups = {}, {}
    for name in ("first", "captured", "replayed", "eager"):  # first sights, captures, replays, all eager
        g = None if v._infer is None else v._infer.graphs
        before, caps, warm = _counts(), 0 if g is None else g.captures, 0 if g is None else g.warmups
        with graphs.eager() if name == "eager" else contextlib.nullcontext():
            v(model=model.model)
        captures[name] = v._infer.graphs.captures - caps
        warmups[name] = v._infer.graphs.warmups - warm
        runs[name] = ({k: [a.copy() for a in x] for k, x in v.stats.items()}, dict(v.metrics.results_dict),
                      tuple(a - b for a, b in zip(_counts(), before)))
    assert len(v._infer.graphs) >= 2 and captures["captured"] == len(v._infer.graphs)  # one per batch shape
    assert captures["first"] == captures["replayed"] == 0 and v._infer.graphs.replays == 2 * 3
    stats, rd, _ = runs["replayed"]
    for name in runs:  # 5 images at batch 2: K4 once in each batch (and in a capture's warm-up), and K1 never
        assert runs[name][2][:2] == (0, 3 + warmups[name])
    for name in ("first", "captured", "eager"):
        s2, rd2, _ = runs[name]
        assert rd2 == rd
        for key in stats:
            for a, b in zip(stats[key], s2[key]):
                np.testing.assert_array_equal(a, b)


def test_quantizing_after_warm_up_drops_the_float_graphs(card):
    """predict(int8=True) warms up on the float net, then quantizes on the first batch: no key of the float net is
    left, every graph captured after is keyed on the quantized net, and each replay launches K8."""
    from yololite_tpu_torch import YOLOLite

    model = YOLOLite("yolo11n.yaml")
    rng = np.random.default_rng(6)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    kw = dict(conf=1e-7, imgsz=160, batch=2, save=False, verbose=False, int8=True)
    model.predict(src, **kw)  # the warm-up's float key, dropped at quantization; the frames' key, a first sight
    pred = model.predictor
    assert pred._quantized and not len(pred._graphs) and all(k[1] == id(pred.net) for k in pred._graphs._seen)
    model.predict(src, **kw)  # captured on the quantized net
    assert len(pred._graphs) and all(k[1] == id(pred.net) for k in pred._graphs._graphs)
    before = int8_conv.launches
    model.predict(src, **kw)
    assert int8_conv.launches - before == 76


def test_graph_cache_stays_bounded_over_many_frame_sizes(card):
    """Frames at more sizes than the cache holds, each size twice in a row, one predict call each: every second
    frame replays, the cache keeps at most MAX_GRAPHS graphs, and the detections equal the eager run's bit for bit."""
    from yololite_tpu_torch import YOLOLite

    rng = np.random.default_rng(7)
    sizes = [(96 + 16 * i, 160) for i in range(graphs.MAX_GRAPHS + 3)]
    src = [rng.integers(0, 256, (*hw, 3), np.uint8) for hw in sizes for _ in range(2)]
    kw = dict(conf=1e-7, imgsz=160, batch=1, save=False, verbose=False)
    model = YOLOLite("yolo11n.yaml")
    got = [model.predict(f, **kw)[0] for f in src]
    cache = model.predictor._graphs
    assert cache.replays == cache.captures == len(sizes) and len(cache) == graphs.MAX_GRAPHS
    with graphs.eager():
        want = [model.predict(f, **kw)[0] for f in src]
    for a, b in zip(got, want):
        assert np.array_equal(a.boxes.data, b.boxes.data)


def test_two_caches_replay_from_two_threads(card):
    """Two predictors' graphs share the pool: replays from two threads, each on a stream of its own, each equal to
    its eager call bit for bit."""
    import threading

    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.models.model import DetectionModel

    rng = np.random.default_rng(8)
    models = [YOLOLite("yolo11n.yaml"), YOLOLite("yolo11n.yaml")]
    models[1].model.load_state_dict(DetectionModel("yolo11n.yaml").init(1).state_dict())
    kw = dict(conf=1e-7, imgsz=160, batch=2, save=False, verbose=False)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    raw = torch.from_numpy(np.stack(src)).to(card)
    preds, want = [], []
    for m in models:
        m.predict(src, **kw)
        p = m.predictor
        for _ in range(2):  # eagerly, then captured
            p.infer_uint8(raw, 160)
        with graphs.eager():
            want.append(p.infer_uint8(raw, 160))
        preds.append(p)
    assert not _same_bits(want[0], want[1])  # two nets: a mix-up would show
    outs = [[], []]

    def run(i):
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(20):
                outs[i].append(preds[i].infer_uint8(raw, 160))
            torch.cuda.current_stream().synchronize()

    torch.cuda.synchronize()  # the threads' streams do not wait for the default stream's work
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        assert len(outs[i]) == 20 and all(_same_bits(o, want[i]) for o in outs[i])


# ---------------- the train step's graphs and the trainer's EMA val ----------------


def _train_data(tmp_path):
    """8 train and 4 val PNGs at four shapes around 160 with their labels; data.yaml."""
    from chip_smoke import write_val_dataset

    root = tmp_path / "ds"
    shapes = [(120, 160), (160, 120), (160, 160), (100, 150)]
    write_val_dataset(root, shapes * 2, seed=30, split="train")
    return write_val_dataset(root, shapes, seed=31, split="val")


def _train_batches(n, seed=32):
    """n loader-like batches of 2 uint8 images at 160 with 2-5 boxes each (GT bucket 16)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 40, (2, 160, 160, 3)).astype(np.uint8)
        bi, cls, boxes = [], [], []
        for b in range(2):
            for _ in range(int(rng.integers(2, 6))):
                wh = rng.uniform(0.1, 0.4, 2)
                c = rng.uniform(wh / 2, 1 - wh / 2)
                x0, y0 = ((c - wh / 2) * 160).astype(int)
                x1, y1 = ((c + wh / 2) * 160).astype(int)
                img[b, y0:y1, x0:x1] = rng.integers(80, 255, 3)
                bi.append(b)
                cls.append(int(rng.integers(0, 80)))
                boxes.append([*c, *wh])
        out.append({"img": img, "batch_idx": np.array(bi, np.float32), "cls": np.array(cls, np.float32)[:, None],
                    "bboxes": np.array(boxes, np.float32)})
    return out


def _train_overrides(data, tmp_path, name, **kw):
    return {"data": str(data), "imgsz": 160, "batch": 2, "workers": 0, "val": False, "save": False, "plots": False,
            "project": str(tmp_path / "runs"), "name": name, "warmup_epochs": 0, **kw}


def _yolo11n_detecting():
    """yolo11n init(0) with the class biases at -6: its EMA val passes conf 0.001, so K4 has work."""
    from yololite_tpu_torch.models.model import DetectionModel

    m = DetectionModel("yolo11n.yaml", nc=80).init(0)
    with torch.no_grad():
        for seq in m.detect.cv3:
            seq[2].bias.fill_(-6.0)
    return m


TRAIN_CASES = {"grad_apply_fp32": dict(optimizer="AdamW", nbs=4, amp=False),
               "grad_apply_bf16": dict(optimizer="AdamW", nbs=4, amp=True),
               "fused_sgd": dict(optimizer="SGD", nbs=2, amp=False)}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_graphed_train_steps_equal_eager(card, case, tmp_path):
    """10 steps at imgsz 160, batch 2, all in the warmup's ramp (lr, momentum and accumulate moving every step), in
    deterministic mode: the grad graph and the one apply graph (accumulate 1 -> 2: applies at steps 1-5, 7, 9),
    or the fused graph (accumulate 1, SGD), give the eager steps' loss items, fg_mask, weights, BN statistics,
    optimizer moments and EMA bit for bit; each key's first call runs eagerly, its second captures, every later one
    replays, warmup included; the optimizer's device step counts the applies in both runs."""
    from chip_smoke import graphed_vs_eager_steps

    data = _train_data(tmp_path)
    rep = graphed_vs_eager_steps(_train_overrides(data, tmp_path, case, **TRAIN_CASES[case]), _yolo11n_detecting,
                                 _train_batches(10), nw=10)
    fused = case == "fused_sgd"
    assert rep["fused"] == fused and rep["warmups"] == 0
    assert rep["captured"] == ({"fused": 1} if fused else {"grad": 1, "apply": 1})
    assert rep["applies"] == (10 if fused else 7) and rep["step"] == rep["eager_step"] == rep["applies"]
    n, replayed, from_third = replays_from_third_sight(rep["graph_calls"], "fused" if fused else "apply")
    assert n == rep["applies"] and replayed == n - 2 and from_third
    assert rep["replays"] == (9 if fused else 9 + 6)  # a capture replays too
    for group, v in rep["groups"].items():
        assert v["equal"], (group, v, rep["nondeterministic"])


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_graphed_ema_val_equals_eager(card, half, tmp_path):
    """A trainer's val keeps its graphs across calls: by the third call every batch replays (K4 once a batch), and
    the metrics equal an eager val of the same EMA."""
    from yololite_tpu_torch.engine.trainer import DetectionTrainer

    data = _train_data(tmp_path)
    t = DetectionTrainer(overrides=_train_overrides(data, tmp_path, "emaval", val=True, half=half))
    t.set_model(_yolo11n_detecting())
    t._setup_train()
    g = t.validator.ema_graphs
    runs = []
    for _ in range(3):
        before, replays = _counts(), g.replays
        stats = t.validate()
        runs.append((stats, tuple(a - b for a, b in zip(_counts(), before)), g.replays - replays))
    n = len(t.validator.dataloader)
    with graphs.eager():
        eager = t.validator(trainer=t)
    assert g.warmups == 0 and len(g) >= 1 and runs[2][2] == n  # the third val replays every batch
    for stats, launches, _ in runs:
        assert launches[:2] == (0, n) and stats == eager
    assert sum(len(c) for c in t.validator.stats["conf"]) > 0  # detections: K4 had work


def test_train_state_stays_outside_the_graph_pool(card, tmp_path):
    """After the grad and apply graphs are captured, no tensor that lives across steps (weights, BN statistics,
    gradients, optimizer state, lr and momentum, K10's table, EMA and its decay) lies in the graph pool; a graph's
    static outputs do."""
    from yololite_tpu_torch.engine.trainer import DetectionTrainer

    data = _train_data(tmp_path)
    tr = DetectionTrainer(overrides=_train_overrides(data, tmp_path, "pool", optimizer="AdamW", nbs=4))
    tr.set_model(_yolo11n_detecting())
    tr._setup_train()
    last = -1
    for ni, (staged, _) in enumerate(tr.feed(_train_batches(6))):
        tr.accumulate, lr_vec, momentum = tr._schedule(ni, -1, 0)
        apply = ni - last >= tr.accumulate
        tr._train_batch(staged, apply, lr_vec, momentum)
        last = ni if apply else last
    torch.cuda.synchronize()
    assert {k[0] for k in tr.graphs._graphs} == {"grad", "apply"}
    state = tr.optimizer.state_tensors()  # mu, nu, step, mu_product, lr and momentum, K10's table
    lives = [*tr.model.state_dict().values(), *tr._grads, *state, *tr.ema.ema.state_dict().values(), tr.ema.d,
             tr.ema.one_minus_d]
    assert len(state) == 2 * len(tr._grads) + 5 and graphs.in_pool(lives) == []
    grad = next(v for k, v in tr.graphs._graphs.items() if k[0] == "grad")
    assert len(graphs.in_pool(list(grad.static_out))) == 2  # the loss items and fg_mask: made in the capture


# ---------------- K10: the apply ----------------


@pytest.mark.parametrize("rule", K10_RULES)
def test_optim_apply_kernel_matches_plain(card, rule):
    """K10 for one rule against its plain version: yolo11n's 255 trainable tensors with its BN statistics and batch
    counters over 2 applies with lr and momentum moving, then tensors of 1, 7, 13 and 4,097 elements (two an element
    off 16 bytes) and EMA-only rows of 5 (off 16) and 8,200, in fp32 and fp64: every tensor written bit for bit
    given the kernel's clip factor, the norm within 1e-6 relative; AdamW also a second run the same bits
    (chip_smoke.k10_rule_check)."""
    r = k10_rule_check(rule, second_run=rule == "AdamW")
    assert r["checks"] == 5 and r["train"] == 255 and r["norm_rel_err"] <= 1e-6


def test_optim_apply_replays_in_a_graph_with_the_step_advancing(card):
    """One AdamW apply captured as a graph and replayed 10 times from the same start as 10 eager applies: the
    optimizer's device step, the bias corrections read from it, and every tensor equal bit for bit (a step frozen
    into the capture would replay step 4 ten times)."""
    from chip_smoke import k10_grads, k10_setup, k10_state

    runs = []
    for graphed in (False, True):
        m, opt, ema = k10_setup("AdamW", 5)
        graph = None
        for i in range(10):
            k10_grads(opt, 50 + i)
            opt.set_lr_momentum([0.001 * (i + 1)] * 3, 0.8 + 0.01 * i)
            ema.advance()
            if not graphed:
                opt.apply(ema.d, ema.one_minus_d)
                continue
            if graph is None:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    opt.apply(ema.d, ema.one_minus_d)
            graph.replay()
        torch.cuda.synchronize()
        runs.append((int(opt.step), k10_state(m, opt, ema)))
    assert runs[0][0] == runs[1][0] == 13  # set up at step 3
    assert all(same_bits(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ---------------- K3: candidate select + DFL decode ----------------

@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_select_decode_kernel_matches_plain(card, case):
    """K3 against its plain version on the card: vals, bidx, cls and valid bit for bit in all K rows (the -1
    fillers included), boxes and the class-offset boxes within 1e-6 relative (NaN where the plain version has
    NaN); one counted launch per call, counted under the route taken, down the route `K3_ROUTES` names (the
    finish and cluster routes: two kernels; the passes: ten or more)."""
    from yololite_tpu_torch.ops.kernels import select_decode_plan

    args = k3_args(case)
    plan = select_decode_plan(args[0], args[2], args[3], args[5], args[8])
    assert plan["route"] == K3_ROUTES[case[0]]
    assert plan["launches"] == 2 if plan["route"] in ("finish", "cluster") else plan["launches"] >= 10
    assert (plan["cluster"] >= 1) == (plan["route"] == "cluster")
    before, by_route = select_decode.launches, select_decode.by_route.as_dict()
    got = select_decode(*args)
    torch.cuda.synchronize()
    assert select_decode.launches == before + 1
    by_route[plan["route"]] += 1
    assert select_decode.by_route.as_dict() == by_route
    k3_check(got, select_decode_plain(*args), case[0])  # raises on a difference
    if case[0].startswith("all-gated"):
        assert bool((got[0] == -1).all()) and not bool(got[5].any())


def test_select_decode_sigmoid_bits_equal_torchs(card):
    """The kernel's scores equal torch.sigmoid's bits: every finite bf16 logit (in fp32 and rounded to bf16) and
    an fp32 sweep over [-30, 30]; each entry is read back through its index (K = N, nothing gated out)."""
    allbf = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    allbf = allbf[torch.isfinite(allbf)]
    sweep = torch.linspace(-30, 30, 64 * 4001)
    for logits, halves in ((allbf, (False, True)), (sweep, (False,))):
        t = logits[: logits.numel() // 64 * 64].reshape(1, 64, 1, -1).to(card)
        feat = torch.cat([torch.zeros_like(t), t], 1).permute(0, 2, 3, 1)  # 64 box channels, 64 classes
        for half in halves:
            vals, bidx, cls = select_decode([feat], [8], 64, 16, -2.0, 1 << 30, None, half, True, False)[:3]
            s = torch.sigmoid(t if half else t.float()).float().permute(0, 2, 3, 1).reshape(-1)
            assert vals.shape[1] == s.numel()
            assert _same_bits(vals[0], s[bidx[0] * 64 + cls[0].long()])


def test_select_decode_score_function_is_monotone(card):
    """The single-label score pass keeps an anchor's largest logits and scores those alone (csrc/select_decode.cu
    ClassMax), exact only while its score function is monotone non-decreasing: the check kernel walks every
    non-NaN fp32 on this card (rounding to bf16 or fp16 keeps the order)."""
    from yololite_tpu_torch.ops.kernels import sigmoid_monotone

    assert sigmoid_monotone(card)


@pytest.mark.parametrize("case", [c for c in K3_CASES if K3_ROUTES[c[0]] == "cluster"],
                         ids=[c[0] for c in K3_CASES if K3_ROUTES[c[0]] == "cluster"])
def test_select_decode_passes_route_matches_plain_on_cluster_scenes(card, case):
    """The passes route, run through select_decode_pick on a scene that the shapes send to the cluster route,
    still equals the plain version (vals, bidx, cls, valid bit for bit); a route that cannot take the shapes
    (finish on a long row) raises."""
    from yololite_tpu_torch.ops.kernels import _select_decode_launch

    args = k3_args(case)
    got, route = _select_decode_launch(*args, route="passes")
    torch.cuda.synchronize()
    assert route == "passes"
    k3_check(got, select_decode_plain(*args), f"{case[0]} (passes route)")
    with pytest.raises(RuntimeError):
        _select_decode_launch(*args, route="finish")


@pytest.mark.parametrize("name", ["val-b72", "val-b136"])
def test_select_decode_cluster_route_in_clusters_of_one(card, name):
    """Past the batch the card holds in clusters of two CTAs at once the shapes pick the passes route; the cluster
    route, run through select_decode_pick, then takes clusters of one CTA (in waves at B 136, past the 132 an H100
    holds), a tie list and slack under those of val's B 16, and still equals the plain version."""
    from yololite_tpu_torch.ops.kernels import _select_decode_launch, select_decode_plan

    args = k3_args(next(c for c in K3_CASES if c[0] == name))
    b = args[0][0].shape[0]
    assert select_decode_plan(args[0], 80, 16, 8192, True)["route"] == K3_ROUTES[name] == "passes"
    plan = select_decode_plan(args[0], 80, 16, 8192, True, route="cluster")
    wide = select_decode_plan(k3_args(K3_CASES[3])[0], 80, 16, 8192, True)  # val's B 16
    assert plan["route"] == "cluster" and plan["cluster"] == 1 and wide["cluster"] > 1
    assert 0 < plan["slack"] < wide["slack"] and 0 < plan["tie_cap"] < wide["tie_cap"], (plan, wide)
    assert (plan["max_active_clusters"] < b) == (name == "val-b136")
    got, route = _select_decode_launch(*args, route="cluster")
    torch.cuda.synchronize()
    assert route == "cluster"
    k3_check(got, select_decode_plain(*args), f"{name} (cluster route)")


def test_select_decode_kernel_replays_in_a_graph(card):
    """Captured in a CUDA graph, K3 replays on new maps copied into the captured inputs and gives the eager
    results (no host sync inside: the capture would fail); val's scene, which takes the cluster route."""
    from yololite_tpu_torch.ops.kernels import select_decode_plan

    args = k3_args(K3_CASES[3])
    assert select_decode_plan(args[0], args[2], args[3], args[5], args[8])["route"] == "cluster"
    feats = [f.clone() for f in args[0]]
    static = [f.clone() for f in feats]
    select_decode(static, *args[1:])  # warm up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = select_decode(static, *args[1:])
    for seed in (1, 2):
        new = k3_maps(np.random.default_rng(seed), 16, K3_RECT, 80, torch.float32, "nhwc", "random")
        for s, n in zip(static, new):
            s.copy_(n)
        g.replay()
        torch.cuda.synchronize()
        want = select_decode(new, *args[1:])
        for o, w in zip(out, want):
            assert _same_bits(o, w)


def test_select_decode_cluster_route_replays_in_a_graph_on_the_sparse_scene(card):
    """The cluster route's shortcut (fewer than K entries pass: b0's bin holds one key) captured in a CUDA graph
    replays on new sparse maps as the eager calls do, and a replay advances the by-route counts as its capture
    did."""
    case = next(c for c in K3_CASES if c[0] == "val-sparse")
    args = k3_args(case)
    static = [f.clone() for f in args[0]]
    select_decode(static, *args[1:])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = select_decode(static, *args[1:])
    for seed in (3, 4):
        new = k3_maps(np.random.default_rng(seed), case[1], case[2], 80, torch.float32, "nhwc", "sparse")
        for s, n in zip(static, new):
            s.copy_(n)
        g.replay()
        torch.cuda.synchronize()
        want = select_decode(new, *args[1:])
        for o, w in zip(out, want):
            assert _same_bits(o, w)
    cache = graphs.GraphCache()
    step = lambda *f: select_decode(list(f), *args[1:])  # noqa: E731
    before = select_decode.by_route.cluster
    for _ in range(3):  # seen (eager), captured and replayed, replayed
        cache.step(step, tuple(static), ("k3-sparse",), torch.device(card))
    assert select_decode.by_route.cluster - before == 3 and cache.replays == 2


def test_select_decode_kernel_rejects_what_it_does_not_take(card):
    feats = k3_args(K3_CASES[0])[0]
    with pytest.raises(TypeError):
        select_decode([f.double() for f in feats], [8, 16, 32], 80, 16, 0.1, 512)
    with pytest.raises(TypeError):
        select_decode([feats[0].half(), feats[1], feats[2]], [8, 16, 32], 80, 16, 0.1, 512)
    with pytest.raises(ValueError):
        select_decode(feats, [8, 16, 32], 79, 16, 0.1, 512)
    with pytest.raises(ValueError):
        select_decode([feats[0].cpu(), feats[1], feats[2]], [8, 16, 32], 80, 16, 0.1, 512)
    with pytest.raises(ValueError):
        select_decode(feats, [8, 16, 32], 80, 16, 0.1, 512, torch.ones(79, dtype=torch.bool, device=card))


# ---------------- K2: the letterbox ----------------

K2_SHAPES = [((480, 640), 640), ((640, 640), 640), ((720, 1280), 640), ((100, 120), 320), ((333, 517), 320),
             ((517, 333), 416)]


@pytest.mark.parametrize("shape,s", K2_SHAPES, ids=[f"{h}x{w}-{s}" for (h, w), s in K2_SHAPES])
def test_letterbox_kernel_matches_plain(card, shape, s):
    """K2 against its plain version (TF32 off): the pad bit for bit, a frame that needs no resize bit for bit
    everywhere, a resize within 1e-5 (fp32; bf16 within half an ulp of the plain fp32 value more), in both
    layouts, with and without bgr; one launch per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(shape[0] + s)
    im = torch.from_numpy(rng.integers(0, 256, (3, *shape, 3), dtype=np.uint8)).to(card)
    h0, w0 = shape
    from yololite_tpu_torch.ops.kernels import letterbox_geometry

    new_h, new_w, top, left = letterbox_geometry(h0, w0, s)
    pad = torch.ones((s, s), dtype=torch.bool, device=card)
    pad[top:top + new_h, left:left + new_w] = False
    for dtype in (torch.float32, torch.bfloat16):
        for bgr in (False, True):
            want32 = device_letterbox_plain(im, s, torch.float32, bgr)
            want = want32.to(dtype)
            for cl in (True, False):
                before = device_letterbox.launches
                got = device_letterbox(im, s, dtype, bgr=bgr, channels_last=cl)
                torch.cuda.synchronize()
                assert device_letterbox.launches == before + 1 and got.shape == want.shape and got.dtype == dtype
                assert got.is_contiguous() if cl else got.permute(0, 3, 1, 2).is_contiguous()
                assert _same_bits(got[:, pad], want[:, pad])
                if (new_h, new_w) == (h0, w0):
                    assert _same_bits(got.contiguous(), want)
                else:
                    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -9 + 1e-5
                    assert float((got.float() - want32).abs().max()) <= tol
    if (new_h, new_w) != (h0, w0):
        assert not torch.equal(device_letterbox(im, s), device_letterbox(im, s, bgr=True))


# ---------------- K3 and K2 on the main paths ----------------


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_graphed_predict_and_val_run_k3_and_k2(card, half, tmp_path):
    """A replayed predict step launches K2 once (the uint8 path) and K3 once, and equals its eager call bit for bit;
    a replayed standalone val launches K3 once a batch, the metrics those of the eager run."""
    from yololite_tpu_torch import YOLOLite

    model = YOLOLite("yolo11n.yaml")
    rng = np.random.default_rng(6)
    src = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    kw = dict(conf=1e-7, imgsz=160, batch=2, half=half, save=False, verbose=False)
    model.predict(src, **kw)
    pred = model.predictor
    raw = torch.from_numpy(np.stack(src)).to(card)  # BGR, as the stream uploads it
    for _ in range(2):
        pred.infer_uint8(raw, 160, bgr=True)
    k2, k3 = device_letterbox.launches, select_decode.launches
    got = pred.infer_uint8(raw, 160, bgr=True)
    torch.cuda.synchronize()
    assert (device_letterbox.launches - k2, select_decode.launches - k3) == (1, 1)
    with graphs.eager():
        assert _same_bits(got, pred.infer_uint8(raw, 160, bgr=True))
        assert _same_bits(got, pred.infer_uint8(raw.flip(-1).contiguous(), 160))
    assert int((got[..., 4] > 0).sum()) > 0

    import cv2

    from yololite_tpu_torch.engine.validator import DetectionValidator

    root = tmp_path / "ds"
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(root / "images" / "val" / f"im{i}.png"), rng.integers(0, 256, (120, 160, 3), np.uint8))
        (root / "labels" / "val" / f"im{i}.txt").write_text("1 0.5 0.5 0.3 0.3")
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnc: 80\n")
    v = DetectionValidator(args=dict(data=str(root / "data.yaml"), imgsz=160, batch=2, conf=1e-7, plots=False,
                                     verbose=False, half=half, project=str(tmp_path / "runs"), mode="val"))
    for _ in range(2):
        v(model=model.model)
    k3 = select_decode.launches
    v(model=model.model)
    rd = dict(v.metrics.results_dict)
    assert select_decode.launches - k3 == 2 and v._infer.graphs.replays >= 2
    with graphs.eager():
        v(model=model.model)
    assert v.metrics.results_dict == rd


# ---------------- the loss tail: K5, K6a, K6b (each with its backward) and K7 ----------------


def _wrapper(name):
    return {w.__name__: w for w in L.COUNTED}[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,a", LOSS_TAIL_SHAPES)
def test_loss_tail_kernels_match_plain(card, b, a, dtype):
    """K5, K6a, K6b forward and backward on the (B, A, 144) maps' strided slices against their plain versions: bit
    for bit (K6b's sum within chip_smoke.BCE_SUM_RTOL), the same bits on a second call and in a CUDA graph replay;
    one launch a call (the check calls each three times: twice, and once in the capture)."""
    for name, (kernel, plain) in loss_tail_pairs(*loss_tail_inputs(b, a, dtype, seed=b * a + 1)).items():
        before = _wrapper(name).launches
        loss_tail_check(name, kernel, plain, f"B {b}, A {a}, {dtype}")
        assert _wrapper(name).launches == before + 3


OFF_ALIGNED = [("scalar", torch.float32), ("scalar", torch.bfloat16), ("scalar", torch.float64),
               ("special", torch.float32), ("special", torch.bfloat16)]  # the float64 step's logits are finite


@pytest.mark.parametrize("case,dtype", OFF_ALIGNED, ids=[f"{c}-{str(d).split('.')[-1]}" for c, d in OFF_ALIGNED])
@pytest.mark.parametrize("b,a", [(16, 2100), *LOSS_TAIL_EDGE_SHAPES])
def test_loss_tail_kernels_match_plain_off_the_aligned_maps(card, b, a, case, dtype):
    """K5-K6b on the scalar route's layouts (maps of row stride 146, the box slice one column in; labels of row
    stride 81) and with NaN, +-inf and -0.0 logits, at row counts that are no multiple of K6a's 32 rows a block nor
    of K6b's 1,024-piece chunk: bit for bit as on the maps (chip_smoke.loss_tail_case_checks: K6a and K6b down the
    routes LOSS_TAIL_ROUTES names; K6b's sum the kernel order's bits, and on the scalar route the aligned
    layout's)."""
    loss_tail_case_checks(b, a, dtype, case, seed=b * a + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,a", LOSS_TAIL_EDGE_SHAPES)
def test_loss_tail_kernels_match_plain_at_ragged_row_counts(card, b, a, dtype):
    """The maps' slices at row counts off K6a's and K6b's tiles: every kernel bit for bit (K6b's sum within
    BCE_SUM_RTOL and the kernel order's bits), the routes the aligned layout takes."""
    loss_tail_case_checks(b, a, dtype, "aligned", seed=b * a + 3)


def test_loss_tail_routes_follow_the_layout(card):
    """K5's and K6a's plan and K6b's: the maps' slices take the 16-byte routes in fp32, bf16 and fp64, the shifted
    layouts the scalar ones, another reg_max K5's and K6a's generic kernels (bit for bit too); K6b's partition is
    fixed by the element count and the logits' type, so two layouts of the same values give the same sum."""
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        inputs = list(loss_tail_inputs(2, 300, dtype, seed=9))
        inputs[2] = inputs[2].float() if dtype == torch.float64 else inputs[2]
        sums = []
        for case in ("aligned", "scalar"):
            box, cls, _, lab, _, _ = loss_tail_case(case, *inputs)
            assert (L.dfl_plan(box)["route"], L.bce_sum_plan(cls, lab)["route"]) == LOSS_TAIL_ROUTES[case]
            assert L.bce_sum_plan(cls, lab)["piece"] == 16 // dtype.itemsize
            sums.append(L.bce_sum(cls, lab))
        assert same_bits(*sums)
    maps, tgt, _, g4, g1 = loss_tail_inputs(2, 50, torch.float32, seed=10)
    for r in (8, 4):  # another reg_max: the generic kernels
        x = maps[..., :4 * r]
        assert L.dfl_plan(x)["route"] == "generic"
        loss_tail_check("dfl_expectation", lambda: L.dfl_expectation(x, r), lambda: L.dfl_expectation_plain(x, r),
                        f"reg_max {r}")
        loss_tail_check("dfl_expectation_backward", lambda: L.dfl_expectation_backward(x, g4, r),
                        lambda: L.dfl_expectation_backward_plain(x, g4, r), f"reg_max {r}")
        loss_tail_check("dfl_ce_mean", lambda: L.dfl_ce_mean(x, tgt), lambda: L.dfl_ce_plain(x, tgt), f"reg_max {r}")
        loss_tail_check("dfl_ce_backward", lambda: L.dfl_ce_backward(x, tgt, g1),
                        lambda: L.dfl_ce_backward_plain(x, tgt, g1), f"reg_max {r}")


def test_bce_sum_adds_in_the_kernel_order(card):
    """K6b's sum equals, bit for bit, its terms added in the kernel's order by plain torch
    (chip_smoke.bce_sum_kernel_order) at the train step's shapes, fp32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        maps, _, lab, _, _ = loss_tail_inputs(16, 8400, dtype, seed=11)
        assert same_bits(L.bce_sum(maps[..., 64:], lab), bce_sum_kernel_order(maps[..., 64:], lab))


def test_loss_tail_kernels_refuse_a_route_the_layout_does_not_allow(card):
    """The C entries hold the wrapper to its plan: K5's and K6a's 16-byte route on logits one column in, and K7's on
    metrics one column in or of a length no multiple of 4, return cudaErrorMisalignedAddress and launch nothing."""
    maps = torch.zeros(2, 50, 146, device=card)
    x = maps[..., 1:65]
    assert L.dfl_plan(x)["route"] == "lanes-scalar"
    dfl, stream = L._dfl_lib(), torch.cuda.current_stream().cuda_stream
    out = torch.empty(2, 50, 4, device=card)
    dx = torch.empty(2, 50, 64, device=card)
    g4 = torch.zeros(2, 50, 4, device=card)
    tgt, g1 = torch.zeros(2, 50, 4, device=card), torch.zeros(2, 50, 1, device=card)
    rcs = [dfl.dfl_expectation_forward(x.data_ptr(), 146, 100, 16, 0, 1, out.data_ptr(), card.index or 0, stream),
           dfl.dfl_expectation_backward(x.data_ptr(), 146, 100, 16, 0, 1, g4.data_ptr(), dx.data_ptr(),
                                        card.index or 0, stream),
           dfl.dfl_ce_forward(x.data_ptr(), 146, 100, 16, 0, 1, tgt.data_ptr(), out.data_ptr(), card.index or 0,
                              stream),
           dfl.dfl_ce_backward(x.data_ptr(), 146, 100, 16, 0, 1, tgt.data_ptr(), g1.data_ptr(), dx.data_ptr(),
                               card.index or 0, stream)]
    topk = L._topk_lib()
    vals, idx = torch.empty(12, 10, device=card), torch.empty(12, 10, dtype=torch.int64, device=card)
    for m, n in ((torch.zeros(2, 6, 8404, device=card)[..., 1:8401], 8400), (torch.zeros(2, 6, 8399, device=card),
                                                                             8399)):
        rcs.append(topk.topk_rows(m.data_ptr(), m.stride(1), 12, n, 0, 10, 1, 36, vals.data_ptr(), idx.data_ptr(),
                                  card.index or 0, stream))
    torch.cuda.synchronize()
    assert [dfl.dfl_error_string(rc).decode() for rc in rcs[:4]] == ["misaligned address"] * 4, rcs
    assert [topk.topk_rows_error_string(rc).decode() for rc in rcs[4:]] == ["misaligned address"] * 2, rcs


@pytest.mark.parametrize("b,m,a,k,kind", TOPK_CASES)
def test_topk_rows_kernel_matches_plain(card, b, m, a, k, kind):
    """K7 on the metrics of chip_smoke.TOPK_CASES (the assigner's, all-zero rows, more than k entries equal to the
    k-th, NaN, +-inf and -0.0 / 0.0 ties, GT bumps; M 8-256, k 1-32, A 5 to 33,600): values and indices bit for
    bit, the same on a second call and in a graph replay, one launch a call, down the route and tile its layout
    allows."""
    topk_case_check(b, m, a, k, kind, seed=b * m + a + k)


@pytest.mark.parametrize("a,dtype,kind", [(86016, torch.float64, "assigner"), (86016, torch.float64, "boxes"),
                                          (200000, torch.float32, "boxes")], ids=["fp64-2048", "fp64-bumps", "fp32"])
def test_topk_rows_streams_a_row_of_any_length(card, a, dtype, kind):
    """K7 on rows longer than its register tiles at k 32: the float64 reference step's at imgsz 2,048 (A 86,016) and
    a 200,000-value fp32 row, the bumps' rows taking the radix raise of t0; the streamed route's shared memory does
    not grow with the row, so these launch and equal the plain version bit for bit."""
    assert topk_case_check(2, 4, a, 32, kind, seed=a, dtype=dtype) == ("vector", 0)


def test_loss_tail_kernels_take_the_float64_step(card):
    """fp64 maps, as the float64 reference step feeds them, through every kernel, and K7 on fp32 and fp64 metrics
    with NaN and signed zeros: equal to the plain versions as in fp32."""
    maps, tgt, lab, g4, g1 = loss_tail_inputs(2, 300, torch.float64, seed=5)
    for name, (kernel, plain) in loss_tail_pairs(maps, tgt, lab.float(), g4, g1).items():
        loss_tail_check(name, kernel, plain, "fp64")
    for mdt in (torch.float32, torch.float64):
        x = loss_tail_metrics(3, 8, 1000, seed=6).to(mdt)
        x[0, 0, ::97] = float("nan")
        x[1, 1, ::3] = -0.0
        loss_tail_check("topk_rows", lambda: L.topk_rows(x, 13), lambda: L.topk_stable(x, 13), str(mdt))
    for case in (TOPK_CASES[8], TOPK_CASES[10], TOPK_CASES[12], TOPK_CASES[14]):  # fp64's keys on each route and tile
        topk_case_check(*case, seed=7, dtype=torch.float64)


def test_loss_tail_kernels_reject_what_they_do_not_take(card):
    maps = torch.zeros(2, 50, 144, device=card)
    with pytest.raises(ValueError):  # the logits' last dim strided
        L.dfl_expectation(maps[..., :128:2], 16)
    with pytest.raises(ValueError):  # rows not evenly spaced
        L.bce_sum(maps[:, :25, 64:], torch.zeros(2, 25, 80, device=card))
    with pytest.raises(TypeError):
        L.dfl_ce_mean(maps[..., :64], torch.zeros(2, 50, 4, device=card, dtype=torch.float64))
    with pytest.raises(ValueError):
        L.topk_rows(maps, 33)
    with pytest.raises(TypeError):
        L.topk_rows(maps.bfloat16(), 10)
    with pytest.raises(TypeError):  # no path of the port makes fp16 maps
        L.dfl_expectation(maps[..., :64].half(), 16)
    with pytest.raises(TypeError):
        L.bce_sum(maps[..., 64:], torch.zeros(2, 50, 80, device=card, dtype=torch.float64))
    with pytest.raises(ValueError):
        L.bce_sum(maps[..., 64:], torch.zeros(2, 50, 80))  # labels on another device


def test_train_step_with_the_loss_tail_kernels_equals_the_plain_one(card, tmp_path):
    """One yolo11n train step at imgsz 160, batch 2, fp32 and bf16, eager in deterministic mode: the loss-tail
    kernels against their plain versions (chip_smoke.loss_tail_step_check: fg_mask equal, loss items within rtol
    1e-5, every gradient bit for bit; the compact box/DFL form at A 525, K 160: K9 launched once, K5's forward
    twice)."""
    from yololite_tpu_torch.engine.trainer import DetectionTrainer

    data = _train_data(tmp_path)

    def trainer(amp):
        tr = DetectionTrainer(overrides=_train_overrides(data, tmp_path, f"tail_{amp}", amp=amp))
        tr.set_model(_yolo11n_detecting())
        tr._setup_train()
        return tr

    loss_tail_step_check(torch.cuda.get_device_name(0), trainer)


# ---------------- K9: the compact box/DFL form's foreground gather ----------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,imgsz,m,kind", COMPACT_CASES)
def test_compact_rows_kernel_matches_plain(card, b, imgsz, m, kind, dtype):
    """K9 on the maps' box slice (row stride 144) over chip_smoke.COMPACT_CASES' masks (the assigner's at imgsz 320,
    640 and 1,280 with M 16-256; none, exactly K and more than K foreground rows): rows, idx and pos, and the
    backward's dx, bit for bit against the plain versions, the same on a second call and in a graph replay, one
    launch a call, down the 16-byte route."""
    seed = b + imgsz + m + len(kind) + 1
    fg, k = compact_mask(b, imgsz, m, kind, seed)
    x = compact_layout("map", b, fg.shape[1], dtype, seed)
    compact_case_check(x, fg, k, compact_gradient(b, k, dtype, seed + 1, misaligned=False), "vector",
                       f"{kind} mask at {imgsz}, M {m}, {dtype}")


LAYOUTS = [(layout, dtype) for layout in ("contiguous", "scalar") for dtype in (torch.float32, torch.bfloat16)]
LAYOUTS += [("map", torch.float64), ("scalar", torch.float64)]


@pytest.mark.parametrize("layout,dtype", LAYOUTS, ids=[f"{lay}-{str(d).split('.')[-1]}" for lay, d in LAYOUTS])
def test_compact_rows_kernel_takes_every_layout(card, layout, dtype):
    """K9 on a contiguous tensor, down the scalar route (the box slice one column into maps of row stride 146, the
    gradient one element off 16 bytes) and in fp64 (the float64 reference step): bit for bit as on the maps."""
    fg, k = compact_mask(4, 640, 32, "assigner", seed=5)
    x = compact_layout(layout, 4, fg.shape[1], dtype, seed=6)
    g = compact_gradient(4, k, dtype, seed=7, misaligned=layout == "scalar")
    compact_case_check(x, fg, k, g, COMPACT_ROUTES[layout], f"{layout}, {dtype}")


@pytest.mark.parametrize("b,a,k,frac", [(1, 1, 1, 1.0), (1, 1, 0, 0.0), (3, 8193, 8193, 0.5), (2, 300, 0, 0.5),
                                        (2, 1001, 1000, 0.999), (5, 16385, 7, 0.001), (3, 2100, 2100, 0.5),
                                        (1, 33601, 700, 0.02)])
def test_compact_rows_kernel_at_edge_shapes(card, b, a, k, frac):
    """K = 0 and K = A, one row, fg's rows off 16 bytes (A 8,193, 2,100, 16,385), a row one entry past the forward's
    tile of 16,384 and three tiles long, and K = A over 44 blocks an image in ragged shares: bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(a + k)
    fg = torch.rand(b, a, device=card, generator=gen) < frac
    x = compact_layout("map", b, a, torch.float32, seed=a)
    compact_case_check(x, fg, k, compact_gradient(b, k, torch.float32, seed=k, misaligned=False), "vector",
                       f"B {b}, A {a}, K {k}")


def test_compact_rows_forward_is_one_kernel(card):
    """One K9 forward call runs one device kernel (torch.profiler, chip_smoke.compact_kernels_a_call) on a grid that
    the shapes fix (`compact_rows_shares`): B 16, A 8,400, K 320 on the assigner's mask, and B 1."""
    for b in (16, 1):
        fg, k = compact_mask(b, 640, 32, "assigner", seed=b)
        x = compact_layout("map", b, fg.shape[1], torch.float32, seed=b)
        assert compact_kernels_a_call(x, fg, k) == 1
    assert L.compact_rows_shares(16, 320) == 8 and L.compact_rows_shares(1, 320) == 10


def test_compact_rows_refuses_a_route_the_layout_does_not_allow(card):
    """The C entries hold the wrapper to its plan: the 16-byte route on logits one column in, and on a gradient one
    element off, return cudaErrorMisalignedAddress and launch nothing."""
    lib, stream = L._compact_lib(), torch.cuda.current_stream().cuda_stream
    x = torch.zeros(2, 50, 146, device=card)[..., 1:65]
    fg = torch.ones(2, 50, dtype=torch.bool, device=card)
    rows = torch.empty(2, 10, 64, device=card)
    idx, pos = torch.empty(2, 10, dtype=torch.int64, device=card), torch.empty(2, 50, dtype=torch.int32, device=card)
    g = torch.zeros(2 * 10 * 64 + 1, device=card)[1:]
    dx = torch.empty(2, 50, 64, device=card)
    rcs = [lib.compact_rows_forward(x.data_ptr(), 146, 2, 50, 64, 4, 1, fg.data_ptr(), 10, 1, rows.data_ptr(),
                                    idx.data_ptr(), pos.data_ptr(), card.index or 0, stream),
           lib.compact_rows_backward(g.data_ptr(), 2, 10, 50, 64, 4, 1, pos.data_ptr(), dx.data_ptr(), card.index or 0,
                                     stream)]
    torch.cuda.synchronize()
    assert [lib.compact_rows_error_string(rc).decode() for rc in rcs] == ["misaligned address"] * 2, rcs
    assert L.compact_rows_plan(x)["route"] == "scalar" and L.compact_rows_plan(g.view(2, 10, 64))["route"] == "scalar"


def test_compact_rows_rejects_what_it_does_not_take(card):
    maps = torch.zeros(2, 50, 144, device=card)
    fg = torch.zeros(2, 50, dtype=torch.bool, device=card)
    with pytest.raises(TypeError):  # no path of the port makes fp16 maps
        L.compact_rows(maps[..., :64].half(), fg, 10)
    with pytest.raises(ValueError):  # the logits' last dim strided
        L.compact_rows(maps[..., :128:2], fg, 10)
    with pytest.raises(ValueError):
        L.compact_rows(maps[..., :64], fg.cpu(), 10)  # the mask on another device


def test_end2end_loss_gathers_with_k9_in_both_heads(card):
    """The end2end loss at 640, batch 16, M 32 (chip_smoke.e2e_loss_check): both heads compact (K9 and its backward
    twice a step), items within rtol 1e-5 and d loss / d maps bit for bit against the plain versions."""
    e2e_loss_check(torch.cuda.get_device_name(0))


# ---------------- the feed to the card ----------------


def test_feed_buffers_are_pinned_and_a_slow_step_keeps_its_batch(card, tmp_path):
    """The feed's host buffers are page-locked, the loader's rows written straight into them (no staging copy);
    a step slowed with torch.cuda._sleep, whose batch is dropped as soon as its read is queued, still reads the
    bytes it was sent while the next batches are staged and copied into recycled memory (the ring reuses a host
    buffer only after its copy, the allocator a device block only after the consumer's stream used it); the bytes
    on the card equal a pageable upload's."""
    from chip_smoke import write_val_dataset
    from yololite_tpu_torch.data.build import DeviceFeed, PinnedRing
    from yololite_tpu_torch.data.dataset import DataLoader, YOLODataset

    rng = np.random.default_rng(5)
    batches = [{"img": rng.integers(0, 256, (4, 256, 256, 3), np.uint8), "n": i} for i in range(12)]
    ring = PinnedRing(card, depth=2)
    feed = DeviceFeed(batches, card, lambda b, take: ({"img": b["img"]}, b["n"]), ring=ring)
    reads = []
    for tensors, n in feed:
        x = tensors.pop("img")
        torch.cuda._sleep(20_000_000)  # the step, some 10 ms on the card, then its read of the batch
        reads.append((n, x.clone()))
        del x, tensors
    torch.cuda.synchronize()
    assert [n for n, _ in reads] == list(range(12)) and ring.pinned and ring.in_use() == 0
    assert all(b.host.is_pinned() for group in ring._idle.values() for b in group) and ring.allocations <= 3
    for n, got in reads:
        assert torch.equal(got, torch.from_numpy(batches[n]["img"]).to(card))  # a pageable upload's bytes
    up = feed.upload
    assert up.staged_bytes == up.bytes == sum(b["img"].nbytes for b in batches) and up.batches == 12

    root = tmp_path / "ds"
    write_val_dataset(root, [(480, 640), (640, 480), (640, 640), (360, 640)] * 2, seed=6)
    loader = DataLoader(YOLODataset(str(root / "images" / "val"), imgsz=640, batch_size=4, rect=True,
                                    data={"names": {i: str(i) for i in range(80)}}), batch_size=4, workers=2)
    want = [b["img"] for b in loader]
    ring = PinnedRing(card)
    feed = DeviceFeed(loader, card, ring=ring)
    got = [tensors["img"].cpu() for tensors, _ in feed]
    assert feed.upload.staged_bytes == 0 and len(got) == len(want) == 2
    assert all(torch.equal(g, torch.from_numpy(w)) for g, w in zip(got, want))
    assert all(b.host.is_pinned() for group in ring._idle.values() for b in group) and ring.in_use() == 0
