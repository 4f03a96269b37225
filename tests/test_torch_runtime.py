"""yololite_tpu_torch's serving runtime on the CPU: export round trips, the pipeline, the kernels as ops.

- `export_predict` (torch.export) reloaded by `load_exported` equals the
  in-process graph (`predict_graph`) bit for bit, in fp32 and int8, and the
  graph calls K3 and K1 (and K8 when int8) as `torch.library` ops;
- `InferencePipeline`'s detections equal the predictor's `infer` on the same
  batch;
- `torch.library.opcheck` passes for both ops (schema, fake tensors,
  autograd registration, AOT dispatch).
This file imports no jax: it holds the port to itself.
"""

import time

import numpy as np
import pytest
import torch

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.engine.predictor import DetectionPredictor
from yololite_tpu_torch.ops import kernels as K
from yololite_tpu_torch.ops.letterbox import preprocess_batch
from yololite_tpu_torch.runtime import InferencePipeline, load_exported, predict_graph


@pytest.fixture(scope="module")
def model():
    return YOLOLite("yolo11n.yaml", device="cpu")


def _graph_ops(path):
    return sorted({str(n.target) for n in torch.export.load(str(path)).graph.nodes if "yololite" in str(n.target)})


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_export_round_trip_equals_the_graph(model, tmp_path, int8):
    rng = np.random.default_rng(1)
    kw = dict(half=False, conf=1e-7)
    if int8:
        kw.update(half=True, int8_calib=[rng.random((2, 96, 96, 3)).astype(np.float32)])
    path = model.export(tmp_path / "n.pt2", imgsz=96, batch=2, **kw)
    assert path.exists() and (tmp_path / "n.pt2.json").exists()
    call, meta = load_exported(path)
    assert meta["format"] == "torch.export" and meta["int8"] is int8 and meta["nc"] == 80 and meta["max_det"] == 300
    imgs = torch.from_numpy(rng.random((2, 96, 96, 3)).astype(np.float32))
    out = call(imgs)
    with torch.no_grad():
        ref = predict_graph(model.model, device="cpu", **kw)(imgs)
    assert out.shape == (2, 300, 6) and int((ref[..., 4] > 0).sum()) > 0
    assert torch.equal(out, ref)
    want = ["yololite_tpu_torch.greedy_nms_keep.default"] + (["yololite_tpu_torch.int8_conv.default"] if int8 else [])
    want += ["yololite_tpu_torch.select_decode.default"]  # K3: steps 1-4 of nms_from_feats, one op
    assert _graph_ops(path) == want


def test_pipeline_detections_equal_the_predictor(model):
    pred = DetectionPredictor(overrides={"conf": 1e-7, "batch": 2, "imgsz": 96, "mode": "predict", "verbose": False,
                                         "save": False}, device="cpu")
    pred.setup_model(model.model)
    pipe = InferencePipeline(pred, imgsz=96).start()
    rng = np.random.default_rng(0)
    batches = [[rng.integers(0, 255, (72, 96, 3), np.uint8) for _ in range(n)] for n in (2, 2, 1, 2)]
    t0 = time.perf_counter()
    for b in batches:
        pipe.submit(b)
    pipe.close()
    got = list(pipe.results())
    wall = time.perf_counter() - t0
    assert [t for t, _ in got] == [0, 2, 4, 5]
    for (_, dets), b in zip(got, batches):
        im = preprocess_batch(b, imgsz=96)
        im = np.concatenate([im, np.zeros((2 - len(b), *im.shape[1:]), im.dtype)])
        want = pred.infer(torch.from_numpy(im)).numpy()[:len(b)]
        assert dets.shape == (len(b), 300, 6) and (dets[..., 4] > 0).any()
        np.testing.assert_array_equal(dets, want)
    s = pipe.summary(wall)
    assert s["completed"] == 7 and 0 < s["p50_ms"] <= s["p90_ms"] <= s["p99_ms"] and s["throughput_img_s"] > 0


def test_kernels_pass_opcheck():
    rng = np.random.default_rng(2)
    c = rng.uniform(10, 80, (2, 40, 2))
    boxes = torch.from_numpy(np.concatenate([c - 8, c + 8], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(2, 40)) > 0.2)
    torch.library.opcheck(torch.ops.yololite_tpu_torch.greedy_nms_keep.default, (boxes, valid, 0.45))
    assert torch.equal(K.greedy_nms_keep(boxes, valid, 0.45), K.greedy_nms_keep_plain(boxes, valid, 0.45))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 8, 9, 7)).astype(np.int8)).contiguous(
        memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, 16).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, 16).astype(np.float32))
    for w, stride, groups, sout in (((16, 3, 3, 8), 2, 1, 0.02), ((16, 1, 1, 8), 1, 1, 0.0), ((8, 3, 3, 1), 1, 8, 0.0)):
        wq = torch.from_numpy(rng.integers(-127, 128, w).astype(np.int8))
        n = w[0]
        args = (x, wq, scale[:n].contiguous(), bias[:n].contiguous(), stride, w[1] // 2, groups, 1, sout)
        torch.library.opcheck(torch.ops.yololite_tpu_torch.int8_conv.default, args)
        y = K.int8_conv(*args)
        assert y.dtype == (torch.int8 if sout else torch.bfloat16) and y.is_contiguous(memory_format=torch.channels_last)


def test_ops_refuse_what_they_do_not_take():
    x = torch.zeros((1, 8, 4, 4), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    s, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError):
        K.int8_conv(x.float(), w, s, b)
    with pytest.raises(ValueError):
        K.int8_conv(x, torch.zeros((8, 3, 3, 4), dtype=torch.int8), s, b)
    with pytest.raises(TypeError):
        K.int8_conv(x, w, s.double(), b)


def test_pipeline_raises_a_stage_failure_instead_of_hanging():
    """A failing infer (a capture that fails on the card, say) comes out of results(); submit and close return."""

    class Failing:
        args = type("A", (), {"imgsz": 64, "batch": 2})()
        device = torch.device("cpu")
        done_warmup = True

        def infer(self, x):
            raise RuntimeError("the step failed")

    pipe = InferencePipeline(Failing(), imgsz=64, depth=1).start()
    frames = [np.zeros((48, 64, 3), np.uint8)] * 2
    for _ in range(6):  # more than the queues hold
        pipe.submit(frames)
    pipe.close()
    with pytest.raises(RuntimeError, match="the step failed"):
        list(pipe.results())
