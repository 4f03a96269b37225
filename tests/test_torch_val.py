"""yololite_tpu_torch val vs the JAX package, on the CPU.

The metric functions (AP, the confusion matrix, COCO scoring, TP matching)
are numpy in both packages with the same operations in the same order, so
they are held bit for bit on seeded synthetic stats. The dataset's val items
are held byte for byte on the same files. The K = 8192 multi-label NMS is
held as tests/test_torch_nms.py holds the predict NMS: candidates and keep
masks bit for bit, boxes within rtol 1e-5, atol 1e-4 px (the DFL's sums
round differently in the two frameworks).

End to end, both validators check a small synthetic dataset (PNG images,
two rect buckets) on the same weights. Random init(0) weights make that
comparison meaningless: the signal fades through the depth, so every
anchor's class logit sits within a few ulps of the same value, hundreds of
candidates tie, and one rounding difference changes the greedy cascade.
The parity weights therefore scale every conv by 2.5, which keeps the
image's signal alive to the head. They scale the last class conv of each
level up, so class scores spread over the anchors. They draw that conv's
biases from the sigmoid-safe grid. The labels are the JAX model's own
detections, jittered, so mAP lands well inside (0, 1) and a flipped match
would show.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu import YOLOLite as JaxYOLOLite
from yololite_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yololite_tpu.engine.validator import DetectionValidator as JaxValidator
from yololite_tpu.ops import nms as jnms
from yololite_tpu.utils import cocoeval as jcoco, metrics as jmetrics

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.data.dataset import YOLODataset
from yololite_tpu_torch.engine.validator import DetectionValidator
from yololite_tpu_torch.models.checkpoint import state_dict_from_jax
from yololite_tpu_torch.ops import nms as tnms
from yololite_tpu_torch.ops.boxes import box_iou_np
from yololite_tpu_torch.utils import cocoeval as tcoco, metrics as tmetrics

from tests.test_torch_nms import BOX_RTOL, BOX_ATOL, STRIDES, _feats, _jax_select, _safe_grid

REPO = Path(__file__).resolve().parents[1]
BF16_MAP_TOL = 0.05  # see test_val_matches_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX.

    In a process that has run XLA, a torch worker thread's first parallel
    chunk of torch.exp was seen to come out with up to 1.5e-4 relative error
    (one chunk of eight, first call only; later calls exact). One thread has
    no such chunk.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- metric functions, bit for bit ----------------


def _synthetic_stats(seed=0, n_det=200, n_gt=120, nc=6):
    rng = np.random.default_rng(seed)
    tp = rng.random((n_det, 10)) > 0.6
    tp = np.sort(tp, axis=1)[:, ::-1]  # monotone: tp at a higher IoU implies tp at a lower one
    conf = rng.random(n_det)
    pred_cls = rng.integers(0, nc, n_det)
    target_cls = rng.integers(0, nc, n_gt)
    return tp, conf, pred_cls, target_cls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_per_class_matches_jax(seed):
    stats = _synthetic_stats(seed, nc=3 + seed)
    got = tmetrics.ap_per_class(*stats)
    want = jmetrics.ap_per_class(*stats)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    rng = np.random.default_rng(seed)
    rec, prec = np.sort(rng.random(50)), rng.random(50)
    for g, w in zip(tmetrics.compute_ap(rec, prec), jmetrics.compute_ap(rec, prec)):
        np.testing.assert_array_equal(g, w)
    y = rng.random(97)
    np.testing.assert_array_equal(tmetrics.smooth(y, 0.1), jmetrics.smooth(y, 0.1))


def test_det_metrics_and_fitness_match_jax():
    names = {i: f"c{i}" for i in range(5)}
    got, want = tmetrics.DetMetrics(names=names), jmetrics.DetMetrics(names=names)
    stats = _synthetic_stats(4, nc=5)
    got.process(*stats)
    want.process(*stats)
    assert got.results_dict == want.results_dict
    assert got.fitness == want.fitness
    np.testing.assert_array_equal(got.maps, want.maps)
    assert got.keys == want.keys
    assert 0 < got.results_dict["metrics/mAP50-95(B)"] < 1
    assert got.fitness == pytest.approx(0.1 * got.box.map50 + 0.9 * got.box.map, abs=1e-12)


def _boxes(rng, n, span=200.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    got, want = tmetrics.ConfusionMatrix(nc=4, conf=0.2), jmetrics.ConfusionMatrix(nc=4, conf=0.2)
    for _ in range(6):
        gt = _boxes(rng, 8)
        det = np.concatenate([gt[rng.integers(0, 8, 10)] + rng.uniform(-4, 4, (10, 4)).astype(np.float32),
                              rng.uniform(0, 1, (10, 1)), rng.integers(0, 4, (10, 1))], 1).astype(np.float32)
        gcls = rng.integers(0, 4, 8).astype(np.float32)
        for cm in (got, want):
            cm.process_batch(det, gt, gcls)
            cm.process_batch(det, gt[:0], gcls[:0])  # no ground truth: background false positives
            cm.process_batch(det[:0], gt, gcls)  # no detections: misses
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for g, w in zip(got.tp_fp(), want.tp_fp()):
        np.testing.assert_array_equal(g, w)
    assert got.matrix[:4, :4].trace() > 0


def test_box_iou_np_matches_jax_numpy_branch():
    from yololite_tpu.ops.boxes import box_iou as jax_box_iou

    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 30), _boxes(rng, 40)
    got = box_iou_np(a, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_box_iou(a, b))


def test_cocoeval_summarize_matches_jax():
    rng = np.random.default_rng(6)
    images, anns, dets = [], [], []
    for i in range(5):
        images.append({"id": i, "width": 300, "height": 200})
        for j in range(7):
            x, y, w, h = rng.uniform(0, 150), rng.uniform(0, 100), rng.uniform(4, 140), rng.uniform(4, 100)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": int(rng.integers(1, 4)),
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": int(j == 6)})
            for _ in range(2):
                jit = rng.uniform(-6, 6, 4)
                dets.append({"image_id": i, "category_id": anns[-1]["category_id"],
                             "bbox": [x + jit[0], y + jit[1], w + jit[2], h + jit[3]], "score": float(rng.random())})
    gt = {"images": images, "annotations": anns, "categories": [{"id": c} for c in (1, 2, 3)]}
    got = tcoco.COCOEval(gt, dets).summarize()
    want = jcoco.COCOEval(gt, dets).summarize()
    np.testing.assert_array_equal(got, want)
    assert 0 < got[0] < 1
    lt, gt_lt = np.array([d["bbox"] for d in dets[:9]]), np.array([a["bbox"] for a in anns[:7]])
    crowd = np.array([a["iscrowd"] for a in anns[:7]])
    np.testing.assert_array_equal(tcoco.iou_ltwh(lt, gt_lt, crowd), jcoco.iou_ltwh(lt, gt_lt, crowd))


def test_box_converters_match_jax():
    from yololite_tpu.ops import boxes as jboxes
    from yololite_tpu_torch.ops import boxes as tboxes

    rng = np.random.default_rng(14)
    x = rng.uniform(0, 1, (20, 4)).astype(np.float32)
    for name in ("xywh2ltwh", "xyxy2ltwh", "ltwh2xywh", "ltwh2xyxy", "xywh2xyxy", "xyxy2xywh"):
        np.testing.assert_array_equal(getattr(tboxes, name)(x), getattr(jboxes, name)(x), err_msg=name)
    np.testing.assert_array_equal(tboxes.xywhn2xyxy(x, 320, 240, 3, 5), jboxes.xywhn2xyxy(x, 320, 240, 3, 5))
    px = x * 300
    for clip in (False, True):
        np.testing.assert_array_equal(tboxes.xyxy2xywhn(px, 200, 100, clip=clip, eps=1e-3),
                                      jboxes.xyxy2xywhn(px, 200, 100, clip=clip, eps=1e-3))


@pytest.mark.parametrize("fmt", ["xywh", "xyxy", "ltwh"])
def test_instances_match_jax(fmt):
    """The val transforms' box path: convert, denormalize, scale, pad, convert back."""
    from yololite_tpu.utils.instance import Instances as JaxInstances
    from yololite_tpu_torch.utils.instance import Instances

    b = np.random.default_rng(15).uniform(0.1, 0.5, (9, 4)).astype(np.float32)
    got, want = Instances(b.copy(), bbox_format=fmt), JaxInstances(b.copy(), bbox_format=fmt)
    for ins in (got, want):
        ins.convert_bbox("xyxy")
        ins.denormalize(640, 480)
        ins.scale(0.75, 0.75)
        ins.add_padding(16, 0)
        ins.convert_bbox("ltwh")
        ins.convert_bbox(fmt)
    assert len(got) == len(want) == 9 and not got.normalized
    np.testing.assert_array_equal(got.bboxes, want.bboxes)


def test_find_dataset_yaml_matches_jax(tmp_path):
    from yololite_tpu.data.utils import find_dataset_yaml as jax_find
    from yololite_tpu_torch.data.utils import find_dataset_yaml

    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "data.yaml").write_text("val: x\n")
    assert find_dataset_yaml(tmp_path) == jax_find(tmp_path) == tmp_path / "sub" / "data.yaml"
    (tmp_path / "other.yaml").write_text("val: y\n")
    assert find_dataset_yaml(tmp_path) == tmp_path / "other.yaml"  # root level first
    (tmp_path / "more.yaml").write_text("val: z\n")
    with pytest.raises(ValueError):
        find_dataset_yaml(tmp_path)


def test_metric_plots_are_written(tmp_path):
    """PR/F1/P/R curves from DetMetrics(plot=True), and the PR and metric-confidence curve plots."""
    names = {i: f"c{i}" for i in range(3)}
    m = tmetrics.DetMetrics(save_dir=tmp_path, plot=True, names=names)
    m.process(*_synthetic_stats(16, nc=3))
    assert {p.name for p in tmp_path.glob("*.png")} == {"PR_curve.png", "F1_curve.png", "P_curve.png",
                                                          "R_curve.png"}
    box = m.box
    tmetrics.plot_pr_curve(box.px, box.prec_values, box.all_ap, tmp_path / "pr.png", names)
    tmetrics.plot_mc_curve(box.px, box.f1_curve, tmp_path / "mc.png", names, ylabel="F1")
    assert (tmp_path / "pr.png").stat().st_size > 0 and (tmp_path / "mc.png").stat().st_size > 0


def test_match_predictions_matches_jax():
    """Greedy unique matching on IoU matrices full of exact ties (values from a small set)."""
    tv = DetectionValidator(args={"mode": "val"}, device="cpu")
    jv = JaxValidator(args={"data": None, "mode": "val"})
    rng = np.random.default_rng(7)
    hits = 0
    for _ in range(20):
        n_gt, n_det = rng.integers(1, 12), rng.integers(1, 30)
        iou = rng.choice(np.array([0.0, 0.45, 0.5, 0.62, 0.75, 0.75, 0.9, 0.95], np.float32), (n_gt, n_det))
        pred_cls = rng.integers(0, 3, n_det).astype(np.float32)
        true_cls = rng.integers(0, 3, n_gt).astype(np.float32)
        got = tv.match_predictions(pred_cls, true_cls, iou)
        np.testing.assert_array_equal(got, jv.match_predictions(pred_cls, true_cls, iou))
        hits += int(got.sum())
    assert hits > 50


# ---------------- dataset ----------------


def _write_dataset(root: Path, shapes, seed: int, labels=None) -> Path:
    """PNG images (dark background, bright rectangles) under root/images/val, YOLO labels, and data.yaml.

    labels: per-image lists of (cls, cx, cy, w, h) normalized; random boxes over 80 classes when None.
    """
    import cv2

    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True, exist_ok=True)
    (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        im = rng.integers(0, 30, (h, w, 3)).astype(np.uint8)
        for _ in range(10):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            im[y0:y0 + rng.integers(8, h // 2), x0:x0 + rng.integers(8, w // 2)] += rng.integers(0, 200, 3).astype(
                np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"im{i}.png"), im)
        if labels is None:
            n = int(rng.integers(0, 6))
            c = rng.uniform(0.2, 0.8, (n, 2))
            wh = rng.uniform(0.05, 0.3, (n, 2))
            rows = [(int(k), *xy, *s) for k, xy, s in zip(rng.integers(0, 80, n), c, wh)]
        else:
            rows = labels[i]
        (root / "labels" / "val" / f"im{i}.txt").write_text(
            "\n".join(f"{k} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}" for k, cx, cy, bw, bh in rows))
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnc: 80\n")
    return root / "data.yaml"


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_dataset_items_match_jax(tmp_path, rect):
    shapes = [(120, 160), (160, 120), (160, 160), (90, 160), (100, 75)]
    _write_dataset(tmp_path, shapes, seed=8)
    kw = dict(imgsz=160, batch_size=2, rect=rect, data={"names": {i: str(i) for i in range(80)}})
    want = JaxYOLODataset(str(tmp_path / "images" / "val"), **kw)  # writes the shared label cache
    got = YOLODataset(str(tmp_path / "images" / "val"), **kw)  # and the port reads it
    assert got.im_files == want.im_files
    if rect:
        np.testing.assert_array_equal(got.batch_shapes, want.batch_shapes)
        np.testing.assert_array_equal(got.batch, want.batch)
        assert len({tuple(s) for s in got.batch_shapes}) > 1  # several buckets
    items = []
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        assert g["img"].dtype == np.uint8 and g["img"].flags.c_contiguous
        np.testing.assert_array_equal(g["img"], w["img"])
        for k in ("bboxes", "cls", "batch_idx"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        assert g["ratio_pad"] == w["ratio_pad"] and g["ori_shape"] == w["ori_shape"]
        assert g["resized_shape"] == w["resized_shape"] and g["im_file"] == w["im_file"]
        items.append(g)
    assert sum(len(it["cls"]) for it in items) > 0
    if rect:  # collate: a batch's images share the bucket's shape
        b = YOLODataset.collate_fn(items[:2])
        wb = JaxYOLODataset.collate_fn([want[0], want[1]])
        for k in ("img", "bboxes", "cls", "batch_idx"):
            np.testing.assert_array_equal(b[k], wb[k])


def test_label_cache_is_shared_and_loads_without_the_jax_package(tmp_path):
    """The port's labels.cache.npy is the JAX package's format: either reads the other's, importing no JAX."""
    _write_dataset(tmp_path, [(64, 96), (96, 64)], seed=9)
    images = str(tmp_path / "images" / "val")
    port = YOLODataset(images, imgsz=96)
    cache = tmp_path / "labels" / "val.cache.npy"
    assert cache.exists()
    jax_read = JaxYOLODataset(images, imgsz=96)  # reads the port's cache
    for a, b in zip(port.labels, jax_read.labels):
        np.testing.assert_array_equal(a["bboxes"], b["bboxes"])
    code = ("import sys\n"
            "from yololite_tpu_torch.data.dataset import YOLODataset\n"
            f"d = YOLODataset({images!r}, imgsz=96)\n"
            "assert len(d) == 2 and len(d[0]['img'])\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'yololite_tpu')))\n")
    cache.touch()
    before = cache.stat().st_mtime_ns
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert cache.stat().st_mtime_ns == before  # read, not rewritten


def test_dataset_train_mode_raises():
    """Train mode without the train transforms' hyperparameters is refused before any file is read."""
    with pytest.raises(ValueError, match="hyp"):
        YOLODataset("unused", augment=True)


# ---------------- the K = 8192 multi-label NMS ----------------


@pytest.mark.parametrize("agnostic", [False, True], ids=["class-aware", "agnostic"])
def test_nms_from_feats_k8192_matches_jax(agnostic):
    """The validator's call: multi-label, max_cand 8192, over A * nc = 26,880 flat candidates."""
    nc, k = 80, 8192
    rng = np.random.default_rng(10 + agnostic)
    feats = _feats(rng, B=2, nc=nc)
    tfeats = [torch.from_numpy(f) for f in feats]
    kw = dict(conf_thres=1e-7, iou_thres=0.7, max_det=300, max_cand=k, multi_label=True, agnostic=agnostic)

    vals, bidx, cls = tnms.select_from_feats(tfeats, nc, 16, 1e-7, k, multi_label=True)
    jvals, jbidx, jcls = _jax_select(feats, nc, 1e-7, k, multi_label=True)
    assert vals.shape == (2, k) and bool((vals > 1e-7).all())  # every candidate valid: every block runs
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(bidx.numpy(), jbidx)
    np.testing.assert_array_equal(cls.numpy(), jcls.astype(np.float32))

    # keep masks: JAX's blocked keep on the class-offset boxes that the port's blocked keep got
    seen, calls = [], []
    blocked, exact = tnms._blocked_keep, tnms._exact_keep

    def recording_blocked(shifted, valid, thr):
        keep = blocked(shifted, valid, thr)
        seen.append((shifted.numpy(), valid.numpy(), keep.numpy()))
        return keep

    try:
        tnms._blocked_keep = recording_blocked
        tnms._exact_keep = lambda *a: calls.append(1) or exact(*a)
        got = tnms.nms_from_feats(tfeats, STRIDES, nc, 16, **kw).numpy()
    finally:
        tnms._blocked_keep, tnms._exact_keep = blocked, exact
    assert len(seen) == 1
    shifted, valid, keep = seen[0]
    # one exact keep per alive block of 1024; a block is alive exactly when it keeps something
    assert len(calls) == keep.reshape(2, k // 1024, 1024).any(-1).any(0).sum() >= (1 if agnostic else 8)
    jkeep = np.asarray(jnms._blocked_keep(jnp.asarray(shifted), jnp.asarray(valid), 0.7))
    np.testing.assert_array_equal(keep, jkeep)
    assert 0 < keep.sum() < valid.sum()

    want = np.asarray(jnms.nms_from_feats([jnp.asarray(f) for f in feats], STRIDES, nc, 16, **kw))
    assert got.shape == want.shape == (2, 300, 6)
    assert (got[..., 4] > 0).sum(1).min() > 100
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])  # scores and classes, row by row
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=BOX_RTOL, atol=BOX_ATOL)


@pytest.mark.parametrize("k", [1575, 5040, 6720])
def test_blocked_keep_pads_a_ragged_k(k):
    """K not a multiple of 1024 runs ceil(K / 1024) exact keeps and gives the exact greedy keep.

    5040 and 6720 are the one-label validator's K on the 384x640 and 512x640
    rect buckets; there the JAX package halves its block to 16 and 64 (315
    and 105 blocks), and to 1 at K = 1575. Its blocked keep is exact greedy
    (tests/test_ops.py), so the JAX reference at every K is its fixpoint
    keep; its blocked keep itself is held at K = 6720 only, where its 105
    unrolled blocks compile in some 16 s here (5040's 315 take 47 s).
    """
    rng = np.random.default_rng(k)
    c = rng.uniform(20, 2000, (1, k, 2))
    wh = rng.uniform(10, 120, (1, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    valid = rng.uniform(size=(1, k)) > 0.1
    calls = []
    exact = tnms._exact_keep
    try:
        tnms._exact_keep = lambda s, v, t: calls.append(s.shape[1]) or exact(s, v, t)
        got = tnms._blocked_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    finally:
        tnms._exact_keep = exact
    assert calls == [1024] * -(-k // 1024)
    assert got.shape == (1, k)
    np.testing.assert_array_equal(got.numpy(), tnms._fixpoint_keep(torch.from_numpy(boxes),
                                                                   torch.from_numpy(valid), 0.5).numpy())
    jkeep = jax.jit(jnms._fixpoint_keep, static_argnums=2)(jnp.asarray(boxes), jnp.asarray(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jkeep))
    if k == 6720:
        jblocked = jax.jit(jnms._blocked_keep, static_argnums=2)(jnp.asarray(boxes), jnp.asarray(valid), 0.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jblocked))
    assert 0 < got.sum() < valid.sum()


# ---------------- val end to end ----------------


def test_uint8_scaling_matches_the_jax_validator():
    """The validator's x * (1/255) on the device gives the bits of the JAX validator's jitted x / 255.

    XLA lowers the division by a constant to that product; a true division
    differs in 126 of the 256 values, and one ulp of input can reorder
    near-tied candidates.
    """
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.float32) / 255.0)(jnp.asarray(x)))
    np.testing.assert_array_equal((torch.from_numpy(x).float() * (1.0 / 255.0)).numpy(), want)


@pytest.fixture(scope="module")
def val_pair(tmp_path_factory):
    """JAX and port facades on the same separating weights, and a dataset labelled from JAX's detections."""
    root = tmp_path_factory.mktemp("valdata")
    shapes = [(90, 160), (120, 160), (160, 160), (160, 120)]  # rect at batch 2: 160x192 and 192x192 buckets
    rng = np.random.default_rng(11)
    jm = JaxYOLOLite("yolo11n.yaml")
    grid = _safe_grid()
    mid = grid[(grid > -5) & (grid < 0)]
    p = jax.tree.map(lambda w: np.asarray(w) * 2.5 if np.ndim(w) == 4 else np.asarray(w), jm.params)
    for i, s in enumerate((100.0, 400.0, 1000.0)):  # per-level: about two logits of spread over the anchors
        c = p["23"]["cv3"][str(i)]["2"]
        c["b"] = mid[rng.integers(0, len(mid), 80)]
        c["w"] = (c["w"] * s).astype(np.float32)
    jm.params = jax.tree.map(jnp.asarray, p)
    tm = YOLOLite("yolo11n.yaml", device="cpu")
    tm.model.load_state_dict(state_dict_from_jax(p, jax.tree.map(np.asarray, jm.state)), strict=True)

    data = _write_dataset(root, shapes, seed=12, labels=[[] for _ in shapes])
    files = sorted(str(f) for f in (root / "images" / "val").iterdir())
    labels = []
    for r, (h, w) in zip(jm.predict(files, conf=0.01, imgsz=160, batch=4, save=False, verbose=False), shapes):
        rows = []
        for x1, y1, x2, y2, _, k in r.boxes.data[:8]:
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.uniform(-3, 3, 4), 0, [w, h, w, h])
            if x2 - x1 > 2 and y2 - y1 > 2:
                rows.append((int(k), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h))
        labels.append(rows)
    _write_dataset(root, shapes, seed=12, labels=labels)
    return jm, tm, data, root


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_val_matches_jax(val_pair, half):
    """The port's validator against the JAX validator on the same weights and files.

    fp32: per-image detection counts and classes equal, scores within 2e-6,
    |dmAP50-95| and |dmAP50| <= 1e-3; the COCO re-score of predictions.json
    within 1e-3 too. bf16: the two frameworks round bf16 at different places
    (XLA on the CPU widens elementwise bf16 ops to fp32; torch rounds after
    each op), so scores move by up to about 2e-3 and, with 8192 crowded
    candidates, the greedy cascade changes: counts equal, mAP within
    BF16_MAP_TOL.
    """
    jm, tm, data, root = val_pair
    args = dict(data=str(data), imgsz=160, batch=2, conf=1e-7, rect=True, mode="val", half=half, plots=False,
                workers=2, save_json=True)
    jv = JaxValidator(save_dir=root / f"jax{half}", args=args)
    want = jv(model=jm.model, params=jm.params, state=jm.state)
    tv = DetectionValidator(save_dir=root / f"port{half}", args=args, device="cpu")
    got = tv(model=tm.model)

    assert tv.seen == jv.seen == 4
    assert {tuple(s) for s in tv.dataloader.dataset.batch_shapes} == {(160, 192), (192, 192)}
    n_t = [len(c) for c in tv.stats["conf"]]
    assert n_t == [len(c) for c in jv.stats["conf"]] and min(n_t) > 100
    tol = BF16_MAP_TOL if half else 1e-3
    g, w = tv.metrics.results_dict, jv.metrics.results_dict
    for key in ("metrics/mAP50-95(B)", "metrics/mAP50(B)"):
        assert 0.05 < w[key] < 0.95
        assert abs(g[key] - w[key]) <= tol, (key, g[key], w[key])
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])  # the COCO re-scores
    if half:
        return
    for a, b, ca, cb in zip(tv.stats["pred_cls"], jv.stats["pred_cls"], tv.stats["conf"], jv.stats["conf"]):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
        np.testing.assert_allclose(np.sort(ca), np.sort(cb), rtol=0, atol=2e-6)
    # predictions.json holds the port's detections, and the port's COCOEval re-scores it to the returned stats
    preds = json.loads((root / "portFalse" / "predictions.json").read_text())
    assert preds == tv.jdict and len(preds) == sum(n_t)
    ds = tv.dataloader.dataset
    gt = tcoco.gt_from_yolo_labels(ds.labels, ds.im_files, tv.class_map)
    coco = tcoco.COCOEval(gt, preds, img_ids=[Path(f).stem for f in ds.im_files]).summarize()
    assert (coco[0], coco[1]) == (got["metrics/mAP50-95(B)"], got["metrics/mAP50(B)"])
    assert 0 < coco[0] < 1


def test_facade_val_on_the_cpu_imports_no_jax(tmp_path):
    """YOLOLite(..., device='cpu').val() in a fresh process: DetMetrics back, jax and yololite_tpu never imported.

    Square at imgsz 64, the multi-label pool is 84 anchors x 80 classes =
    6720 candidates, a K that is no multiple of 1024.
    """
    data = _write_dataset(tmp_path, [(48, 64), (64, 48), (64, 64)], seed=13)
    code = ("import sys\n"
            "from yololite_tpu_torch import YOLOLite\n"
            "m = YOLOLite('yolo11n.yaml', device='cpu')\n"
            f"r = m.val(data={str(data)!r}, imgsz=64, batch=2, conf=1e-7, rect=False, plots=False, workers=1,\n"
            f"          save_json=True, project={str(tmp_path / 'runs')!r})\n"
            "assert r is m.metrics and 0 <= r.results_dict['metrics/mAP50-95(B)'] <= 1\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'yololite_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert list((tmp_path / "runs").rglob("predictions.json"))


def test_val_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionValidator(args={"mode": "val"})
    assert DetectionValidator(args={"mode": "val"}, device="cpu").device.type == "cpu"
