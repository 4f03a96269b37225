"""yololite_tpu_torch.ops.rotated against yololite_tpu.ops.rotated on the CPU.

Random OBBs (tests/test_rotated.py `_rand_obbs`) go through both packages:
floats within rtol 1e-5 / atol 1e-6, nms_rotated's keep indices and valid
flags equal (deliberate score ties included: both order them by index), and
the rotated assigner's masks equal and its targets within the float bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.ops import rotated as JR

from yololite_tpu_torch.ops import rotated as TR

from tests.test_rotated import _rand_obbs

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("ciou", [False, True], ids=["iou", "ciou"])
def test_probiou_matches_jax(ciou):
    b1, b2 = _rand_obbs(60, 0), _rand_obbs(60, 1)
    b2[:10] = b1[:10]  # identical boxes: the distance clips at eps
    _close(TR.probiou(torch.from_numpy(b1), torch.from_numpy(b2), CIoU=ciou),
           JR.probiou(jnp.asarray(b1), jnp.asarray(b2), CIoU=ciou))


def test_batch_probiou_matches_jax():
    b1, b2 = _rand_obbs(40, 2), _rand_obbs(30, 3)
    got = TR.batch_probiou(torch.from_numpy(b1), torch.from_numpy(b2))
    assert got.shape == (40, 30)
    _close(got, JR.batch_probiou(b1, b2))
    _close(TR.batch_probiou(b1, b2), JR.batch_probiou(b1, b2))  # numpy inputs


def test_xywhr2xyxyxyxy_matches_jax():
    b = _rand_obbs(20, 4).reshape(4, 5, 5)
    got = TR.xywhr2xyxyxyxy(torch.from_numpy(b))
    assert got.shape == (4, 5, 4, 2)
    _close(got, JR.xywhr2xyxyxyxy(jnp.asarray(b)), atol=1e-5)


def test_dist2rbox_matches_jax():
    rng = np.random.default_rng(5)
    dist = rng.uniform(0, 8, (2, 30, 4)).astype(np.float32)
    angle = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 30, 1)).astype(np.float32)
    anchors = rng.uniform(0, 20, (30, 2)).astype(np.float32)
    _close(TR.dist2rbox(torch.from_numpy(dist), torch.from_numpy(angle), torch.from_numpy(anchors)),
           JR.dist2rbox(jnp.asarray(dist), jnp.asarray(angle), jnp.asarray(anchors)))


@pytest.mark.parametrize("case", ["random", "ties", "dense", "few"])
def test_nms_rotated_matches_jax(case):
    rng = np.random.default_rng(6)
    n = {"random": 200, "ties": 200, "dense": 300, "few": 5}[case]
    boxes = _rand_obbs(n, 7)
    if case == "dense":  # heavy overlap: many suppressions
        boxes[:, :2] = rng.uniform(45, 55, (n, 2))
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    if case == "ties":  # blocks of equal scores, and duplicated boxes among them
        scores = np.round(scores * 8) / 8
        boxes[100:150] = boxes[:50]
    idx, valid = TR.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, max_det=100)
    jidx, jvalid = JR.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), 0.45, max_det=100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.any() and (case == "few" or not valid.all())


def test_select_candidates_in_rotated_gts_matches_jax():
    rng = np.random.default_rng(8)
    gts = _rand_obbs(12, 9).reshape(2, 6, 5)
    pts = rng.uniform(0, 100, (500, 2)).astype(np.float32)
    got = TR.select_candidates_in_rotated_gts(torch.from_numpy(pts), torch.from_numpy(gts))
    want = np.asarray(JR.select_candidates_in_rotated_gts(jnp.asarray(pts), jnp.asarray(gts)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def _assigner_inputs(B=2, A=400, M=6, nc=4, seed=10):
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(A))
    g = (np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2) + 0.5) * (100 / side)
    anchors = g[:A].astype(np.float32)
    gt = _rand_obbs(B * M, seed + 1).reshape(B, M, 5)
    labels = rng.integers(0, nc, (B, M, 1)).astype(np.int32)
    mask = np.ones((B, M, 1), np.float32)
    mask[1, -2:] = 0  # padded GTs
    pd_boxes = np.concatenate([anchors[None].repeat(B, 0) + rng.uniform(-3, 3, (B, A, 2)),
                               rng.uniform(5, 30, (B, A, 2)), rng.uniform(0, np.pi / 2, (B, A, 1))],
                              -1).astype(np.float32)
    pd_scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    return pd_scores, pd_boxes, anchors, labels, gt, mask


@pytest.mark.parametrize("topk", [1, 10])
def test_rotated_assigner_matches_jax(topk):
    inputs = _assigner_inputs()
    nc = inputs[0].shape[-1]
    got = TR.RotatedTaskAlignedAssigner(topk=topk, num_classes=nc, alpha=0.5, beta=6.0)(
        *(torch.from_numpy(x) for x in inputs))
    want = JR.RotatedTaskAlignedAssigner(topk=topk, num_classes=nc, alpha=0.5, beta=6.0)(
        *(jnp.asarray(x) for x in inputs))
    labels, bboxes, scores, fg, gt_idx = got
    jlabels, jbboxes, jscores, jfg, jgt_idx = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(fg.numpy(), jfg.astype(bool))
    assert fg.any()
    np.testing.assert_array_equal(gt_idx.numpy(), jgt_idx)
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    _close(bboxes, jbboxes)
    _close(scores, jscores)
