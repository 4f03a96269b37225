"""K4's plain version (`ops.kernels.blocked_nms_finalize` on the CPU) against the JAX package, and the routing to it.

K4 is exact greedy NMS over K > 1024 score-sorted candidates plus the
compaction of the kept rows: the port's `_finalize(boxes, vals, cls,
_blocked_keep(shifted, valid, thr), max_det)`. Its plain version is held
here, value for value, to the JAX package's
`vmap(_finalize)(boxes, vals, cls, _blocked_keep(shifted, valid, thr))`
(yololite_tpu/ops/nms.py:164,281) on numpy-seeded crowded scenes. JAX's
blocked keep halves its block until it divides K: 2048 and 6720 run 2 blocks
of 1024 and 105 of 64; 1500 would unroll 375 blocks of 4 (minutes of XLA
compile), so there the JAX reference keep is its fixpoint keep, which
tests/test_ops.py holds to the blocked one. The kernel itself is held to
this plain version on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.ops import nms as jnms

from yololite_tpu_torch.ops import boxes as tboxes, kernels as K, nms as tnms

from chip_smoke import near_threshold_boxes
from tests.test_torch_nms import BOX_ATOL, BOX_RTOL, STRIDES, _feats

MAX_WH = 7680


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while XLA shares the process (see tests/test_torch_nms.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, b, k, nc=3, case="crowded"):
    """Score-sorted candidates: boxes (B, K, 4), vals and cls (B, K) float32, valid (B, K) bool.

    Scores fall from 1 to -0.1, so the last rows are valid with a score <= 0:
    kept (they suppress) but never emitted. `case`: "crowded" (heavy overlap
    across blocks), "spread" (few overlaps: the first block alone keeps
    hundreds), "first-block" (every candidate past the first 1024 invalid),
    "invalid" (nothing valid), "nan" (NaN coordinates in every 7th box).
    """
    rng = np.random.default_rng(seed)
    span = 6000.0 if case == "spread" else 600.0
    c = rng.uniform(20, span, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if case == "nan":
        boxes[:, ::7, rng.integers(0, 4)] = np.nan
    vals = np.broadcast_to(np.linspace(1.0, -0.1, k, dtype=np.float32), (b, k)).copy()
    cls = rng.integers(0, nc, (b, k)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.1
    if case == "first-block":
        valid[:, 1024:] = False
    elif case == "invalid":
        valid[:] = False
    return boxes, vals, cls, valid


@functools.lru_cache(maxsize=None)
def _jax_keep_fn(k: int):
    keep = jnms._fixpoint_keep if k == 1500 else jnms._blocked_keep  # 1500: see the module's note
    return jax.jit(keep, static_argnums=2)


def _jax_reference(boxes, vals, cls, valid, thr, max_det):
    shifted = boxes + cls[..., None] * MAX_WH
    keep = _jax_keep_fn(boxes.shape[1])(jnp.asarray(shifted), jnp.asarray(valid), thr)
    fin = jax.vmap(functools.partial(jnms._finalize, max_det=max_det))
    return np.asarray(fin(jnp.asarray(boxes), jnp.asarray(vals), jnp.asarray(cls), keep)), np.asarray(keep)


def _port(boxes, vals, cls, valid, thr, max_det):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    shifted = t(boxes) + t(cls)[..., None] * MAX_WH
    return K.blocked_nms_finalize(shifted, t(boxes), t(vals), t(cls), t(valid), thr, max_det).numpy()


CASES = [  # (K, max_det, case)
    (2048, 300, "crowded"),
    (2048, 1, "crowded"),
    (2048, 2048, "crowded"),
    (1500, 300, "crowded"),
    (1500, 1500, "crowded"),
    (6720, 300, "crowded"),
    (6720, 6720, "crowded"),
    (2048, 300, "spread"),  # the first block alone keeps more than max_det
    (6720, 1, "spread"),
    (2048, 300, "first-block"),
    (6720, 6720, "first-block"),
    (2048, 300, "invalid"),
]


@pytest.mark.parametrize("k,max_det,case", CASES, ids=[f"K{k}-det{d}-{c}" for k, d, c in CASES])
def test_blocked_nms_finalize_plain_matches_jax(k, max_det, case):
    boxes, vals, cls, valid = _scene(k + max_det, 2, k, case=case)
    got = _port(boxes, vals, cls, valid, 0.5, max_det)
    want, keep = _jax_reference(boxes, vals, cls, valid, 0.5, max_det)
    assert got.shape == want.shape == (2, max_det, 6)
    np.testing.assert_array_equal(got, want)
    emitted = (keep & (vals > 0)).sum(1)
    np.testing.assert_array_equal((got[..., 4] > 0).sum(1), np.minimum(emitted, max_det))
    if case == "invalid":
        assert not got.any()
    elif case == "spread":
        assert (keep[:, :1024].sum(1) > max_det).all()
    elif case == "crowded":
        assert 0 < keep.sum() < valid.sum() and (keep & (vals <= 0)).any()  # suppression and kept-not-emitted rows


def test_blocked_nms_finalize_is_the_plain_expression():
    """On the CPU the op is `_finalize` of `_blocked_keep`, through ops/nms.py's own functions (one exact keep per
    alive block of 1024)."""
    boxes, vals, cls, valid = _scene(3, 2, 3000)
    valid[:, 2048:] = False  # the third block is dead: no keep runs there
    t = torch.from_numpy
    shifted = t(boxes) + t(cls)[..., None] * MAX_WH
    calls = []
    exact = tnms._exact_keep
    try:
        tnms._exact_keep = lambda s, v, thr: calls.append(s.shape[1]) or exact(s, v, thr)
        got = K.blocked_nms_finalize(shifted, t(boxes), t(vals), t(cls), t(valid), 0.6, 300)
    finally:
        tnms._exact_keep = exact
    assert calls == [1024, 1024]
    want = tnms._finalize(t(boxes), t(vals), t(cls), tnms._blocked_keep(shifted, t(valid), 0.6), 300)
    assert torch.equal(got, want)


def test_blocked_nms_finalize_passes_opcheck():
    boxes, vals, cls, valid = _scene(4, 2, 1100)
    t = torch.from_numpy
    shifted = t(boxes) + t(cls)[..., None] * MAX_WH
    args = (shifted, t(boxes), t(vals), t(cls), t(valid), 0.45, 50)
    torch.library.opcheck(torch.ops.yololite_tpu_torch.blocked_nms_finalize.default, args)
    before = K.blocked_nms_finalize.launches
    out = K.blocked_nms_finalize(*args)
    assert out.shape == (2, 50, 6) and out.is_contiguous()
    assert K.blocked_nms_finalize.launches == before  # the plain version is not a launch


def test_blocked_nms_finalize_refuses_what_it_does_not_take():
    boxes, vals, cls, valid = (torch.from_numpy(a) for a in _scene(5, 1, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        K.blocked_nms_finalize(boxes.to("meta"), boxes, vals, cls, valid, 0.5, 10)


@pytest.mark.parametrize("mode,k,routed", [("greedy", 2048, True), ("pallas", 1100, True), ("greedy", 1024, False),
                                           ("fast", 2048, False)])
def test_exact_nms_over_1024_routes_to_k4(monkeypatch, mode, k, routed):
    """non_max_suppression and nms_from_feats send exact NMS with K > 1024 to blocked_nms_finalize, and nothing
    else: K <= 1024 stays K1's keep and `_finalize`, Fast-NMS stays itself."""
    rng = np.random.default_rng(6)
    seen = []
    real = tnms.blocked_nms_finalize
    monkeypatch.setattr(tnms, "blocked_nms_finalize", lambda *a: seen.append(a[0].shape) or real(*a))
    boxes, _, _, _ = _scene(6, 2, 600)
    scores = rng.uniform(0.02, 1.0, (2, 600, 4)).astype(np.float32)
    tnms.non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), conf_thres=0.01, max_cand=k,
                             multi_label=True, mode=mode)
    feats = [torch.from_numpy(f) for f in _feats(rng, B=2, nc=20)]  # 336 anchors x 20 classes
    tnms.nms_from_feats(feats, STRIDES, 20, 16, conf_thres=1e-7, max_cand=k, multi_label=True, mode=mode)
    assert seen == ([(2, k, 4)] * 2 if routed else [])


def test_nms_from_feats_k2048_multi_label_matches_jax(monkeypatch):
    """The validator's multi-label select-first NMS at K = 2048 through the K4 routing: K4's inputs and output
    bit for bit against JAX's blocked keep and finalize on them; the whole call against JAX's nms_from_feats
    (scores, classes and counts exact, boxes within the DFL's rounding)."""
    nc, k = 20, 2048
    feats = _feats(np.random.default_rng(7), B=2, nc=nc)
    kw = dict(conf_thres=1e-7, iou_thres=0.7, max_det=300, max_cand=k, multi_label=True)
    seen = []
    real = tnms.blocked_nms_finalize
    monkeypatch.setattr(tnms, "blocked_nms_finalize", lambda *a: seen.append(a) or real(*a))
    got = tnms.nms_from_feats([torch.from_numpy(f) for f in feats], STRIDES, nc, 16, **kw).numpy()
    assert len(seen) == 1
    shifted, boxes, vals, cls, valid, thr, max_det = seen[0]
    keep = _jax_keep_fn(k)(jnp.asarray(shifted.numpy()), jnp.asarray(valid.numpy()), thr)
    fin = jax.vmap(functools.partial(jnms._finalize, max_det=max_det))
    want_k4 = np.asarray(fin(jnp.asarray(boxes.numpy()), jnp.asarray(vals.numpy()), jnp.asarray(cls.numpy()), keep))
    np.testing.assert_array_equal(got, want_k4)
    assert 0 < int(np.asarray(keep).sum()) < int(valid.sum())
    want = np.asarray(jnms.nms_from_feats([jnp.asarray(f) for f in feats], STRIDES, nc, 16, **kw))
    assert (got[..., 4] > 0).sum(1).min() > 50
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=BOX_RTOL, atol=BOX_ATOL)


# ---------------- the invariants K4's design relies on ----------------

STEP_SCENES = ["crowded", "spread", "first-block", "invalid", "nan"]


@functools.lru_cache(maxsize=None)
def _step_scene(k, case):
    """A scene at K (B 2) as torch tensors: shifted, boxes, vals, cls, valid."""
    boxes, vals, cls, valid = _scene(k + len(case), 2, k, case=case)
    t = torch.from_numpy
    return t(boxes) + t(cls)[..., None] * MAX_WH, t(boxes), t(vals), t(cls), t(valid)


@functools.lru_cache(maxsize=None)
def _keep_at_1024(k, case):
    shifted, _, _, _, valid = _step_scene(k, case)
    return tnms._blocked_keep(shifted, valid, 0.5, block=1024)


@pytest.mark.parametrize("case", STEP_SCENES)
@pytest.mark.parametrize("k", [1500, 2048, 6720])
@pytest.mark.parametrize("step", [128, 256, 512, 1024])
def test_blocked_keep_is_the_same_at_any_step(step, k, case):
    """Candidates are score-sorted and suppression only acts forward, so walking them in steps of 128, 256, 512 or
    1024 (a ragged last step at K 1500 and 6720) gives one keep; at 1024 it is the JAX package's `_blocked_keep`
    (its fixpoint keep at K 1500, see the module's note)."""
    shifted, _, _, _, valid = _step_scene(k, case)
    want = _keep_at_1024(k, case)
    if step == 1024:
        jax_keep = _jax_keep_fn(k)(jnp.asarray(shifted.numpy()), jnp.asarray(valid.numpy()), 0.5)
        np.testing.assert_array_equal(want.numpy(), np.asarray(jax_keep))
        if case in ("crowded", "nan"):
            assert 0 < int(want.sum()) < int(valid.sum())
    else:
        assert torch.equal(tnms._blocked_keep(shifted, valid, 0.5, block=step), want)


@pytest.mark.parametrize("max_det", [1, 300])
@pytest.mark.parametrize("case", ["crowded", "spread", "nan"])
@pytest.mark.parametrize("k", [2048, 6720])
def test_finalize_is_settled_at_the_walks_stop(k, case, max_det):
    """The walk may stop once max_det rows are out: `_finalize`'s rows do not change when every candidate past the
    max_det-th emitted one is made invalid."""
    shifted, boxes, vals, cls, valid = _step_scene(k, case)
    keep = _keep_at_1024(k, case)
    want = tnms._finalize(boxes, vals, cls, keep, max_det)
    done = (keep & (vals > 0)).long().cumsum(1) >= max_det
    assert bool(done.any(1).all())  # every image reaches max_det before its last candidate
    stop = done.float().argmax(1)
    cut = valid & (torch.arange(k)[None] <= stop[:, None])
    assert int(cut.sum()) < int(valid.sum())
    got = tnms._finalize(boxes, vals, cls, tnms._blocked_keep(shifted, cut, 0.5), max_det)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _division_free_above(inter, den, thr):
    """numpy model of csrc/blocked_nms.cu `iou_above`: the fma signs decide below thr and above the float after
    thr, den <= 0, NaN and the one-ulp band between take the IEEE quotient. float64 holds thr * den exactly, and its
    difference with inter keeps the sign of the fma's exact value. Returns (decision, decided without division)."""
    thr = np.float32(thr)
    up = np.nextafter(thr, np.float32(np.inf))
    i64, d64 = inter.astype(np.float64), den.astype(np.float64)
    below, above = i64 - np.float64(thr) * d64, i64 - np.float64(up) * d64
    with np.errstate(invalid="ignore", divide="ignore"):
        decided = (den > 0) & ((below < 0) | (above > 0))
        return np.where(decided, above > 0, (inter / den) > thr), decided


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.7])
def test_division_free_iou_test_keeps_box_ious_bits(thr):
    """K4's IoU test without the division gives `box_iou(a, b) > thr` on every pair: pairs within a few ulps of thr
    (some of them inside the one-ulp band that takes the division), crowded random pairs, degenerate boxes (den <=
    0) and NaN coordinates."""
    rng = np.random.default_rng(int(thr * 100))
    near = near_threshold_boxes(rng, 1, 40000, thr)[0]
    c = rng.uniform(20, 200, (40000, 2))
    wh = rng.uniform(-5, 60, (40000, 2))  # some widths negative: degenerate boxes
    crowd = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    crowd[::97, 1] = np.nan
    a = np.concatenate([near[0::2], crowd[0::2]])
    b = np.concatenate([near[1::2], crowd[1::2]])
    with np.errstate(invalid="ignore"):
        w = np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), np.float32(0))
        h = np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), np.float32(0))
        inter = w * h
        area_a, area_b = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        den = ((area_a + area_b) - inter) + np.float32(1e-7)
    assert inter.dtype == den.dtype == np.float32
    got, decided = _division_free_above(inter, den, thr)
    iou = tboxes.box_iou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[:, None])[:, 0, 0].numpy()
    want = iou > np.float32(thr)
    np.testing.assert_array_equal(got, want)
    n = len(near) // 2
    assert want[:n].any() and not want[:n].all()  # both sides of thr among the near pairs
    assert 0 < int((~decided[:n]).sum()) < n // 4  # the band (with hb / ha == thr exactly) takes the division
    assert (den[n:] <= 0).any() and (~decided[n:]).any()
