"""yololite_tpu_torch decode/NMS vs the JAX package, and greedy_nms_keep vs the Pallas kernel.

Exact parts are held bit for bit: keep masks, candidate indices and order,
classes, counts and scores. Boxes come from the DFL expectation, whose sums
round differently in the two frameworks, and are held within rtol 1e-5,
atol 1e-4 px.

Class logits are drawn from a grid of multiples of 1/8 on which both
frameworks' sigmoids agree bit for bit, through every code path: on random
inputs torch's CPU sigmoid rounds some values differently from JAX's, and its
scalar path (a tensor's tail) rounds some differently from its vectorized
body. Few distinct grid values give many exact score ties, which pins the
lowest-index-first tie rule.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.ops import nms as jnms
from yololite_tpu.ops.boxes import box_iou as jax_box_iou
from yololite_tpu.ops.decode import decode_detections as jax_decode, postprocess_end2end as jax_e2e
from yololite_tpu.ops.pallas_kernels import greedy_nms_keep_pallas

from yololite_tpu_torch.ops import nms as tnms
from yololite_tpu_torch.ops.boxes import box_iou
from yololite_tpu_torch.ops.decode import decode_detections, postprocess_end2end
from yololite_tpu_torch.ops.kernels import greedy_nms_keep, greedy_nms_keep_plain

BOX_RTOL, BOX_ATOL = 1e-5, 1e-4
STRIDES = [8, 16, 32]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX.

    In a process that has run XLA, a torch worker thread's first parallel
    chunk of torch.exp was seen to come out with up to 1.5e-4 relative error
    (one chunk of eight, first call only; later calls exact), enough to move
    boxes and scores past the tolerances here. One thread has no such chunk.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _safe_grid():
    """Multiples of 1/8 in [-12, 3] whose sigmoid is the same float32 in JAX and in both torch code paths."""
    g = np.arange(-96, 25, dtype=np.float32) / 8
    j = np.asarray(jax.nn.sigmoid(jnp.asarray(g)))
    scalar = np.array([torch.sigmoid(torch.tensor(v)).item() for v in g], np.float32)  # torch's scalar path
    vector = torch.sigmoid(torch.from_numpy(np.repeat(g, 64))).numpy().reshape(-1, 64)  # its vectorized path
    ok = (j == scalar) & (vector == j[:, None]).all(1)
    assert ok.sum() > 60
    return g[ok]


def _feats(rng, B=2, shapes=((16, 16), (8, 8), (4, 4)), nc=5, n_values=None):
    """Per-level (B, H, W, 64 + nc) maps: random box logits, class logits on the safe grid."""
    grid = _safe_grid()
    if n_values:  # a few values only: massive exact ties within and across levels
        grid = grid[np.linspace(len(grid) // 2, len(grid) - 1, n_values).astype(int)]
    out = []
    for h, w in shapes:
        box = (rng.standard_normal((B, h, w, 64)) * 2).astype(np.float32)
        cls = grid[rng.integers(0, len(grid), (B, h, w, nc))].astype(np.float32)
        out.append(np.concatenate([box, cls], -1))
    return out


def _scene(rng, B, K, chain=False):
    if chain:  # box i overlaps i+1 (IoU 9/17) and i+2 little (5/21): keeps alternate, holes flip the parity
        x = np.arange(K, dtype=np.float32) * 4.0
        boxes = np.broadcast_to(np.stack([x, np.zeros(K), x + 13.0, np.full(K, 10.0)], 1), (B, K, 4))
        return np.ascontiguousarray(boxes, np.float32), rng.uniform(size=(B, K)) > 0.05
    c = rng.uniform(20, 600, (B, K, 2))
    wh = rng.uniform(10, 120, (B, K, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32), rng.uniform(size=(B, K)) > 0.1


def _oracle_keep(iou, valid, thr):
    """Sequential greedy over one image's IoU matrix (numpy)."""
    keep = valid.copy()
    for i in range(len(keep)):
        if keep[i]:
            keep[i + 1:] &= ~(iou[i, i + 1:] > np.float32(thr))
    return keep


@pytest.mark.parametrize("chain", [False, True], ids=["crowded", "chain"])
@pytest.mark.parametrize("k", [1, 63, 65, 128, 300])
def test_keep_matches_pallas_scan_and_oracle(k, chain):
    """Boxes in: the keep equals the Pallas kernel on JAX's IoU of the same boxes, _greedy_keep and the oracle."""
    rng = np.random.default_rng(k + chain)
    boxes, valid = _scene(rng, 2, k, chain)
    thr = 0.4 if chain else 0.45
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))
    jiou = np.stack([np.asarray(jax_box_iou(jnp.asarray(b), jnp.asarray(b))) for b in boxes])
    np.testing.assert_array_equal(iou.numpy(), jiou)  # same IoU bits
    got = greedy_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    pallas = np.asarray(greedy_nms_keep_pallas(jnp.asarray(jiou), jnp.asarray(valid), thr, interpret=True)) > 0
    np.testing.assert_array_equal(got, pallas)
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jnms._greedy_keep(jnp.asarray(boxes[b]),
                                                                           jnp.asarray(valid[b]), thr)))
        np.testing.assert_array_equal(got[b], _oracle_keep(jiou[b], valid[b], thr))
    if k >= 128:
        assert 2 < got.sum() < valid.sum()
    elif k > 1:  # the ragged sizes still suppress something
        assert 0 < got.sum() < valid.sum()


def test_keep_wrapper_routes_by_device():
    """A CPU tensor runs the plain version without touching the launch count."""
    rng = np.random.default_rng(0)
    boxes, valid = _scene(rng, 1, 64)
    bx, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    before = greedy_nms_keep.launches
    assert torch.equal(greedy_nms_keep(bx, v, 0.5), greedy_nms_keep_plain(bx, v, 0.5))
    assert greedy_nms_keep.launches == before
    with pytest.raises(ValueError):
        greedy_nms_keep(bx.to("meta"), v.to("meta"), 0.5)


def _word_scan_model(iou, valid, thr, rng):
    """numpy model of csrc/greedy_nms_keep.cu on one image: phase A's ballots, phase B's word scan.

    Phase A: a warp's ballot over the 32 columns of half-word c of row i packs
    (j > i) & (j < K) & (iou > thr), lane l to bit l; row i writes its
    half-words from the word that holds i to the end, and every other
    half-word holds random garbage here, so a scan that read one would show.
    Phase B: the removed words start as ~valid plus the ragged tail; word w
    resolves its rows from the lowest not-removed one up, OR-ing in each kept
    row's diagonal word, and every later word ORs in that row's own word.
    """
    k = len(valid)
    words = (k + 63) // 64
    full = (1 << 64) - 1
    hit = np.zeros((k, 64 * words), bool)
    hit[:, :k] = iou > np.float32(thr)
    hit &= np.arange(64 * words)[None, :] > np.arange(k)[:, None]
    ballots = (hit.reshape(k, 2 * words, 32) * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1)
    sup32 = rng.integers(0, 2 ** 32, (k, 2 * words), dtype=np.uint64)
    for i in range(k):
        sup32[i, 2 * (i // 64):] = ballots[i, 2 * (i // 64):]
    sup = [[int(r[2 * w]) | int(r[2 * w + 1]) << 32 for w in range(words)] for r in sup32]

    gone = np.ones(64 * words, bool)
    gone[:k] = ~valid
    removed = [sum(1 << t for t in range(64) if gone[64 * w + t]) for w in range(words)]
    kept_words = []
    for w in range(words):
        rw, kept = removed[w], 0
        cand = ~rw & full
        while cand:
            t = (cand & -cand).bit_length() - 1  # the lowest not-removed row of the word
            row = sup[64 * w + t]
            rw |= row[w]
            for lane in range(w + 1, words):
                removed[lane] |= row[lane]
            kept |= 1 << t
            cand = ~rw & full & ~((2 << t) - 1)
        kept_words.append(kept)
    return np.array([(kept_words[j // 64] >> (j % 64)) & 1 for j in range(k)], bool)


@pytest.mark.parametrize("chain", [False, True], ids=["crowded", "chain"])
@pytest.mark.parametrize("k", [1, 31, 63, 64, 65, 300, 512, 1024])
def test_bitmask_word_scan_model(k, chain):
    """The kernel's two phases, modelled in numpy, give the sequential greedy keep on every K."""
    rng = np.random.default_rng(200 + k + chain)
    boxes, valid = _scene(rng, 2, k, chain)
    thr = 0.4 if chain else 0.45
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    want = np.stack([_oracle_keep(iou[b], valid[b], thr) for b in range(2)])
    for b in range(2):
        np.testing.assert_array_equal(_word_scan_model(iou[b], valid[b], thr, rng), want[b])
    if k > 1:
        assert 0 < want.sum() < valid.sum()


def _jax_select(feats, nc, conf, k, class_mask=None, multi_label=False):
    """Reference selection: one lax.top_k over all levels' gated sigmoid scores."""
    s_all, c_all = [], []
    for f in feats:
        s = jax.nn.sigmoid(jnp.asarray(f[..., 64:]))
        if class_mask is not None:
            s = jnp.where(jnp.asarray(class_mask), s, 0.0)
        s_all.append(s.reshape(s.shape[0], -1) if multi_label else jnp.max(s, -1).reshape(s.shape[0], -1))
        c_all.append(jnp.argmax(s, -1).reshape(s.shape[0], -1))
    s = jnp.concatenate(s_all, 1)
    vals, idx = jax.lax.top_k(jnp.where(s > conf, s, -1.0), min(k, s.shape[1]))
    if multi_label:
        return np.asarray(vals), np.asarray(idx // nc), np.asarray(idx % nc)
    return np.asarray(vals), np.asarray(idx), np.asarray(jnp.take_along_axis(jnp.concatenate(c_all, 1), idx, 1))


CASES = {  # name: (multi_label, agnostic, use class mask, distinct logit values or None)
    "single": (False, False, False, None),
    "agnostic": (False, True, False, None),
    "classes": (False, False, True, None),
    "ties": (False, False, False, 4),
    "multi": (True, False, False, None),
    "multi-ties": (True, True, True, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nms_from_feats_matches_jax(case):
    ml, agnostic, use_mask, n_values = CASES[case]
    nc = 5
    rng = np.random.default_rng(sorted(CASES).index(case))
    feats = _feats(rng, nc=nc, n_values=n_values)
    mask = np.array([True, False, True, True, False]) if use_mask else None
    kw = dict(conf_thres=0.01, iou_thres=0.5, max_det=100, max_cand=300, agnostic=agnostic, multi_label=ml)
    tfeats = [torch.from_numpy(f) for f in feats]
    tmask = torch.from_numpy(mask) if use_mask else None

    # 1-2: candidates, their order and classes: bit-equal to one lax.top_k
    vals, bidx, cls = tnms.select_from_feats(tfeats, nc, 16, 0.01, 300, tmask, multi_label=ml)
    jvals, jbidx, jcls = _jax_select(feats, nc, 0.01, 300, mask, ml)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(bidx.numpy(), jbidx)
    np.testing.assert_array_equal(cls.numpy(), jcls.astype(np.float32))

    # 5: keep masks on identical class-offset boxes
    shifted = rng.uniform(0, 200, (2, 300, 4)).astype(np.float32)
    shifted[..., 2:] += shifted[..., :2] + 10
    valid = rng.uniform(size=(2, 300)) > 0.2
    np.testing.assert_array_equal(
        tnms._exact_keep(torch.from_numpy(shifted), torch.from_numpy(valid), 0.5).numpy(),
        np.asarray(jnms._fixpoint_keep(jnp.asarray(shifted), jnp.asarray(valid), 0.5)))

    # end to end
    got = tnms.nms_from_feats(tfeats, STRIDES, nc, 16, class_mask=tmask, **kw).numpy()
    want = np.asarray(jnms.nms_from_feats([jnp.asarray(f) for f in feats], STRIDES, nc, 16,
                                          class_mask=jnp.asarray(mask) if use_mask else None, **kw))
    assert got.shape == want.shape == (2, 100, 6)
    np.testing.assert_array_equal((got[..., 4] > 0).sum(1), (want[..., 4] > 0).sum(1))
    assert (got[..., 4] > 0).sum() > 20
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])  # scores and classes, row by row
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=BOX_RTOL, atol=BOX_ATOL)
    if use_mask:
        assert set(np.unique(got[..., 5][got[..., 4] > 0]).astype(int)) <= {0, 2, 3}


@pytest.mark.parametrize("mode", ["greedy", "pallas", "fast"])
@pytest.mark.parametrize("multi_label", [False, True], ids=["single", "multi"])
def test_non_max_suppression_matches_jax(mode, multi_label):
    """Same boxes and scores in: the same padded detections out, bit for bit.

    The JAX package's 'pallas' mode compiles its kernel for a TPU only, so the
    port's 'pallas' mode is held to JAX 'greedy', which tests/test_ops.py and
    tests/test_pallas.py prove bit-identical to it (and the keep kernel itself
    to the Pallas kernel in interpret mode above).
    """
    rng = np.random.default_rng(11)
    B, A, nc = 2, 400, 4
    boxes, _ = _scene(rng, B, A)
    scores = np.array(jax.nn.sigmoid(jnp.asarray(_safe_grid()[rng.integers(0, 90, (B, A, nc))])))
    kw = dict(conf_thres=0.05, iou_thres=0.45, max_det=150, max_cand=512, multi_label=multi_label)
    got = tnms.non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), mode=mode, **kw).numpy()
    want = np.asarray(jnms.non_max_suppression(jnp.asarray(boxes), jnp.asarray(scores),
                                               mode="greedy" if mode == "pallas" else mode, **kw))
    assert (got[..., 4] > 0).sum() > 20
    np.testing.assert_array_equal(got, want)


def test_blocked_keep_k2048_matches_jax():
    """K = 2048 candidates run as two score-ordered blocks of 1024; the result is exact greedy."""
    rng = np.random.default_rng(12)
    B, A, nc = 2, 800, 3
    boxes, _ = _scene(rng, B, A)
    scores = np.array(jax.nn.sigmoid(jnp.asarray(_safe_grid()[rng.integers(40, 100, (B, A, nc))])))
    kw = dict(conf_thres=0.01, iou_thres=0.5, max_det=300, max_cand=2048, multi_label=True)
    got = tnms.non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), **kw).numpy()
    want = np.asarray(jnms.non_max_suppression(jnp.asarray(boxes), jnp.asarray(scores), **kw))
    np.testing.assert_array_equal(got, want)
    # and the blocked keep equals one exact keep over all 2048
    vals, cand, cls, valid = tnms._select_candidates(torch.from_numpy(boxes), torch.from_numpy(scores),
                                                     0.01, 2048, True, None)
    shifted = cand + cls[..., None] * tnms.MAX_WH
    assert valid.shape == (B, 2048)
    assert torch.equal(tnms._blocked_keep(shifted, valid, 0.5), tnms._fixpoint_keep(shifted, valid, 0.5))


def test_decode_and_end2end_match_jax():
    rng = np.random.default_rng(13)
    feats = _feats(rng, nc=5)
    tfeats = [torch.from_numpy(f) for f in feats]
    jfeats = [jnp.asarray(f) for f in feats]
    boxes, scores = decode_detections(tfeats, STRIDES, 5)
    jb, js = jax_decode(jfeats, STRIDES, 5)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=BOX_RTOL, atol=BOX_ATOL)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(js))
    got = postprocess_end2end(tfeats, STRIDES, 5, max_det=50, conf_thres=0.02).numpy()
    want = np.asarray(jax_e2e(jfeats, STRIDES, 5, max_det=50, conf_thres=0.02))
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=BOX_RTOL, atol=BOX_ATOL)


def test_dfl_side_underflow_is_finite():
    """A side far below another side's logits keeps a finite expectation (per-side max shift)."""
    from yololite_tpu_torch.ops.decode import dfl_expectation_mm

    x = torch.zeros(1, 1, 64)
    x[..., :16] = -200.0
    x[..., 16:32] = 200.0
    x[..., 20] = 210.0
    d = dfl_expectation_mm(x)
    assert torch.isfinite(d).all()
    assert d[0, 0, 0].item() == pytest.approx(7.5)  # a flat side: the mean bin
    assert d[0, 0, 1].item() == pytest.approx((116 + 4 * np.exp(10.0)) / (15 + np.exp(10.0)), rel=1e-6)
