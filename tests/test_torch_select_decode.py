"""K3 (select + DFL decode) and K2 (the letterbox) on the CPU: their plain versions against the JAX package.

`select_decode_plain` is held bit for bit to one lax.top_k over the JAX
package's gated sigmoid scores (vals, anchor indices, classes, in order) and
its boxes to the JAX decode within the parity tolerance of test_torch_nms.py;
the class-offset boxes and valid follow from them exactly. The maps come as
NHWC views of NCHW tensors where the card passes them so. `device_letterbox`
with bgr=True on a BGR batch equals JAX's device_letterbox on the RGB batch.
The ops pass `torch.library.opcheck`, CPU tensors never load the CUDA
builder, and the validator hands the NMS its maps without an fp32 copy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.ops.decode import decode_detections as jax_decode
from yololite_tpu.ops.pallas_kernels import device_letterbox as jax_device_letterbox

from test_torch_nms import BOX_ATOL, BOX_RTOL, STRIDES, _feats, _jax_select
from yololite_tpu_torch.ops import cuda_build, kernels as K, nms as tnms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one CPU thread beside XLA (see test_torch_nms.py: a worker's first parallel exp was seen off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RECT = ((12, 20), (6, 10), (3, 5))  # rect levels at strides 8, 16, 32

CASES = {  # name: (multi_label, agnostic, class mask, distinct logit values or None, max_cand, nc, NCHW views, NaN)
    "single": (False, False, False, None, 100, 5, False, False),
    "multi": (True, False, False, None, 300, 5, False, False),
    "nhwc-views": (True, False, False, None, 300, 5, True, False),
    "nhwc-views-single": (False, True, False, None, 64, 5, True, False),
    "k-ge-n": (False, False, False, None, 10_000, 5, False, False),
    "k-ge-n-multi": (True, False, False, None, 2000, 5, True, False),
    "nc1-multi": (True, False, False, None, 50, 1, False, False),
    "class-mask": (False, False, True, None, 100, 5, False, False),
    "class-mask-multi": (True, False, True, None, 200, 5, True, False),
    "ties": (False, False, False, 3, 120, 5, False, False),
    "ties-multi": (True, True, False, 2, 400, 5, False, False),
    "nan": (False, False, False, None, 150, 5, False, True),
    "nan-multi": (True, False, False, None, 300, 5, True, True),
    "agnostic": (False, True, False, None, 100, 5, False, False),
}


def _case_inputs(case):
    ml, agnostic, use_mask, n_values, max_cand, nc, nchw, nan = CASES[case]
    rng = np.random.default_rng(100 + sorted(CASES).index(case))
    feats = _feats(rng, B=2, shapes=RECT, nc=nc, n_values=n_values)
    if nan:  # NaN class logits on some anchors (every class of one, one class of others), NaN box logits on one
        feats[0][0, 1, 2, 64:] = np.nan
        feats[1][1, 0, 3, 64 + nc - 1] = np.nan
        feats[2][0, 2, 4, 64 + nc // 2] = np.nan
        feats[0][1, 3, 3, 5] = np.nan
    mask = (np.arange(nc) % 2 == 0) if use_mask else None
    if nchw:  # NHWC views of NCHW tensors, as the net's outputs reach the NMS
        tfeats = [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1) for f in feats]
    else:
        tfeats = [torch.from_numpy(f) for f in feats]
    return feats, tfeats, mask, dict(ml=ml, agnostic=agnostic, max_cand=max_cand, nc=nc)


@pytest.mark.parametrize("case", list(CASES))
def test_select_decode_plain_matches_jax(case):
    feats, tfeats, mask, c = _case_inputs(case)
    nc, conf = c["nc"], 0.01
    tmask = None if mask is None else torch.from_numpy(mask)
    vals, bidx, cls, boxes, shifted, valid = K.select_decode_plain(
        tfeats, STRIDES, nc, 16, conf, c["max_cand"], tmask, multi_label=c["ml"], agnostic=c["agnostic"])
    ml = c["ml"] and nc > 1
    n = sum(h * w for h, w in RECT) * (nc if ml else 1)
    k = min(c["max_cand"], n)
    assert vals.shape == bidx.shape == cls.shape == valid.shape == (2, k) and boxes.shape == shifted.shape == (2, k, 4)
    assert (vals.dtype, bidx.dtype, cls.dtype, boxes.dtype, valid.dtype) == (
        torch.float32, torch.int64, torch.float32, torch.float32, torch.bool)

    # 1-2: the candidates, their order and classes: bit-equal to one lax.top_k (fillers of -1 included)
    jvals, jbidx, jcls = _jax_select(feats, nc, conf, c["max_cand"], mask, ml)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(bidx.numpy(), jbidx)
    np.testing.assert_array_equal(cls.numpy(), jcls.astype(np.float32))
    if k == n:
        assert (vals == -1).any()  # every entry selected, the gated ones as -1 fillers

    # 3-4: the candidates' boxes against the JAX decode of every anchor
    jboxes, _ = jax_decode([jnp.asarray(f) for f in feats], STRIDES, nc, 16, xywh=False)
    want = np.take_along_axis(np.asarray(jboxes), jbidx[..., None], 1)
    np.testing.assert_allclose(boxes.numpy(), want, rtol=BOX_RTOL, atol=BOX_ATOL)
    offset = torch.zeros_like(cls) if c["agnostic"] else cls * K.MAX_WH
    assert torch.equal(shifted, boxes + offset[..., None])
    assert torch.equal(valid, vals > conf)
    if CASES[case][7]:  # the NaN case: the NaN anchors are gated out, and a NaN box logit gives NaN boxes
        assert torch.isfinite(vals).all()
    else:
        assert torch.isfinite(boxes).all()


@pytest.mark.parametrize("case", ["single", "multi", "nhwc-views", "class-mask", "nan-multi"])
def test_select_decode_op_is_the_plain_version(case):
    """On CPU tensors the op and the wrapper return the plain version's tensors, and select_from_feats and
    nms_from_feats are built on it."""
    _, tfeats, mask, c = _case_inputs(case)
    tmask = None if mask is None else torch.from_numpy(mask)
    args = (tfeats, STRIDES, c["nc"], 16, 0.01, c["max_cand"], tmask, False, c["ml"], c["agnostic"])
    want = K.select_decode_plain(*args)
    before, by_route = K.select_decode.launches, K.select_decode.by_route.as_dict()
    for got in (K.select_decode(*args), torch.ops.yololite_tpu_torch.select_decode(*args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert K.select_decode.launches == before  # the counters count card launches only
    assert K.select_decode.by_route.as_dict() == by_route
    vals, bidx, cls = tnms.select_from_feats(tfeats, c["nc"], 16, 0.01, c["max_cand"], tmask,
                                             multi_label=c["ml"])
    assert torch.equal(vals, want[0]) and torch.equal(bidx, want[1]) and torch.equal(cls, want[2])


def test_route_counts_follow_graph_replays_and_routes_are_named():
    """K3's launches by route are Python counters that a replayed CUDA graph advances (engine/graphs.py COUNTERS),
    one a route of SELECT_ROUTES; a route to run is "plan" or one of those names, anything else raises before any
    library is loaded."""
    from yololite_tpu_torch.engine.graphs import COUNTERS

    assert K.SELECT_ROUTES == ("passes", "finish", "cluster")
    assert all((K.select_decode.by_route, r) in COUNTERS for r in K.SELECT_ROUTES)
    assert (K.select_decode, "launches") in COUNTERS
    assert [K._route_code(r) for r in ("plan", *K.SELECT_ROUTES)] == [-1, 0, 1, 2]
    counts = K._RouteCounts()
    counts.cluster, counts.finish = 2, 5
    counts.reset()  # a window whose launches are read starts from 0 on every route
    assert counts.as_dict() == dict.fromkeys(K.SELECT_ROUTES, 0)
    with pytest.raises(ValueError):
        K._route_code("sorted")


def test_select_from_feats_keeps_the_scores_dtype():
    """With half, bf16 maps give bf16 scores (the plain sigmoid's dtype), exact through the op's fp32 vals."""
    _, tfeats, _, _ = _case_inputs("multi")
    bf = [f.to(torch.bfloat16) for f in tfeats]
    vals, bidx, cls = tnms.select_from_feats(bf, 5, 16, 0.01, 300, half=True, multi_label=True)
    s = torch.cat([torch.sigmoid(f[..., 64:]).reshape(2, -1) for f in bf], 1)
    want, idx = K.topk_stable(torch.where(s > 0.01, s, -1.0), 300)
    assert vals.dtype == torch.bfloat16 and torch.equal(vals, want) and torch.equal(bidx, idx // 5)


@pytest.mark.parametrize("conf", [0.001, 0.01, 0.0123, 0.25, 0.3001, 0.7])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "fp16", "fp32"])
def test_gate_threshold_rounds_as_torch_compares(conf, dtype):
    """The gate the kernel gets (`_gate_threshold`: the Python float rounded to the scores' dtype) decides every
    score of that dtype in [0, 1] as torch's `s > conf` does."""
    if dtype == torch.float32:
        s = torch.linspace(0, 1, 200_001, dtype=torch.float32)
        s = torch.cat([s, torch.nextafter(torch.tensor([conf], dtype=torch.float32), torch.tensor([2.0])),
                       torch.tensor([conf], dtype=torch.float32)])
    else:  # every finite value of the type in [0, 1]
        bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
        s = bits.view(dtype)
        s = s[(s >= 0) & (s <= 1)]
    thr = K._gate_threshold(conf, dtype)
    assert torch.equal(s.float() > thr, s > conf)


def test_select_decode_op_passes_opcheck():
    _, tfeats, mask, c = _case_inputs("class-mask-multi")
    tfeats = [f.contiguous() for f in tfeats]  # opcheck's checks clone the inputs: views as contiguous maps
    for args in ((tfeats, STRIDES, 5, 16, 0.01, 200, torch.from_numpy(mask), False, True, False),
                 (tfeats, STRIDES, 5, 16, 0.01, 64, None, False, False, True)):
        torch.library.opcheck(torch.ops.yololite_tpu_torch.select_decode.default, args)


@pytest.mark.parametrize("shape", [(480, 640), (720, 1280), (333, 517), (100, 120)])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_device_letterbox_bgr_matches_jax_on_rgb(shape, channels_last):
    """K2's plain version, fed BGR with bgr=True, equals JAX's device_letterbox on the RGB batch (the pad bit for
    bit, the rest within 1e-5), in either storage layout; without bgr it equals itself on the RGB batch."""
    rng = np.random.default_rng(shape[0])
    rgb = rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    got = K.device_letterbox(torch.from_numpy(bgr), 320, bgr=True, channels_last=channels_last)
    assert got.shape == (2, 320, 320, 3) and got.dtype == torch.float32
    if channels_last:
        assert got.is_contiguous()
    else:  # the NHWC view of NCHW storage: permuted back, the net gets an NCHW-contiguous tensor
        assert got.permute(0, 3, 1, 2).is_contiguous()
    want = np.asarray(jax_device_letterbox(jnp.asarray(rgb), imgsz=320))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    new_h, new_w, top, left = K.letterbox_geometry(*shape, 320)
    pad = np.ones((320, 320), bool)
    pad[top:top + new_h, left:left + new_w] = False
    np.testing.assert_array_equal(got.numpy()[:, pad], want[:, pad])
    same = K.device_letterbox(torch.from_numpy(rgb), 320, channels_last=channels_last)
    assert torch.equal(same, got)


def test_device_letterbox_op_passes_opcheck():
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (2, 30, 40, 3), dtype=np.uint8))
    for dtype in (torch.float32, torch.bfloat16):
        for bgr in (False, True):
            for cl in (False, True):
                torch.library.opcheck(torch.ops.yololite_tpu_torch.device_letterbox.default,
                                      (images, 48, dtype, bgr, cl))


def test_cpu_tensors_never_load_the_cuda_builder(monkeypatch):
    """A CPU tensor goes to the plain versions: the builder (nvcc, the libraries) is never reached."""
    def refuse(name):
        raise AssertionError(f"cuda_build.load({name!r}) on CPU tensors")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    _, tfeats, _, _ = _case_inputs("nhwc-views")
    K.select_decode(tfeats, STRIDES, 5, 16, 0.01, 300, None, False, True, False)
    out = tnms.nms_from_feats(tfeats, STRIDES, 5, 16, conf_thres=0.01, max_cand=300, multi_label=True)
    assert out.shape == (2, 300, 6)
    raw = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 30, 40, 3), dtype=np.uint8))
    K.device_letterbox(raw, 64, bgr=True, channels_last=False)


def test_wrappers_refuse_what_they_do_not_take():
    _, tfeats, _, _ = _case_inputs("single")
    with pytest.raises(ValueError):
        K.select_decode(tfeats, STRIDES, 5, 16, 0.01, -1)
    with pytest.raises(ValueError):
        K.select_decode(tfeats, STRIDES[:2], 5, 16, 0.01, 10)
    with pytest.raises(TypeError):
        K.device_letterbox(torch.zeros((1, 8, 8, 3)), 16)
    with pytest.raises(TypeError):
        K.device_letterbox(torch.zeros((1, 8, 8, 4), dtype=torch.uint8), 16)
    with pytest.raises(ValueError):
        K.device_letterbox(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), 16, torch.int8)


def test_stream_uploads_bgr_and_letterboxes_with_bgr(monkeypatch):
    """The predictor's stream loop uploads the BGR frames as they are and calls infer_uint8 with bgr=True, which
    equals the RGB batch without it; bgr is part of the step's graph key."""
    from yololite_tpu_torch import YOLOLite
    from test_torch_graphs import NARROW

    m = YOLOLite(NARROW, device="cpu")
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (64, 96, 3), np.uint8) for _ in range(2)]
    kw = dict(conf=1e-7, imgsz=64, batch=2, save=False, verbose=False)
    m.predict(frames, **kw)
    pred = m.predictor
    calls = []
    real = pred.infer_uint8
    monkeypatch.setattr(pred, "infer_uint8", lambda raw, imgsz, bgr=False: calls.append((raw, bgr)) or real(
        raw, imgsz, bgr))
    results = m.predict(frames, **kw)
    (raw, bgr), = calls
    assert bgr and np.array_equal(raw.numpy(), np.stack(frames))  # BGR, as read
    got = real(raw, 64, bgr=True)
    want = real(raw.flip(-1).contiguous(), 64)
    assert torch.equal(got, want) and len(results) == 2


def test_validator_hands_bf16_maps_to_the_nms_without_a_copy(monkeypatch, tmp_path):
    """Half-precision val passes the net's bf16 maps to nms_from_feats as they are, with the metrics and detections
    of the fp32 copy it used to make."""
    from yololite_tpu_torch.engine import validator as V
    from yololite_tpu_torch.models.model import DetectionModel
    from test_torch_graphs import NARROW
    from test_torch_val import _write_dataset

    data = _write_dataset(tmp_path / "data", [(64, 80), (80, 64), (64, 64), (72, 96)], seed=5)
    seen = []
    real = V.nms_from_feats

    def spy(feats, *a, **kw):
        seen.append([f.dtype for f in feats])
        got = real(feats, *a, **kw)
        assert torch.equal(got, real([f.float() for f in feats], *a, **kw))
        return got

    monkeypatch.setattr(V, "nms_from_feats", spy)
    model = DetectionModel(NARROW).init(0)
    args = dict(data=str(data), imgsz=64, batch=2, conf=1e-7, mode="val", half=True, plots=False, workers=0)
    v = V.DetectionValidator(save_dir=tmp_path / "v", args=args, device="cpu")
    v(model=model)
    assert v.seen == 4 and len(seen) == 2 and all(d == [torch.bfloat16] * 3 for d in seen)


# ---------------- a numpy model of K3's finishing kernel ----------------

FINISH_CAP, FINISH_THREADS, DIGIT, MAX_SMEM, TIE_CAP, RANK_CAP = 16384, 512, 11, 232448, 4096, 2048  # the .cu's


def _order_keys(gated):
    """The kernel's 32-bit order keys of fp32 scores: a larger float, a larger key."""
    u = np.ascontiguousarray(gated, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _key_values(keys):
    k = keys.astype(np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def _finish_bin(hist, need, threads=FINISH_THREADS):
    """finish_bin: `threads` threads sum runs of bins from the top, a scan finds the one whose run reaches need;
    returns (bin, what the bin still has to give)."""
    nb = len(hist)
    per = -(-nb // threads)
    found = []
    incl = 0
    for t in range(threads):
        top = nb - 1 - t * per
        run = [top - j for j in range(per) if top - j >= 0]
        total = int(sum(hist[i] for i in run))
        incl += total
        if incl - total < need <= incl:
            cum = incl - total
            for b in run:
                if cum + hist[b] >= need:
                    break
                cum += hist[b]
            found.append((b, need - cum))
    assert len(found) == 1  # one thread exactly
    return found[0]


def _bitonic_desc(s):
    """The kernel's bitonic sort of its p2 slots, descending: step (k, j) compares slot i with i | j."""
    p2 = len(s)
    k = 2
    while k <= p2:
        j = k >> 1
        while j:
            q = np.arange(p2 // 2)
            i = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            x, y = s[i].copy(), s[i | j].copy()
            swap = (x < y) == ((i & k) == 0)
            s[i[swap]], s[(i | j)[swap]] = y[swap], x[swap]
            j >>= 1
        k <<= 1
    return s


def _finish_model(keys, flat, k):
    """One image through the finishing kernel's select: keys (N,) in storage order, flat (N,) each one's flat
    index. The composite (key << ib) | (N - 1 - index); the first digit (the key's top 11 bits) counted over the
    row and the K-th entry's bin b0 found; where more than RANK_CAP entries lie at or above b0, b0's entries
    counted by the next 11 bits and the K-th entry's bin b1 found there. Where the candidates (above b0, and b0's
    at or above b1) number at most RANK_CAP, each one's count of larger ones is its output row. Else the entries
    above b0 taken, b0's listed (up to TIE_CAP, else the row is scanned); the later 11-bit digits over the entries
    whose decided bits match; b0's entries at or above the threshold taken; the winners bitonic-sorted. Returns
    the K composites in order and the ib."""
    n = len(keys)
    ib = max(int(n - 1).bit_length(), 1)
    total = 32 + ib
    comp = (keys.astype(np.uint64) << np.uint64(ib)) | (n - 1 - flat).astype(np.uint64)
    hist0 = np.bincount((keys >> 21).astype(np.int64), minlength=1 << DIGIT)
    b0, need = _finish_bin(hist0, k)
    listed = comp[(keys >> 21) >= b0]
    assert len(listed) == k - need + hist0[b0]
    if len(listed) > RANK_CAP:  # the second digit (key bits 10-20) of b0's entries
        d1 = (keys >> 10) & 2047
        hist1 = np.bincount(d1[keys >> 21 == b0].astype(np.int64), minlength=1 << DIGIT)
        b1, need1 = _finish_bin(hist1, need)
        listed = comp[((keys >> 21) > b0) | ((keys >> 21 == b0) & (d1 >= b1))]
        assert len(listed) == k - need1 + hist1[b1]
    if len(listed) <= RANK_CAP:  # the rank route: a listed entry's count of larger ones is its output row
        above = (listed[None, :] > listed[:, None]).sum(1)
        rows = np.zeros(k, np.uint64)
        assert len(set(above[above < k])) == k  # every row once
        rows[above[above < k]] = listed[above < k]
        return rows, ib
    prefix, lo = b0 << (total - DIGIT), total - DIGIT
    done = int((keys >> 21 == b0).sum()) == need
    above = comp[(keys >> 21) > b0]
    ties = np.nonzero(keys >> 21 == b0)[0]
    span = comp[ties] if len(ties) <= TIE_CAP else comp  # the list, or the row (the prefix filters it)
    hi = lo
    while not done:
        lo = max(hi - DIGIT, 0)
        nb = 1 << (hi - lo)
        match = (span >> np.uint64(hi)) == np.uint64(prefix >> hi)
        hist = np.bincount(((span[match] >> np.uint64(lo)) & np.uint64(nb - 1)).astype(np.int64), minlength=nb)
        b, left = _finish_bin(hist, need)
        prefix |= b << lo
        need = left
        done = hist[b] == left or lo == 0
        hi = lo
    win = np.concatenate([above, comp[ties][comp[ties] >= np.uint64(prefix)]])
    assert len(win) == k and (np.sort(win) == np.sort(comp[comp >= np.uint64(prefix)])).all()
    p2 = 1 << max(k - 1, 0).bit_length()
    assert _finish_smem(n, p2) <= MAX_SMEM - 1024  # keys, histogram, winners, tie list (and the static part)
    s = np.zeros(p2, np.uint64)
    s[:k] = win
    s = _bitonic_desc(s)
    assert (np.diff(s[:k].astype(np.float64)) < 0).all() and (s[k:] == 0).all()
    return s[:k], ib


def _finish_smem(n, p2):
    return -(-n // 4) * 4 * 4 + (1 << DIGIT) * 4 + p2 * 8 + TIE_CAP * 2 + RANK_CAP * 8


def _gated_rows(tfeats, nc, conf, mask, ml):
    """The plain version's gated score rows (B, N) as fp32 numpy, in the flat index order."""
    rows = []
    for f in tfeats:
        s = torch.sigmoid(f[..., 64:].float())
        if mask is not None:
            s = torch.where(torch.from_numpy(mask), s, 0.0)
        rows.append(s.reshape(f.shape[0], -1) if ml else s.amax(-1).reshape(f.shape[0], -1))
    s = torch.cat(rows, 1)
    return torch.where(s > conf, s, -1.0).numpy()


def _class_major_flat(shapes, nc):
    """The flat index of each position of a multi-label row stored class-major (NCHW planes: level, class,
    anchor), as the kernel's flat_index maps it."""
    out, off = [], 0
    for h, w in shapes:
        local = np.arange(h * w)
        out.append(((off + local)[None, :] * nc + np.arange(nc)[:, None]).reshape(-1))
        off += h * w
    return np.concatenate(out)


@pytest.mark.parametrize("case", ["single", "multi", "nhwc-views", "k-ge-n", "k-ge-n-multi", "class-mask",
                                  "class-mask-multi", "ties", "ties-multi", "nan", "nan-multi", "nc1-multi"])
def test_finish_select_model_matches_plain_and_top_k(case):
    """The finishing kernel's select, modelled in numpy on the gated rows, gives the plain version's candidates
    (values bit for bit, indices, classes) and lax.top_k's; class-major storage (NCHW views) holds the same
    composites as the flat order."""
    feats, tfeats, mask, c = _case_inputs(case)
    nc = c["nc"]
    ml = c["ml"] and nc > 1
    tmask = None if mask is None else torch.from_numpy(mask)
    vals, bidx, cls = K.select_decode_plain(tfeats, STRIDES, nc, 16, 0.01, c["max_cand"], tmask,
                                            multi_label=c["ml"])[:3]
    gated = _gated_rows(tfeats, nc, 0.01, mask, ml)
    n = gated.shape[1]
    assert n <= FINISH_CAP
    k = min(c["max_cand"], n)
    jv, ji = jax.lax.top_k(jnp.asarray(gated), k)
    for i in range(gated.shape[0]):
        keys = _order_keys(gated[i])
        flat = np.arange(n)
        if ml and CASES[case][6]:  # stored class-major: the same composites, read in another order
            storage = _class_major_flat(RECT, nc)  # the flat index of each storage position
            assert np.array_equal(np.sort(storage), flat)
            keys, flat = keys[storage], storage
        comp, ib = _finish_model(keys, flat, k)
        idx = (n - 1 - (comp & np.uint64((1 << ib) - 1)).astype(np.int64))
        got_vals = _key_values((comp >> np.uint64(ib)).astype(np.uint32))
        np.testing.assert_array_equal(got_vals.view(np.uint32), vals[i].numpy().view(np.uint32))
        np.testing.assert_array_equal(idx, (bidx[i] * nc + cls[i].long() if ml else bidx[i]).numpy())
        np.testing.assert_array_equal(idx, np.asarray(ji[i]))
        np.testing.assert_array_equal(got_vals, np.asarray(jv[i]))


def test_finish_select_model_takes_a_second_digit_where_the_first_crowds():
    """Scores crowded into one quarter binade (the first digit, the key's top 11 bits, holds some 8,000 entries: a
    max over 80 classes of logits 3 N(0, 1) - 4, as chip_smoke.py's predict maps): the second digit narrows the
    candidates under RANK_CAP, and the model still equals the plain version and lax.top_k."""
    rng = np.random.default_rng(7)
    shapes = ((80, 80), (40, 40), (20, 20))
    feats = _feats(rng, B=1, shapes=shapes, nc=80)
    for f in feats:
        f[..., 64:] = rng.standard_normal(f[..., 64:].shape).astype(np.float32) * 3.0 - 4.0
    tfeats = [torch.from_numpy(f) for f in feats]
    vals, bidx = K.select_decode_plain(tfeats, STRIDES, 80, 16, 1e-7, 512)[:2]
    gated = _gated_rows(tfeats, 80, 1e-7, None, False)
    keys = _order_keys(gated[0])
    hist0 = np.bincount((keys >> 21).astype(np.int64), minlength=1 << DIGIT)
    b0, need = _finish_bin(hist0, 512)
    assert 512 - need + hist0[b0] > RANK_CAP  # the first digit alone leaves too many candidates
    comp, ib = _finish_model(keys, np.arange(len(keys)), 512)
    idx = len(keys) - 1 - (comp & np.uint64((1 << ib) - 1)).astype(np.int64)
    np.testing.assert_array_equal(idx, bidx[0].numpy())
    np.testing.assert_array_equal(_key_values((comp >> np.uint64(ib)).astype(np.uint32)), vals[0].numpy())
    np.testing.assert_array_equal(idx, np.asarray(jax.lax.top_k(jnp.asarray(gated), 512)[1][0]))


@pytest.mark.parametrize("k", [512, 16384])
def test_finish_select_model_at_the_capacity(k):
    """A row of exactly FINISH_CAP entries (single-label, three distinct logit values: long runs of ties) with K
    512 and K = N (16,384 winners in 16,384 slots): the model equals lax.top_k and the plain version, and fits
    the kernel's shared memory."""
    shapes = ((120, 128), (30, 34), (2, 2))
    rng = np.random.default_rng(k)
    feats = _feats(rng, B=1, shapes=shapes, nc=3, n_values=3)
    tfeats = [torch.from_numpy(f) for f in feats]
    assert sum(h * w for h, w in shapes) == FINISH_CAP
    vals, bidx = K.select_decode_plain(tfeats, STRIDES, 3, 16, 0.01, k)[:2]
    gated = _gated_rows(tfeats, 3, 0.01, None, False)
    comp, ib = _finish_model(_order_keys(gated[0]), np.arange(FINISH_CAP), k)
    idx = FINISH_CAP - 1 - (comp & np.uint64((1 << ib) - 1)).astype(np.int64)
    np.testing.assert_array_equal(idx, bidx[0].numpy())
    np.testing.assert_array_equal(_key_values((comp >> np.uint64(ib)).astype(np.uint32)), vals[0].numpy())
    np.testing.assert_array_equal(idx, np.asarray(jax.lax.top_k(jnp.asarray(gated), k)[1][0]))


# ---------------- a numpy model of K3's cluster route ----------------

CLUSTER_THREADS, KEYS_A_THREAD, CLUSTER_MAX_K, SLACK, SORT_STEP_READS = 1024, 8, 8192, 4096, 16  # the .cu's


def _sort_descending(s):
    """sort_descending on s (any length n): a bitonic network over the 2^k >= n places whose every comparator puts
    the larger first (a merge's first stage pairs mirrored places), comparators that reach past n skipped."""
    n, p2 = len(s), 1
    while p2 < n:
        p2 <<= 1
    size = 2
    while size <= p2:
        stride = size >> 1
        while stride:
            i = np.arange(p2 // 2)
            lo = i // stride * 2 * stride + i % stride
            hi = lo - i % stride + 2 * stride - 1 - i % stride if stride == size >> 1 else lo + stride
            keep = hi < n
            lo, hi = lo[keep], hi[keep]
            x, y = s[lo].copy(), s[hi].copy()
            swap = x < y
            s[lo[swap]], s[hi[swap]] = y[swap], x[swap]
            stride >>= 1
        size <<= 1
    return s


def _sort_steps(n):
    """sort_descending's comparator steps a thread on n slots: log2(p2) (log2(p2) + 1) / 2 stages of p2 / 2
    comparators over CLUSTER_THREADS threads."""
    p2, lg = 1, 0
    while p2 < n:
        p2, lg = p2 * 2, lg + 1
    return lg * (lg + 1) // 2 * -(-(p2 // 2) // CLUSTER_THREADS)


def _cluster_model(keys, flat, k, clusters, tie_cap, class_major=False, slack=SLACK, sort_step_reads=SORT_STEP_READS):
    """One image through the cluster kernel, C = `clusters` CTAs: keys (N,) in storage order, flat (N,) each one's
    flat index. Each CTA's slice (a multiple of 8 entries) listed in row order: the composites above the first
    digit's bin b0 of the K-th entry, and the first tie_cap of those in it; the shared counts decide: every entry
    of b0 wins; or b0 holds one key in an index-ordered row (the shortcut: each CTA's first winners of the bin from
    a prefix count of the CTAs' ties); or the later digits from the CTAs' histograms summed (one key: from its index
    bits), a CTA whose tie list overflowed counting from its key slice, until the entries at or above the decided
    bits (the group) number at most K + slack. The group is ordered by the 11 bits below those all its entries
    share: the CTAs' histograms summed give each bucket its first place, each entry takes a slot of its bucket (after
    the CTAs below its own), each slot's entry goes to its bucket's first place plus its count of larger ones in the
    bucket (or, in a CTA whose counts would read more than sort_step_reads a thread for each of its sort's steps,
    to its CTA's first place plus its place in the CTA's sorted slots: " sorted" ends the branch), and places below
    K are rows; the shortcut's winners of the bin take rows K - need on, in their prefix
    count's order. Returns the K composites by row, ib and the branch taken. (The kernel's tie_cap is at least K +
    slack; the model takes smaller ones to reach the key slices.)"""
    n = len(keys)
    ib = max(int(n - 1).bit_length(), 1)
    lo0 = 32 + ib - DIGIT
    comp = (keys.astype(np.uint64) << np.uint64(ib)) | (n - 1 - flat).astype(np.uint64)
    bins = (keys >> 21).astype(np.int64)
    b0, need0 = _finish_bin(np.bincount(bins, minlength=1 << DIGIT), k, CLUSTER_THREADS)
    done0 = int((bins == b0).sum()) == need0
    per = -(-(-(-n // clusters)) // KEYS_A_THREAD) * KEYS_A_THREAD
    slices = [np.arange(min(r * per, n), min(r * per + per, n)) for r in range(clusters)]
    above = [comp[sl][bins[sl] > b0] for sl in slices]  # row order
    ties = [comp[sl][bins[sl] == b0] for sl in slices]
    listed = [t[:tie_cap] for t in ties]
    over = [len(t) > tie_cap for t in ties]
    assert sum(map(len, above)) == k - need0 and all(len(a) <= k for a in above)
    tie_keys = keys[bins == b0]
    one_key = tie_keys.min() == tie_keys.max()
    before = np.concatenate([[0], np.cumsum([len(t) for t in ties])])[:-1]
    m = [int(min(max(need0 - before[r], 0), len(ties[r]))) for r in range(clusters)]
    by_index = not done0 and one_key and not class_major
    # (the kernel's tie_cap, at least K + slack, always holds a CTA's winners of the bin)
    assert not by_index or all(m[r] <= len(listed[r]) for r in range(clusters))
    prefix, group = b0 << lo0, k
    went = "done" if done0 else "shortcut" if by_index else "index digits" if one_key else "digits"
    if went.endswith("digits") and any(over):
        went += " and key slices"
    if not done0 and not by_index and k - need0 + int((bins == b0).sum()) <= k + slack:
        group, went = k - need0 + int((bins == b0).sum()), "order"  # the first digit leaves few enough
    elif not done0 and not by_index:
        need, hi = need0, lo0
        if one_key:
            prefix, hi = int(tie_keys[0]) << ib, ib
        done = False
        while not done:
            lo = max(hi - DIGIT, 0)
            nb = 1 << (hi - lo)
            total = np.zeros(nb, np.int64)
            for r in range(clusters):  # each CTA's histogram, from its list or (overflowed) its key slice
                src = ties[r] if over[r] else listed[r]  # the slice's ties are what the row scan meets
                match = src[(src >> np.uint64(hi)) == np.uint64(prefix >> hi)]
                total += np.bincount(((match >> np.uint64(lo)) & np.uint64(nb - 1)).astype(np.int64), minlength=nb)
            b, left = _finish_bin(total, need, CLUSTER_THREADS)
            prefix |= b << lo
            need = left
            done = total[b] == left or lo == 0
            if not done and k - left + total[b] <= k + slack:  # few enough to order: the rest fall past row K
                group, done = k - left + int(total[b]), True
                went += " then order"
            hi = lo
    if by_index:
        group = k - need0
        mine = above
        lowest = min((int(a.min()) for a in above if len(a)), default=(1 << 64) - 1)
    else:
        mine = [np.concatenate([above[r], ties[r][ties[r] >= np.uint64(prefix)]]) for r in range(clusters)]
        lowest = prefix
    assert sum(map(len, mine)) == group
    top = max(int(c.max()) for c in listed + above if len(c))
    span = (top ^ lowest).bit_length() if top > lowest else 0
    dlo = max(span - DIGIT, 0)
    nd = 1 << (span - dlo)
    digit = lambda c: ((c >> np.uint64(dlo)) & np.uint64(nd - 1)).astype(np.int64)  # noqa: E731
    cnt = np.stack([np.bincount(digit(w), minlength=nd) for w in mine])  # (C, nd)
    start = np.concatenate([np.cumsum(cnt.sum(0)[::-1])[::-1][1:], [0]])  # the entries of larger digits
    slots = np.zeros(group, np.uint64)
    for r in range(clusters):  # each entry to a slot of its bucket, after the CTAs below this one
        nxt = start + cnt[:r].sum(0)
        for c, d in zip(mine[r], digit(mine[r])):
            slots[nxt[d]] = c
            nxt[d] += 1
    rows = np.zeros(k, np.uint64)
    filled = np.zeros(k, np.int64)
    rs = -(-group // clusters)  # each CTA's even share of the places; its slots start at a bucket's first place
    first = [min(int(start[max(d for d in range(nd) if start[d] >= q * rs)]), group)
             if any(start[d] >= q * rs for d in range(nd)) else group for q in range(clusters)] + [group]
    sorted_ctas = 0
    for q in range(clusters):  # each slot to its place: its bucket's first place and its larger ones there
        region = slots[first[q]:first[q + 1]]
        ends = [start[d - 1] if d > 0 else group for d in range(nd)]
        reads = sum(ends[d] - start[d] for d in digit(region))  # the counts' reads: a bucket's size a slot
        if reads > sort_step_reads * CLUSTER_THREADS * _sort_steps(len(region)):  # the CTA sorts its slots
            sorted_ctas += 1
            places = first[q] + np.arange(len(region))
            region = _sort_descending(region.copy())
        else:
            places = [start[d] + int((slots[start[d]:ends[d]] > c).sum()) for c, d in zip(region, digit(region))]
        for place, c in zip(places, region):
            if place < k:
                rows[place] = c
                filled[place] += 1
    if sorted_ctas:
        went += " sorted"
    if by_index:
        for r in range(clusters):
            for j in range(m[r]):
                row = group + before[r] + j
                rows[row] = listed[r][j]
                filled[row] += 1
    assert (filled == 1).all()  # every output row once
    assert (np.diff(rows.astype(np.float64)) <= 0).all() and len(set(rows.tolist())) == k
    return rows, ib, went


def _model_case_rows(tfeats, nc, conf, mask, ml, nchw, shapes):
    """(keys, flat) of each image's gated row in the kernel's storage order (class-major for NCHW views)."""
    gated = _gated_rows(tfeats, nc, conf, mask, ml)
    out = []
    for i in range(gated.shape[0]):
        keys, flat = _order_keys(gated[i]), np.arange(gated.shape[1])
        if ml and nchw:
            storage = _class_major_flat(shapes, nc)
            keys, flat = keys[storage], storage
        out.append((keys, flat))
    return gated, out


FEW_PASS = lambda x: x - 6.0  # noqa: E731  (class logits whose scores mostly fail the gate)
CROWDED = lambda x: x * 0.01  # noqa: E731  (scores within 0.5 +- 0.01: a few first-digit bins hold every entry)
BUNCHED = lambda x: torch.round(x * 2) / 2  # noqa: E731  (a few logit values, as bf16 logits near a bias give: keys
# that a hundred entries share)
CLUSTER_CASES = {  # name: (case of CASES, K, C, tie_cap, class-logit map or None, the branch taken, slack, and
    # the sort's cost in count reads a step: SORT_STEP_READS, or 0 to sort wherever a count reads anything)
    "multi": ("multi", 300, 3, 8192, None, "digits", 0, SORT_STEP_READS),
    "multi-order": ("multi", 300, 3, 8192, None, "order", SLACK, SORT_STEP_READS),
    "multi-digits-then-order": ("multi", 300, 3, 8192, None, "digits then order", 16, SORT_STEP_READS),
    "class-major": ("nhwc-views", 300, 5, 8192, None, "digits", 0, SORT_STEP_READS),
    "class-major-order": ("nhwc-views", 300, 5, 8192, None, "order", SLACK, SORT_STEP_READS),
    "few-pass": ("multi", 1000, 4, 8192, FEW_PASS, "shortcut", SLACK, SORT_STEP_READS),
    "few-pass-class-major": ("nhwc-views", 1000, 7, 8192, FEW_PASS, "index digits", 0, SORT_STEP_READS),
    "few-pass-c1": ("multi", 1000, 1, 8192, FEW_PASS, "shortcut", SLACK, SORT_STEP_READS),
    "all-gated": ("multi", 700, 16, 8192, lambda x: x - 40.0, "shortcut", SLACK, SORT_STEP_READS),
    "k-eq-n": ("multi", 1575, 4, 8192, None, "done", SLACK, SORT_STEP_READS),
    "ties": ("ties-multi", 400, 3, 8192, None, "shortcut", SLACK, SORT_STEP_READS),
    "class-mask": ("class-mask-multi", 200, 6, 8192, None, "digits", 0, SORT_STEP_READS),
    "nan": ("nan-multi", 300, 2, 8192, None, "digits", 0, SORT_STEP_READS),
    "overflow": ("multi", 300, 2, 100, CROWDED, "digits and key slices", 0, SORT_STEP_READS),
    "overflow-one-key": ("nhwc-views", 1000, 3, 100, FEW_PASS, "index digits and key slices", 0, SORT_STEP_READS),
    "single": ("single", 100, 3, 8192, None, "digits", 0, SORT_STEP_READS),
    "single-order": ("single", 100, 3, 8192, None, "order", SLACK, SORT_STEP_READS),
    "bunched": ("multi", 300, 3, 8192, BUNCHED, "order", SLACK, SORT_STEP_READS),
    "bunched-sorted": ("multi", 300, 3, 8192, BUNCHED, "order sorted", SLACK, 0),
    "bunched-digits-sorted": ("multi", 300, 2, 8192, BUNCHED, "digits sorted", 0, 0),
    "few-pass-class-major-sorted": ("nhwc-views", 1000, 7, 8192, FEW_PASS, "index digits sorted", 0, 0),
}


@pytest.mark.parametrize("name", list(CLUSTER_CASES))
def test_cluster_select_model_matches_plain_and_top_k(name):
    """The cluster kernel's select, modelled in numpy on the gated rows (slices, lists in row order, the first
    digit, the shared counts, the shortcut or the later digits, the sorts and the cross-CTA ranks), gives the plain
    version's candidates (values bit for bit, indices, classes) and lax.top_k's, through the branch named."""
    case, k, clusters, tie_cap, logits, went, slack, sort_step_reads = CLUSTER_CASES[name]
    feats, tfeats, mask, c = _case_inputs(case)
    if logits is not None:
        tfeats = [f.clone() for f in tfeats]
        for f in tfeats:
            f[..., 64:] = logits(f[..., 64:])
    nc = c["nc"]
    ml = c["ml"] and nc > 1
    tmask = None if mask is None else torch.from_numpy(mask)
    vals, bidx, cls = K.select_decode_plain(tfeats, STRIDES, nc, 16, 0.01, k, tmask, multi_label=c["ml"])[:3]
    gated, rows = _model_case_rows(tfeats, nc, 0.01, mask, ml, CASES[case][6], RECT)
    n = gated.shape[1]
    k = min(k, n)
    jv, ji = jax.lax.top_k(jnp.asarray(gated), k)
    for i, (keys, flat) in enumerate(rows):
        comp, ib, route = _cluster_model(keys, flat, k, clusters, tie_cap, class_major=ml and CASES[case][6],
                                         slack=slack, sort_step_reads=sort_step_reads)
        assert route == went
        idx = n - 1 - (comp & np.uint64((1 << ib) - 1)).astype(np.int64)
        got_vals = _key_values((comp >> np.uint64(ib)).astype(np.uint32))
        np.testing.assert_array_equal(got_vals.view(np.uint32), vals[i].numpy().view(np.uint32))
        np.testing.assert_array_equal(idx, (bidx[i] * nc + cls[i].long() if ml else bidx[i]).numpy())
        np.testing.assert_array_equal(idx, np.asarray(ji[i]))
        np.testing.assert_array_equal(got_vals, np.asarray(jv[i]))


@pytest.mark.parametrize("clusters", [2, 6])
def test_cluster_select_model_at_the_capacity(clusters):
    """K = CLUSTER_MAX_K winners of an 11,264-entry row (single-label, three distinct logit values: long runs of
    ties; at most the 3,072 anchors of the smaller levels pass): the model equals lax.top_k and the plain version, its CTAs' lists and sorts
    inside the kernel's capacities."""
    shapes = ((64, 128), (32, 64), (16, 64))
    rng = np.random.default_rng(clusters)
    feats = _feats(rng, B=1, shapes=shapes, nc=3, n_values=3)
    feats[0][..., 64:] -= 9.0  # the largest level's scores under the gate
    tfeats = [torch.from_numpy(f) for f in feats]
    k = CLUSTER_MAX_K
    vals, bidx = K.select_decode_plain(tfeats, STRIDES, 3, 16, 0.01, k)[:2]
    gated = _gated_rows(tfeats, 3, 0.01, None, False)
    n = gated.shape[1]
    assert n == 11264 and (gated[0] > 0).sum() <= 3072
    comp, ib, went = _cluster_model(_order_keys(gated[0]), np.arange(n), k, clusters, CLUSTER_MAX_K)
    assert went == "shortcut sorted"  # three logit values: the counts over their buckets cost more than a sort
    idx = n - 1 - (comp & np.uint64((1 << ib) - 1)).astype(np.int64)
    np.testing.assert_array_equal(idx, bidx[0].numpy())
    np.testing.assert_array_equal(_key_values((comp >> np.uint64(ib)).astype(np.uint32)), vals[0].numpy())
    np.testing.assert_array_equal(idx, np.asarray(jax.lax.top_k(jnp.asarray(gated), k)[1][0]))


def _class_max_model(x, mask, f, top):
    """ClassMax<true, top> on one anchor's logits x (nc,) in one pass without scores: the `top` (2 or 3) largest
    logits (ties in class order), the first NaN and the first masked class; then f(m0), the first class among the
    kept ones that tie it, and a rescan of the classes before that one only where every kept logit ties. Returns
    (best, arg)."""
    kept = []  # [(logit, class)], the largest first
    nan_i = zero_i = -1
    for c, v in enumerate(x):
        if mask is not None and not mask[c]:
            zero_i = c if zero_i < 0 else zero_i
        elif np.isnan(v):
            nan_i = c if nan_i < 0 else nan_i
        elif len(kept) < top or v > kept[-1][0]:
            at = next((s for s, (m, _) in enumerate(kept) if v > m), len(kept))
            kept = (kept[:at] + [(v, c)] + kept[at:])[:top]
    if nan_i >= 0:
        return np.nan, nan_i
    if not kept:
        return 0.0, zero_i
    best = f(kept[0][0])
    arg = kept[0][1]
    if len(kept) >= 2 and f(kept[1][0]) == best:
        arg = min(arg, kept[1][1])
        if len(kept) == top and f(kept[-1][0]) == best:  # the tie may reach below the kept logits
            arg = next((c for c in range(arg) if (mask is None or mask[c]) and f(x[c]) == best), arg)
    if best == 0.0 and 0 <= zero_i < arg:
        arg = zero_i
    return best, arg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_class_max_one_pass_matches_amax_argmax(dtype):
    """The single-label score pass's one-pass max and argmax (taken where the sigmoid is monotone: every score
    function on these rows is, checked here) equals torch's amax / argmax of where(mask, sigmoid(x), 0): random
    rows, equal logits, logits that saturate to 1 and underflow to 0 (ties of different logits), NaN, masks that
    hide the max or every class."""
    rng = np.random.default_rng(5)
    nc = 16
    rows = [rng.normal(0, 3, nc), np.full(nc, -2.0), rng.choice([-4.0, 1.0, 3.0], nc), rng.uniform(17, 40, nc),
            rng.uniform(-120, -95, nc), np.where(np.arange(nc) == 5, np.nan, rng.normal(0, 3, nc)),
            np.r_[rng.normal(0, 1, 8), np.full(8, 2.0)], np.linspace(-3, 3, nc)[::-1].copy()]
    masks = [None, np.arange(nc) % 3 != 0, np.zeros(nc, bool), np.arange(nc) != 5]
    f = lambda v: float(torch.sigmoid(torch.tensor(v, dtype=torch.float32).to(dtype)).float())
    grid = torch.sort(torch.from_numpy(np.concatenate(rows)).float().to(dtype).float().nan_to_num(0.0)).values
    fs = torch.sigmoid(grid.to(dtype)).float()
    assert bool((fs[1:] >= fs[:-1]).all())  # monotone on every logit of the rows
    for x in rows:
        xq = torch.from_numpy(x).float().to(dtype).float().numpy()
        for mask in masks:
            s = torch.sigmoid(torch.from_numpy(xq).to(dtype)).float()
            if mask is not None:
                s = torch.where(torch.from_numpy(mask), s, 0.0)
            for top in (2, 3):  # as the kernels keep them: for fp32 scores, for bf16 and fp16 ones
                best, arg = _class_max_model(xq, mask, f, top)
                assert arg == int(s.argmax()), (x, mask, top)
                want = float(s.amax())
                assert (np.isnan(best) and np.isnan(want)) or best == want
