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
    before = K.select_decode.launches
    for got in (K.select_decode(*args), torch.ops.yololite_tpu_torch.select_decode(*args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert K.select_decode.launches == before  # the counter counts card launches only
    vals, bidx, cls = tnms.select_from_feats(tfeats, c["nc"], 16, 0.01, c["max_cand"], tmask,
                                             multi_label=c["ml"])
    assert torch.equal(vals, want[0]) and torch.equal(bidx, want[1]) and torch.equal(cls, want[2])


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
