"""A whole zoo model in yololite_tpu_torch vs the JAX package, on the CPU, at full width.

This file holds YOLOv10-N (`cfg.dicts.YOLOV10N`: SCDown, PSA, C2fCIB with
RepVGGDW, the end2end head); tests/test_torch_zoo_models_gelan.py runs the
same tests on GELAN-T (`cfg.dicts.GELAN_T`: ELAN1, AConv, RepNCSPELAN4,
SPPELAN), as a file of its own so that the two spread over workers. The
model (`MODEL`) is built in both packages from the same spec dict:

- init(0) bit for bit, the same parameter counts, strides, save list and GFLOPs;
- the forward, unfused and fused, on JAX init(1) weights with perturbed BN
  statistics, within rtol 1e-4, atol 2e-4;
- on the same separating weights (weights x 2.5, class logits spread on the
  safe sigmoid grid, BN statistics perturbed), predict through both facades at imgsz 96 and 128 (and TTA for GELAN-T):
  equal counts and classes, detections matched as sets (box within 0.05 px,
  score within rtol 1e-3); the bf16 Detect maps at cosine >= 0.9995 to JAX's
  bf16;
- val on a dataset labelled from the model's own detections: counts and
  classes per image equal, mAP50-95 and mAP50 within 1e-3;
- .npz and .pt: a file written by either package loads in the other with
  equal weights; the port's load_pt of an upstream-format
  .pt gives the JAX mapping's (`map_state_dict_into`) weights bit for bit;
- int8: the port refuses a zoo model (NotImplementedError) where the JAX
  package fails with a TypeError in the quantized forward.

One train step and the trainers' checkpoints are in tests/test_torch_zoo_train*.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu import YOLOLite as JaxYOLOLite
from yololite_tpu.engine.validator import DetectionValidator as JaxValidator
from yololite_tpu.models import checkpoint as jckpt
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.models.modules import fuse_tree

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.cfg.dicts import GELAN_T, YOLOV10N
from yololite_tpu_torch.engine.predictor import forward_nhwc, inference_net
from yololite_tpu_torch.engine.validator import DetectionValidator
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel

from tests.test_torch_model import _perturb_state
from tests.test_torch_nms import _safe_grid
from tests.test_torch_predict import _match_sets
from tests.test_torch_val import _write_dataset

RTOL, ATOL = 1e-4, 2e-4
SPECS = {"yolov10n": YOLOV10N, "gelan-t": GELAN_T}
PARAMS = {"yolov10n": 2775504, "gelan-t": 1796592}
MODEL = "yolov10n"  # the spec this module runs (SPECS key)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _separating(jm, seed):
    """JAX init(0) trees with weights whose candidates do not tie (tests/test_torch_val.py val_pair).

    Every conv x 2.5 keeps the signal alive to the head; each level's last
    class conv (both branch pairs of an end2end head) is scaled up and its
    biases set on the safe sigmoid grid; BN statistics are perturbed.
    """
    rng = np.random.default_rng(seed)
    p, s = _np_tree(jm.init(0))
    p = jax.tree.map(lambda w: w * np.float32(2.5) if w.ndim == 4 else w, p)
    mid = _safe_grid()
    mid = mid[(mid > -5) & (mid < 0)]
    head = p[str(len(jm.rows) - 1)]
    for key in ("cv3", "one2one_cv3"):
        for i, sc in enumerate((100.0, 400.0, 1000.0)):
            if key in head:
                c = head[key][str(i)]["2"]
                c["b"] = mid[rng.integers(0, len(mid), c["b"].shape[0])]
                c["w"] = (c["w"] * sc).astype(np.float32)
    s = jax.tree_util.tree_map_with_path(
        lambda path, x: (x * rng.uniform(0.8, 1.2, x.shape) if path[-1].key == "var"
                         else x + rng.uniform(-0.1, 0.1, x.shape)).astype(np.float32), s)
    return p, s


@pytest.fixture(scope="module")
def name(request):
    """The SPECS key of the model that the requesting module runs."""
    return request.module.MODEL


@pytest.fixture(scope="module")
def pair(name):
    """A JAX and a port facade of the model on the same separating weights."""
    spec = SPECS[name]
    jy = JaxYOLOLite("yolo11n.yaml")
    jy.model = JaxModel(spec)
    p, s = _separating(jy.model, 1)
    jy.params, jy.state = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s)
    ty = YOLOLite(spec, device="cpu")
    ty.model.load_state_dict(ckpt.state_dict_from_jax(p, s), strict=True)
    return name, jy, ty


def _frames(seed, n=3, shape=(120, 160, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, np.uint8) for _ in range(n)]


def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = g.boxes.data, w.boxes.data
        assert len(gd) == len(wd) > 0
        np.testing.assert_array_equal(np.sort(gd[:, 5]), np.sort(wd[:, 5]))
        assert _match_sets(wd, gd) == len(wd)


def test_init_matches_jax(name):
    """init(0) bit for bit, with the JAX parameter count, strides, save list and GFLOPs."""
    jm = JaxModel(SPECS[name])
    p, s = jm.init(0)
    want = ckpt.state_dict_from_jax(_np_tree(p), _np_tree(s))
    tm = DetectionModel(SPECS[name]).init(0)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert tm.num_params() == jm.num_params(p) == PARAMS[name]
    assert tm.strides == jm.strides == [8, 16, 32] and tm.save == jm.save
    assert tm.gflops(640) == pytest.approx(jm.gflops(p, s, 640), rel=1e-9)
    assert tm.detect.end2end == (name == "yolov10n")


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_forward_matches_jax(name, fused):
    """JAX init(1) with perturbed BN statistics (tests/test_torch_model.py), at 2 x 96 x 128, strict load."""
    jm = JaxModel(SPECS[name])
    p, s = jm.init(1)
    s = _perturb_state(s, 2)
    if fused:
        p, s = fuse_tree(p, s)
    tm = DetectionModel(SPECS[name]).eval()
    if fused:
        tm.fuse()
    tm.load_state_dict(ckpt.state_dict_from_jax(_np_tree(p), _np_tree(s)), strict=True)
    x = np.random.default_rng(6).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    want = jax.jit(lambda p, s, x: jm.apply(p, s, x))(p, s, jnp.asarray(x))
    with torch.no_grad():
        got = forward_nhwc(tm, torch.from_numpy(x))
    if name == "yolov10n":
        assert set(got) == set(want) == {"one2many", "one2one"}
        got, want = got["one2many"] + got["one2one"], want["one2many"] + want["one2one"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(w)[..., :64].std() > 1e-2  # the box logits still vary over the anchors
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_predict_matches_jax(pair):
    """At imgsz 96 (GELAN-T's NMS at K = 512; YOLOv10-N's one2one top-k), and TTA for GELAN-T."""
    name, jy, ty = pair
    src = _frames(4)
    kw = dict(conf=1e-7, imgsz=96, batch=4, save=False, verbose=False)
    _assert_same_detections(ty.predict(src, **kw), jy.predict(src, **kw))
    if name == "gelan-t":  # TTA: three views merged before one NMS
        _assert_same_detections(ty.predict(src, augment=True, **kw), jy.predict(src, augment=True, **kw))


def test_predict_bf16_detect_maps_match_jax(pair):
    """bf16 Detect maps, port against JAX's bf16 on the same fused weights: cosine >= 0.9995 per map."""
    name, jy, ty = pair
    x = np.random.default_rng(6).random((2, 128, 128, 3)).astype(np.float32)
    params, state = fuse_tree(jy.params, jy.state)
    cast = lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)
    want = jax.jit(lambda p, s, x: jy.model.apply(p, s, x))(cast(params), cast(state), jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = forward_nhwc(inference_net(ty.model, torch.device("cpu"), half=True),
                           torch.from_numpy(x).to(torch.bfloat16))
    if name == "yolov10n":
        got, want = got["one2many"] + got["one2one"], want["one2many"] + want["one2one"]
    coss = []
    for g, w in zip(got, want):
        a, b = g.float().numpy().ravel(), np.asarray(w, np.float32).ravel()
        assert g.dtype == torch.bfloat16 and a.shape == b.shape
        coss.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    print(f"{name}: bf16 Detect maps vs JAX bf16, cosine per map: {coss}")
    assert min(coss) >= 0.9995, coss


def test_val_matches_jax(pair, tmp_path):
    """Val on 4 images labelled from the model's own detections: counts and classes per image, mAP within 1e-3."""
    name, jy, ty = pair
    shapes = [(90, 160), (120, 160), (160, 160), (160, 120)]
    rng = np.random.default_rng(11)
    data = _write_dataset(tmp_path, shapes, seed=12, labels=[[] for _ in shapes])
    files = sorted(str(f) for f in (tmp_path / "images" / "val").iterdir())
    labels = []
    for r, (h, w) in zip(ty.predict(files, conf=0.01, imgsz=96, batch=4, save=False, verbose=False), shapes):
        rows = []
        for x1, y1, x2, y2, _, k in r.boxes.data[:8]:
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.uniform(-3, 3, 4), 0, [w, h, w, h])
            if x2 - x1 > 2 and y2 - y1 > 2:
                rows.append((int(k), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h))
        labels.append(rows)
    _write_dataset(tmp_path, shapes, seed=12, labels=labels)
    args = dict(data=str(data), imgsz=96, batch=2, conf=1e-7, rect=True, mode="val", plots=False, workers=0)
    jv = JaxValidator(save_dir=tmp_path / "jax", args=args)
    jv(model=jy.model, params=jy.params, state=jy.state)
    tv = DetectionValidator(save_dir=tmp_path / "port", args=args, device="cpu")
    tv(model=ty.model)
    assert tv.seen == jv.seen == 4
    n_t = [len(c) for c in tv.stats["conf"]]
    assert n_t == [len(c) for c in jv.stats["conf"]] and min(n_t) > 0
    for a, b in zip(tv.stats["pred_cls"], jv.stats["pred_cls"]):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    g, w = tv.metrics.results_dict, jv.metrics.results_dict
    for key in ("metrics/mAP50-95(B)", "metrics/mAP50(B)"):
        assert 0.05 < w[key] <= 1
        assert abs(g[key] - w[key]) <= 1e-3, (key, g[key], w[key])


def test_npz_round_trips(pair, tmp_path):
    """The port's .npz loads in the JAX facade with the JAX trees it was made from; the JAX facade's .npz loads
    here bit-equal and predicts as the model it came from."""
    name, jy, ty = pair
    ty.save(tmp_path / "port.npz")
    jl = JaxYOLOLite(str(tmp_path / "port.npz"))
    assert jl.model.yaml == jy.model.yaml
    for a, b in zip(jax.tree.leaves(_np_tree((jl.params, jl.state))), jax.tree.leaves(_np_tree((jy.params, jy.state)))):
        np.testing.assert_array_equal(a, b)
    jy.save(tmp_path / "jax.npz")
    tl = YOLOLite(str(tmp_path / "jax.npz"), device="cpu")
    assert set(tl.model.state_dict()) == set(ty.model.state_dict())
    for (k, a), b in zip(tl.model.state_dict().items(), ty.model.state_dict().values()):
        assert torch.equal(a, b), k
    src = _frames(7, n=2)
    kw = dict(conf=1e-7, imgsz=96, batch=2, save=False, verbose=False)
    for a, b in zip(tl.predict(src, **kw), ty.predict(src, **kw)):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)


def test_pt_loads_match_jax_mapping(pair, tmp_path):
    """An upstream-format .pt of the model: the port's load_pt builds the spec it carries and fills it with the
    weights the JAX package's strict name mapping gives; the facade predicts as the model it came from."""
    name, jy, ty = pair
    path = tmp_path / f"{name}.pt"
    torch.save({"model": ty.model, "train_args": {"imgsz": 96}, "epoch": -1}, str(path))
    sd, meta = jckpt.read_pt_checkpoint(str(path))
    jm = JaxModel(meta["yaml"])
    jp, js = jckpt.map_state_dict_into(sd, *jm.init(0), strict=True)
    tm, tmeta = ckpt.load_pt(str(path))
    assert tmeta["yaml"] == dict(ty.model.yaml) and tm.detect.end2end == (name == "yolov10n")
    want = ckpt.state_dict_from_jax(_np_tree(jp), _np_tree(js))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    loaded = YOLOLite(str(path), device="cpu")
    src = _frames(8, n=2)
    kw = dict(conf=1e-7, imgsz=96, batch=2, save=False, verbose=False)
    for a, b in zip(loaded.predict(src, **kw), ty.predict(src, **kw)):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)


def test_int8_refused_as_the_jax_package_fails(pair):
    """predict(int8=True) on a zoo model raises before any quantized forward; the JAX package's quantized
    forward of the same model raises a TypeError (SiLU of an int8 sum in RepConv / RepVGGDW)."""
    from yololite_tpu.models.quant import quantize_tree as jax_quantize_tree

    from yololite_tpu_torch.ops.kernels import int8_conv

    name, jy, ty = pair
    src = _frames(9, n=1, shape=(64, 64, 3))
    launches = int8_conv.launches
    first_zoo_row = {"yolov10n": r"row 5 \(SCDown\)", "gelan-t": r"row 2 \(ELAN1\)"}[name]
    with pytest.raises(NotImplementedError, match=first_zoo_row + ".*JAX package"):
        ty.predict(src, int8=True, imgsz=64, conf=1e-7, save=False, verbose=False)
    assert int8_conv.launches == launches and not ty.predictor._quantized
    # the JAX package quantizes the fused trees (at a fixed activation scale, in place of its eager calibration)
    fused_p, fused_s = fuse_tree(jy.params, jy.state)
    q_params = jax_quantize_tree(jy.model, fused_p, {"s_act": 0.05})
    bf16 = lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)
    x = jnp.asarray(np.random.default_rng(10).random((1, 64, 64, 3)), jnp.bfloat16)
    with pytest.raises(TypeError, match="int8"):
        jax.jit(lambda p, s, x: jy.model.apply(p, s, x))(q_params, bf16(fused_s), x)
