""".pt checkpoints, ensembles and embed in yololite_tpu_torch vs the JAX package, on the CPU.

No upstream .pt is in the repository, so every file here is fabricated under
tmp_path: `torch.save({"model": m, "train_args": ...})` of the port's own
DetectionModel (init(0), BN statistics perturbed). Both packages read it
through their stub unpicklers, which stub the port's classes as they would
upstream ones, and must load the same weights, exactly, and predict the same
detections (matched as sets, as tests/test_torch_predict.py does).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from yololite_tpu import YOLOLite as JaxYOLOLite
from yololite_tpu.engine import trainer as jtrainer
from yololite_tpu.models import checkpoint as jckpt

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.engine import trainer as ttrainer
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.ensemble import attempt_load_weights
from yololite_tpu_torch.models.model import DetectionModel, EnsembleModel

from tests.test_torch_predict import _match_sets, _sources
from tests.test_torch_train import _overrides, _write_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module holds the port against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed: int, perturb_seed: int) -> DetectionModel:
    """The port's yolo11n at init(seed) with BN statistics moved off (0, 1) by uniform(0, 0.2) noise.

    perturb_seed 3 gives the weights of tests/test_torch_predict.py's `pair`,
    whose sources have no near-tie that would reorder the greedy cascade.
    """
    m = DetectionModel("yolo11n.yaml").init(seed)
    rng = np.random.default_rng(perturb_seed)
    jax_state = ckpt.jax_trees(m)[1]
    perturbed = jax.tree.map(lambda x: (x + rng.uniform(0.0, 0.2, x.shape)).astype(np.float32), jax_state)
    return ckpt.load_jax_trees(m, ckpt.jax_trees(m)[0], perturbed)


def _save(path, net, **extra):
    torch.save({"model": net, "train_args": {"imgsz": 640, "batch": 16}, "epoch": -1, **extra}, str(path))
    return str(path)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_same_weights(port_model, jax_params, jax_state):
    """The port model's weights, in the JAX tree layout, equal the JAX trees leaf for leaf, bit for bit."""
    got_p, got_s = ckpt.jax_trees(port_model)
    for got, want, what in ((got_p, jax_params, "params"), (got_s, jax_state, "state")):
        g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
        assert set(g) == set(w), (what, sorted(set(g) ^ set(w))[:5])
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def pts(tmp_path_factory):
    """The fabricated checkpoints, by case name."""
    d = tmp_path_factory.mktemp("pt")
    m0, m1 = _model(0, 3), _model(1, 4)
    fused = DetectionModel("yolo11n.yaml").init(2)
    fused.load_state_dict(m0.state_dict())
    fused.fuse()
    return {
        "plain": _save(d / "yolo11n.pt", m0),
        "ema": _save(d / "ema.pt", m1, ema=m0),  # 'ema' is preferred over 'model'
        "fused": _save(d / "fused.pt", fused),
        "ensemble1": _save(d / "one.pt", nn.ModuleList([m0])),
        "ensemble2": _save(d / "pair.pt", nn.ModuleList([m0, m1])),
    }


@pytest.mark.parametrize("case,nc", [("plain", None), ("ema", None), ("fused", None), ("ensemble1", None),
                                     ("ensemble2", None), ("plain", 2)],
                         ids=["plain", "ema", "fused", "ensemble1", "ensemble2", "nc2-intersect"])
def test_load_pt_matches_jax(pts, case, nc):
    """The port's load_pt gives the weights the JAX load_pt gives, exactly; nc=2 keeps the same leaves fresh."""
    path = pts[case]
    jm, jp, js, jmeta = jckpt.load_pt(path, nc=nc)
    tm, tmeta = ckpt.load_pt(path, nc=nc)
    assert tmeta["args"] == jmeta["args"] == {"imgsz": 640, "batch": 16}
    assert tmeta["scale"] == jmeta["scale"] == "n" and tmeta["nc"] == jmeta["nc"] == 80
    if case == "ensemble2":
        assert isinstance(tm, EnsembleModel) and len(tm.members) == 2
        for i, member in enumerate(tm.members):
            _assert_same_weights(member, jp[f"m{i}"], js[f"m{i}"])
        # the JAX ensemble's "m{i}"-keyed trees carry across onto an EnsembleModel
        carried = ckpt.load_jax_trees(EnsembleModel([DetectionModel("yolo11n.yaml") for _ in range(2)]),
                                      jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
        for a, b in zip(carried.state_dict().items(), tm.state_dict().values()):
            assert torch.equal(a[1], b), a[0]
        return
    assert isinstance(tm, DetectionModel) and tm.nc == jm.nc == (nc or 80)
    _assert_same_weights(tm, jp, js)
    if case == "fused":
        assert tm.model[0].bn is None and "bn" not in jp["0"]
    if nc == 2:  # the class logits keep init(0); the box branch and everything before it transferred
        src, _ = ckpt.load_pt(path)
        head = tm.detect
        assert head.cv3[0][2].weight.shape[0] == 2
        assert torch.equal(head.cv2[0][2].weight, src.detect.cv2[0][2].weight)
        fresh = DetectionModel("yolo11n.yaml", nc=2).init(0).detect
        assert torch.equal(head.cv3[0][2].weight, fresh.cv3[0][2].weight)


def test_load_pt_refuses_a_mismatch(tmp_path):
    """Strict loading raises on a shape mismatch; a missing file raises FileNotFoundError in the facade."""
    m = DetectionModel("yolo11n.yaml").init(0)
    sd = {k[len("model."):]: v for k, v in m.state_dict().items()}
    sd["0.conv.weight"] = sd["0.conv.weight"][:8]
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.map_state_dict_into(sd, DetectionModel("yolo11n.yaml"), strict=True)
    with pytest.raises(FileNotFoundError):
        YOLOLite(str(tmp_path / "missing.pt"), device="cpu")
    with pytest.raises(FileNotFoundError):
        JaxYOLOLite(str(tmp_path / "missing.pt"))


def test_predict_from_pt_matches_jax(pts):
    """YOLOLite(pt).predict: the same detections in both packages (counts and classes equal, boxes within 0.05 px)."""
    src, _ = _sources()["same-shape"]
    kw = dict(conf=1e-7, imgsz=160, batch=4, save=False, verbose=False)
    want = JaxYOLOLite(pts["plain"]).predict(src, **kw)
    tm = YOLOLite(pts["plain"], device="cpu")
    assert tm.overrides["model"] == pts["plain"] and tm.overrides["imgsz"] == 640
    got = tm.predict(src, **kw)
    for g, w in zip(got, want):
        gd, wd = g.boxes.data, w.boxes.data
        assert len(gd) == len(wd) > 0
        np.testing.assert_array_equal(np.sort(gd[:, 5]), np.sort(wd[:, 5]))
        assert _match_sets(wd, gd) == len(wd)


def test_ensemble_decode_concat_matches_jax(pts):
    """The 2-member ensemble's decoded candidates, members concatenated along the anchors, at rtol 1e-4."""
    jm, jp, js, _ = jckpt.load_pt(pts["ensemble2"])
    tm, _ = ckpt.load_pt(pts["ensemble2"])
    x = np.random.default_rng(5).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    wb, ws = jax.jit(lambda p, s, x: jm.decode_concat(p, s, x, half=False))(jp, js, jnp.asarray(x))
    with torch.no_grad():
        gb, gs = tm.eval().decode_concat(torch.from_numpy(x))
    assert gb.shape == (2, 2 * 252, 4) and gs.shape == (2, 2 * 252, 80)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4, atol=1e-7)


def test_ensemble_predicts_end_to_end(pts):
    """A pickled 2-member Ensemble .pt predicts through the facade; Ensemble/attempt_load_weights decode as JAX's.

    The ensemble path takes the single-label max over sigmoid scores of the
    decoded candidates, where random weights leave near-ties that 1-ulp
    differences reorder (one detection of 95 was seen to change), so the
    detections are held to JAX's as sets within that: counts within 2, 95%
    matched. On equal candidates the NMS is exact (tests/test_torch_nms.py).
    """
    src, _ = _sources()["same-shape"]
    kw = dict(conf=1e-7, imgsz=160, batch=4, save=False, verbose=False)
    got = YOLOLite(pts["ensemble2"], device="cpu").predict(src, **kw)
    want = JaxYOLOLite(pts["ensemble2"]).predict(src, **kw)
    for g, w in zip(got, want):
        gd, wd = g.boxes.data, w.boxes.data
        assert len(wd) > 0 and abs(len(gd) - len(wd)) <= 2 and np.isfinite(gd).all()
        assert _match_sets(wd, gd) >= 0.95 * len(wd)
    ens = attempt_load_weights([pts["plain"], pts["ema"]])
    assert len(ens.members) == 2
    x = torch.zeros((1, 96, 96, 3))
    boxes, scores = ens.decode(x)
    assert boxes.shape == (1, 2 * 189, 4) and scores.shape == (1, 2 * 189, 80)
    assert tuple(ens(x, conf_thres=1e-6, max_det=10).shape) == (1, 10, 6)


def test_embed_matches_jax(pts):
    """embed: the mean-pooled rows 4 and 6 of the unfused fp32 model, as JAX's, at rtol 1e-4."""
    img = np.random.default_rng(0).integers(0, 255, (120, 160, 3), np.uint8)
    want = JaxYOLOLite(pts["plain"]).embed([img], layers=[4, 6], imgsz=160)
    tm = YOLOLite(pts["plain"], device="cpu")
    got = tm.embed([img], layers=[4, 6], imgsz=160)
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape == (1, 128 + 128)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4, atol=1e-6)
    assert tm.model.training  # embed leaves the model's mode as it was


def test_trainer_from_pt_at_another_nc_matches_jax(pts, tmp_path):
    """DetectionTrainer(model=x.pt) on a 3-class dataset: the intersect transfer gives JAX's weights, exactly."""
    data = _write_dataset(tmp_path / "data", n_train=2, n_val=1, seed=41)
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, tmp_path, "jax", model=pts["plain"]))
    jt.get_model()
    tt = ttrainer.DetectionTrainer(overrides=_overrides(data, tmp_path, "port", model=pts["plain"]), device="cpu")
    tt.get_model()
    assert tt.model.nc == jt.model.nc == 3
    _assert_same_weights(tt.model, jt.params, jt.state)
