"""yololite_tpu_torch data parallelism (parallel/mesh.py) on the CPU, against the JAX package and one device.

- `select_device` parses the same strings as the JAX function, with the same
  batch-rule messages (torch is told of 8 cards, as conftest gives JAX 8
  virtual devices; nothing touches a card);
- `shard_batch` and its tail rule;
- predict and val over a ['cpu', 'cpu'] mesh equal the one-device results;
- a 2-rank gloo train step (`launch`, `file://` store under tmp_path) equals
  the port's one-process step on the global batch: loss items within rtol
  1e-5, each gradient within 1e-4 relative L2, BN running statistics within
  rtol 1e-5 (atol 1e-7 for the means that sit near 0), the weights after
  the SGD step within rtol 1e-5, atol 1e-6 (the step turns the gradients'
  difference into about 1e-7 of weight), and the fg_mask rows equal; and JAX's step on its virtual 8-device mesh, within
  tests/test_torch_train.py's bounds. Leaves whose exact gradient is zero
  (the BN biases before C2PSA's residual sums, 1e-18 in fp64) are compared
  with their norm floored at 1e-5 of the largest leaf's, as there.

The 2-epoch loss curve against the JAX trainer's auto-sharded run is in
tests/test_torch_parallel_train.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.engine import trainer as jtrainer
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.parallel import mesh as jmesh
from yololite_tpu.utils.loss import build_targets as jax_build_targets

from yololite_tpu_torch.engine.predictor import DetectionPredictor
from yololite_tpu_torch.engine.trainer import data_parallel_step
from yololite_tpu_torch.engine.validator import DetectionValidator
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.models.modules import CrossRankBatchNorm2d
from yololite_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_train import GRAD_REL_L2, NARROW, STEP_ATOL, _batch, _np, _overrides, _rel_l2, _write_dataset
from tests.test_torch_val import _write_dataset as _write_val_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- select_device, shard_batch ----------------


@pytest.fixture
def eight_cards(monkeypatch):
    """torch is told of 8 cards; nothing is launched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")


@pytest.mark.parametrize("device", ["", "0", "3", "0,1,2,3", "cuda:0", "cuda:1,5", "0, 7", "[0, 2]", "cuda", None])
def test_select_device_parses_as_jax(eight_cards, device):
    want = jmesh.select_device(device, batch=16, verbose=False)
    got = tmesh.select_device(device, batch=16, verbose=False)
    assert [d.id for d in want] == [d.index for d in got] and all(d.type == "cuda" for d in got)


def test_select_device_cpu_is_the_one_cpu_device(eight_cards):
    """JAX's 'cpu' is every CPU device of its backend (8 virtual ones here); torch has one CPU device."""
    assert tmesh.select_device("cpu", batch=16, verbose=False) == [torch.device("cpu")]
    assert tmesh.select_device(["cpu", "cpu"], batch=16, verbose=False) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("device,batch", [("0,1,2,3", 0), ("0,1,2", 8), ("0,1", -1), ("9", 8)],
                         ids=["batch<1", "not-a-multiple", "negative", "out-of-range"])
def test_select_device_batch_rules_as_jax(eight_cards, device, batch):
    with pytest.raises(ValueError) as want:
        jmesh.select_device(device, batch=batch, verbose=False)
    with pytest.raises(ValueError) as got:
        tmesh.select_device(device, batch=batch, verbose=False)
    assert str(got.value) == str(want.value)


def test_select_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("", "0", "0,1"):
        with pytest.raises(RuntimeError, match="none is visible"):
            tmesh.select_device(device, batch=8, verbose=False)
    assert tmesh.select_device("cpu", verbose=False) == [torch.device("cpu")]


def test_shard_batch_and_its_tail_rule():
    mesh = tmesh.make_mesh(devices=["cpu", "cpu"])
    assert tmesh.mesh_size(mesh) == 2 and tmesh.mesh_size(None) == 1
    x = {"img": np.arange(8 * 3).reshape(8, 3), "mask": np.ones((8, 2, 1), np.float32)}
    shards = tmesh.shard_batch(mesh, x)
    assert len(shards) == 2
    np.testing.assert_array_equal(torch.cat([s["img"] for s in shards]).numpy(), x["img"])
    assert [s["mask"].shape[0] for s in shards] == [4, 4]
    tail = tmesh.shard_batch(mesh, {"img": np.zeros((5, 3))})  # 5 % 2: one unsharded shard
    assert len(tail) == 1 and tail[0]["img"].shape == (5, 3)
    assert tmesh.batch_sharding(mesh, 5) is None
    assert [r for _, r in tmesh.batch_sharding(mesh, 6)] == [slice(0, 3), slice(3, 6)]
    assert len(tmesh.shard_batch(None, x)) == 1
    reps = tmesh.replicate_tree(mesh, torch.nn.Linear(2, 2))
    assert len(reps) == 2 and reps[0] is not reps[1] and torch.equal(reps[0].weight, reps[1].weight)
    assert tmesh.replicated(mesh) == mesh.devices


# ---------------- inference over a mesh ----------------


def _narrow_model():
    m = DetectionModel(NARROW, nc=3).init(0)
    with torch.no_grad():  # class logits with spread, so the NMS has work
        for seq in m.detect.cv3:
            seq[2].bias.fill_(-3.0)
            seq[2].weight.mul_(30.0)
    return m


@pytest.mark.parametrize("batch,n", [(4, 4), (3, 3)], ids=["sharded", "tail"])
def test_predict_over_a_mesh_equals_one_device(tmp_path, batch, n):
    model = _narrow_model()
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(n)]
    out = []
    for device in ("cpu", ["cpu", "cpu"]):
        p = DetectionPredictor(overrides=dict(imgsz=64, batch=batch, conf=0.01, save=False, verbose=False,
                                              project=str(tmp_path)), device=device)
        p.setup_model(model, half=False)
        assert (p.mesh is None) == (device == "cpu") and len(p.replicas) == (1 if device == "cpu" else 2)
        out.append([r.boxes.data for r in p(imgs)])
    assert sum(len(d) for d in out[0]) > 0
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)


def test_val_over_a_mesh_equals_one_device(tmp_path):
    """Labels from the model's own detections (jittered), so the mAP is not 0."""
    shapes = [(64, 64), (48, 64), (64, 48), (64, 64), (56, 64), (64, 64)]
    root, model, rng = tmp_path / "d", _narrow_model(), np.random.default_rng(3)
    data = _write_val_dataset(root, shapes, seed=4, labels=[[] for _ in shapes])
    files = sorted(str(f) for f in (root / "images" / "val").iterdir())
    p = DetectionPredictor(overrides=dict(imgsz=64, batch=1, conf=0.01, save=False, verbose=False,
                                          project=str(tmp_path)), device="cpu")
    p.setup_model(model, half=False)
    labels = []
    for r, (h, w) in zip(p(files), shapes):
        rows = []
        for x1, y1, x2, y2, _, k in r.boxes.data[:3]:
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.uniform(-2, 2, 4), 0, [w, h, w, h])
            rows.append((int(k), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h))
        labels.append(rows)
    _write_val_dataset(root, shapes, seed=4, labels=labels)
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames: {{0: a, 1: b, 2: c}}\n")
    res = []
    for device in ("cpu", ["cpu", "cpu"]):  # batch 4, rect: a batch of 4 shards, the tail of 2 shards too
        v = DetectionValidator(args=dict(data=str(data), imgsz=64, batch=4, conf=0.001, plots=False, rect=True,
                                         project=str(tmp_path), name="v"), device=device)
        res.append(v(model=model))
        assert v.seen == len(shapes)
    assert res[0]["metrics/mAP50(B)"] > 0
    for k in res[0]:
        assert abs(res[1][k] - res[0][k]) <= 1e-6, k


# ---------------- the data-parallel train step ----------------


@pytest.fixture(scope="module")
def dp_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpdata")
    return _write_dataset(root, n_train=8, n_val=2, seed=40), root


def _dp_pair(data, root, tmp, name, B):
    ov = _overrides(data, root, name, batch=B, nbs=B)
    model = DetectionModel(NARROW, nc=3).init(0)
    b = _batch(41, B=B)
    lr, mom = [0.01, 0.02, 0.03], 0.9
    one = data_parallel_step(0, 1, torch.device("cpu"), ov, model, [b], lr, mom)
    ranks = tmesh.launch(data_parallel_step, ["cpu", "cpu"], "gloo", init_file=tmp / f"{name}_store",
                         args=(ov, model, [b], lr, mom))
    return b, one, ranks


@pytest.fixture(scope="module")
def dp_step(dp_data, tmp_path_factory):
    data, root = dp_data
    return _dp_pair(data, root, tmp_path_factory.mktemp("store"), "dp8", 8)


def _assert_state_close(got, want, what, rtol, atol):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].double().numpy(), w.double().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _assert_steps_equal(one, ranks, grad_bound):
    for r in ranks:
        np.testing.assert_allclose(r["items"][0].numpy(), one["items"][0].numpy(), rtol=1e-5)
    g1 = one["grads"]
    floor = 1e-5 * max(float(g.norm()) for g in g1.values())
    for k, g in g1.items():
        assert _rel_l2(ranks[0]["grads"][k].double().numpy(), g.double().numpy(), floor) <= grad_bound, k
    for k in one["after"]:  # every rank holds the same weights, statistics and EMA after the step
        assert all(torch.equal(r["after"][k], ranks[0]["after"][k]) for r in ranks), k
        assert all(torch.equal(r["ema"][k], ranks[0]["ema"][k]) for r in ranks), k
    stats = {k: v for k, v in one["after"].items() if "running" in k}
    for r in ranks:
        _assert_state_close(r["after"], stats, "BN statistics", 1e-5, 1e-7)
    weights = {k: v for k, v in one["after"].items() if "running" not in k and "num_batches" not in k}
    _assert_state_close(ranks[0]["after"], weights, "weights", 1e-5, 1e-6)


def test_dp_step_matches_one_process(dp_step):
    _, one, ranks = dp_step
    assert len(ranks) == 2
    _assert_steps_equal(one, ranks, 1e-4)
    fg = torch.cat([r["fg_mask"][0] for r in ranks])
    assert torch.equal(fg, one["fg_mask"][0]) and fg.any()


def test_dp_tail_step_runs_unsharded(dp_data, tmp_path):
    """A global batch of 7 on 2 ranks: whole on each rank, local BN, 1/2 of the gradient each."""
    data, root = dp_data
    _, one, ranks = _dp_pair(data, root, tmp_path, "dp7", 7)
    _assert_steps_equal(one, ranks, 1e-4)
    assert all(torch.equal(r["fg_mask"][0], one["fg_mask"][0]) for r in ranks)


def test_dp_step_matches_jax_on_its_mesh(dp_data, dp_step):
    data, root = dp_data
    b, _, ranks = dp_step
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, root, "jax_dp8", batch=8, nbs=8))
    jm = JaxModel(NARROW, nc=3)
    jt.set_model(jm, *jm.init(0))
    jt._setup_train()
    assert jt.mesh is not None and jmesh.mesh_size(jt.mesh) == 8
    params, state = jmesh.replicate_tree(jt.mesh, jt.params), jmesh.replicate_tree(jt.mesh, jt.state)
    targets = jax_build_targets(b, 8, (128, 128), 16)
    grad_sum = jmesh.replicate_tree(jt.mesh, jax.tree.map(jnp.zeros_like, jt.params))
    grad_sum, state, _, jitems = jt._grad_step(
        params, state, grad_sum, jmesh.shard_batch(jt.mesh, b["img"]),
        *(jmesh.shard_batch(jt.mesh, targets[k]) for k in ("gt_labels", "gt_bboxes", "mask_gt")))
    np.testing.assert_allclose(ranks[0]["items"][0].numpy(), np.asarray(jitems), rtol=1e-4)
    model = DetectionModel(NARROW, nc=3)
    grads = ckpt.tree_of(model, {k: v for k, v in ranks[0]["grads"].items()})
    gl, wl = jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(_np(grad_sum))
    assert len(gl) == len(wl)
    floor = 1e-5 * max(np.linalg.norm(w) for w in wl)
    for (path, g), w in zip(gl, wl):
        assert _rel_l2(np.asarray(g), w, floor) <= GRAD_REL_L2, jax.tree_util.keystr(path)
    lr_vec = np.array([0.01, 0.02, 0.03], np.float32)
    jp, _, _, _, _, _ = jt._apply_step(params, jt.opt_state, grad_sum, jt.ema.ema_params, jt.ema.ema_state, state,
                                       jnp.asarray(lr_vec), jnp.float32(0.9), jnp.asarray(1))
    model.load_state_dict(ranks[0]["after"])
    p, s = ckpt.jax_trees(model)
    for got, want, what in ((p, _np(jp), "params"), (s, _np(state), "BN statistics")):
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, rtol=3e-5, atol=STEP_ATOL, err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_cross_rank_bn_keeps_batchnorm_keys():
    m = DetectionModel(NARROW, nc=3).init(0)
    keys = list(m.state_dict())
    from yololite_tpu_torch.models.modules import cross_rank_bn_

    cross_rank_bn_(m)
    assert list(m.state_dict()) == keys
    bns = [x for x in m.modules() if isinstance(x, torch.nn.BatchNorm2d)]
    assert bns and all(type(x) is CrossRankBatchNorm2d for x in bns)
    x = torch.randn(2, 3, 64, 64)
    m.train()
    y0 = [f.detach() for f in m(x)]
    m2 = DetectionModel(NARROW, nc=3).init(0).train()
    for a, b in zip(y0, m2(x)):  # outside cross_rank_bn(group) it is BatchNorm2d
        assert torch.equal(a, b.detach())
