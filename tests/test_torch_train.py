"""yololite_tpu_torch train vs the JAX package, on the CPU: one train step, augmentations, a loss curve, checkpoints.

Both trainers work on a narrow yolo11 (a few rows, widths 8-64) and a small
synthetic dataset under tmp_path, never on coco8. The JAX side runs its own
trainer's compiled `_grad_step` and `_apply_step` on the same uint8 batch and
padded targets as the port's eager step; init(seed) gives both packages the
same weights. One train step is held to: loss items within rtol 1e-4, each
gradient within GRAD_REL_L2 relative L2, and params, BN statistics, EMA params
and EMA statistics after the step within rtol 3e-5, atol STEP_ATOL.

GRAD_REL_L2 is 2e-3, not 1e-3: the BN backward's cancellation in the
narrow deep rows (8 channels, 32 values per channel at stride 32) makes the
port's own fp32 gradient of row 6's BN scale differ from its fp64 gradient
by 1.11e-3; the JAX package's differs from the port's by 1.16e-3 there (the
median leaf by 1.8e-4). Leaves whose exact gradient is zero (the BN biases
before C2PSA's residual sums, 1e-18 in fp64) are compared with their norm
floored at 1e-5 of the largest leaf's.

STEP_ATOL is 1e-5, not 1e-6: the forwards of the two frameworks drift apart
by about 1e-4 relative in the deepest rows (the tolerance of
tests/test_torch_model.py), so the BN running variances of rows 8 and 9 move
3.5e-6 apart in one step, and the SGD step turns the gradients' difference
into up to 7.8e-6 of weight (lr 0.02 x (1 + momentum 0.9)).
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu import YOLOLite as JaxYOLOLite
from yololite_tpu.cfg import get_cfg as jax_get_cfg
from yololite_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yololite_tpu.engine import trainer as jtrainer
from yololite_tpu.models import checkpoint as jckpt
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.utils.loss import build_targets as jax_build_targets

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.cfg import get_cfg
from yololite_tpu_torch.data.dataset import YOLODataset
from yololite_tpu_torch.engine import optim as toptim
from yololite_tpu_torch.engine import trainer as ttrainer
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.ops import optim_kernels
from yololite_tpu_torch.utils.ema import ema_decay

from tests.test_torch_nms import _safe_grid
from tests.test_torch_predict import _match_sets

REPO = Path(__file__).resolve().parents[1]

NARROW = {  # yolo11's blocks at strides 8/16/32, a few rows, narrow widths
    "nc": 3,
    "scale": "n",  # no scales table: widths as written; "n" keeps C3k2's c3k flags as written
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "C3k2", [16, False, 0.25]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "C3k2", [32, False, 0.25]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "C3k2", [32, True]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "SPPF", [64, 5]],
        [-1, 1, "C2PSA", [64]],
    ],
    "head": [[[4, 6, 9], 1, "Detect", ["nc"]]],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_dataset(root: Path, n_train: int, n_val: int, seed: int) -> Path:
    """PNG images with bright rectangles and their YOLO labels (3 classes) under root, and data.yaml."""
    import cv2

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = [(120, 160), (160, 120), (160, 160), (100, 150)][i % 4]
            im = rng.integers(0, 40, (h, w, 3)).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                bw, bh = rng.uniform(0.15, 0.45, 2)
                cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
                x0, y0 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
                im[y0:int((cy + bh / 2) * h), x0:int((cx + bw / 2) * w)] = rng.integers(80, 255, 3)
                rows.append(f"{int(rng.integers(0, 3))} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
            cv2.imwrite(str(root / "images" / split / f"im{i}.png"), im)
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(rows))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames: {{0: a, 1: b, 2: c}}\n")
    return root / "data.yaml"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, rtol, atol, what):
    gl, wl = jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)
    assert len(gl) == len(wl) > 0, what
    for (path, g), w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol, err_msg=f"{what} {jax.tree_util.keystr(path)}")


GRAD_REL_L2 = 2e-3
STEP_ATOL = 1e-5


def _rel_l2(a, b, floor=1e-30):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def _batch(seed, imgsz=128, B=2):
    """A uint8 NHWC batch with bright boxes and its ragged labels, as the loader gives them."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 40, (B, imgsz, imgsz, 3)).astype(np.uint8)
    bi, cls, boxes = [], [], []
    for b in range(B):
        for _ in range(int(rng.integers(2, 5))):
            wh = rng.uniform(0.15, 0.4, 2)
            c = rng.uniform(wh / 2, 1 - wh / 2)
            x0, y0 = (c - wh / 2) * imgsz
            x1, y1 = (c + wh / 2) * imgsz
            img[b, int(y0):int(y1), int(x0):int(x1)] = rng.integers(80, 255, 3)
            bi.append(b)
            cls.append(int(rng.integers(0, 3)))
            boxes.append([*c, *wh])
    return {"img": img, "batch_idx": np.array(bi, np.float32), "cls": np.array(cls, np.float32)[:, None],
            "bboxes": np.array(boxes, np.float32)}


def _overrides(data, root, name, **kw):
    return {"data": str(data), "epochs": 1, "imgsz": 128, "batch": 2, "workers": 0, "mode": "train",
            "project": str(root / "runs"), "name": name, "val": False, "plots": False, "optimizer": "SGD",
            "amp": False, "seed": 0, **kw}


def _trainers(data, root, name, **kw):
    """A JAX and a port trainer, set up on the same narrow init(0) model."""
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, root, f"jax_{name}", **kw))
    jm = JaxModel(NARROW, nc=3)
    jt.set_model(jm, *jm.init(0))
    jt._setup_train()
    tt = ttrainer.DetectionTrainer(overrides=_overrides(data, root, f"port_{name}", **kw), device="cpu")
    tt.set_model(DetectionModel(NARROW, nc=3).init(0))
    tt._setup_train()
    p, s = ckpt.jax_trees(tt.model)
    _assert_trees_close((p, s), (_np(jt.params), _np(jt.state)), 0, 0, "init")
    return jt, tt


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("traindata")
    return _write_dataset(root, n_train=4, n_val=2, seed=40), root


@pytest.fixture(scope="module", params=[1, 2], ids=["accumulate1", "accumulate2"])
def step_pair(request, dataset):
    """One optimizer step in both packages (accumulate micro-batches, then clip + SGD + EMA), and what it made."""
    data, root = dataset
    acc = request.param
    jt, tt = _trainers(data, root, f"step{acc}", nbs=2 * acc)
    assert jt.accumulate == tt.accumulate == acc and jt.weight_decay == tt.weight_decay
    copy_tree = lambda tr: jax.tree.map(lambda x: jnp.array(x, copy=True), tr)
    grad_sum = jax.tree.map(jnp.zeros_like, jt.params)
    state = copy_tree(jt.state)
    out = {"items": [], "jitems": []}
    for k in range(acc):
        b = _batch(41 + k)
        targets = jax_build_targets(b, 2, (128, 128), 16)
        grad_sum, state, _, jitems = jt._grad_step(jt.params, state, grad_sum, jnp.asarray(b["img"]),
                                                   *(jnp.asarray(targets[key]) for key in ("gt_labels", "gt_bboxes",
                                                                                          "mask_gt")))
        out["jitems"].append(np.asarray(jitems))
        out["items"].append(tt._grad_step(torch.from_numpy(b["img"]), tt._targets(b)).numpy())
    out["jgrads"] = _np(grad_sum)
    out["grads"] = ckpt.tree_of(tt.model, {n: p.grad for n, p in tt.model.named_parameters()})
    lr_vec, momentum = np.array([0.01, 0.02, 0.03], np.float32), 0.9
    jp, jo, _, jep, jes, _ = jt._apply_step(copy_tree(jt.params), copy_tree(jt.opt_state), grad_sum,
                                            copy_tree(jt.ema.ema_params), copy_tree(jt.ema.ema_state), state,
                                            jnp.asarray(lr_vec), jnp.float32(momentum), jnp.asarray(1))
    tt._apply_step(lr_vec, momentum)
    out.update(jparams=_np(jp), jstate=_np(state), jema=(_np(jep), _np(jes)), jopt=jo, jt=jt, tt=tt)
    # the JAX trainer's checkpoint of this step, for the resume test
    jt.params, jt.state, jt.opt_state = jp, state, jo
    jt.ema.ema_params, jt.ema.ema_state, jt.ema.updates = jep, jes, 1
    jt.save_model(0)
    jt._saver.flush()
    return out


def test_train_step_matches_jax(step_pair):
    o = step_pair
    for got, want in zip(o["items"], o["jitems"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert (got > 0).all()
    gl, wl = jax.tree_util.tree_leaves_with_path(o["grads"]), jax.tree.leaves(o["jgrads"])
    assert len(gl) == len(wl)
    floor = 1e-5 * max(np.linalg.norm(w) for w in wl)
    for (path, g), w in zip(gl, wl):
        assert _rel_l2(g, w, floor) <= GRAD_REL_L2, (jax.tree_util.keystr(path), _rel_l2(g, w, floor))
    tt = o["tt"]
    p, s = ckpt.jax_trees(tt.model)
    _assert_trees_close(p, o["jparams"], 3e-5, STEP_ATOL, "params")
    _assert_trees_close(s, o["jstate"], 3e-5, STEP_ATOL, "BN statistics")
    ep, es = ckpt.jax_trees(tt.ema.ema)
    _assert_trees_close(ep, o["jema"][0], 3e-5, STEP_ATOL, "EMA params")
    _assert_trees_close(es, o["jema"][1], 3e-5, STEP_ATOL, "EMA statistics")
    mu, _ = toptim.moments("SGD", tt.optimizer, dict(tt.model.named_parameters()))
    mu = jax.tree.leaves(ckpt.tree_of(tt.model, mu))
    for m, w in zip(mu, jax.tree.leaves(o["jopt"].mu)):  # SGD's first buffer is the clipped gradient
        assert _rel_l2(m, np.asarray(w), floor) <= GRAD_REL_L2
    assert tt.ema.updates == 1


def test_port_resumes_a_jax_checkpoint(step_pair, dataset):
    """The JAX trainer's last.npz resumes in the port: weights, EMA, SGD momentum and epoch come back."""
    data, root = dataset
    last = Path(step_pair["jt"].last)
    seen = {}

    class Checked(ttrainer.DetectionTrainer):
        def resume_training(self, blob):
            super().resume_training(blob)
            named = self._named_trainable()
            seen["mu"] = ckpt.tree_of(self.model, toptim.moments(self.opt_name, self.optimizer, named)[0])
            seen["params"], seen["ema"] = ckpt.jax_trees(self.model)[0], ckpt.jax_trees(self.ema.ema)[0]
            seen["start"], seen["updates"] = self.start_epoch, self.ema.updates

    _, state, _ = jckpt.load_native(last)
    t = Checked(overrides={"resume": str(last), "data": str(data), "workers": 0}, device="cpu")
    assert t.save_dir == Path(step_pair["jt"].save_dir)  # the run's own directory
    t.epochs = 2
    t.train()
    _assert_trees_close(seen["params"], _np(state["raw_params"]), 0, 0, "raw params")
    _assert_trees_close(seen["mu"], _np(state["opt"]["mu"]), 0, 0, "momentum")
    _assert_trees_close(seen["ema"], step_pair["jema"][0], 0, 0, "EMA")
    assert seen["start"] == 1 and seen["updates"] == 1 and t.epoch == 1
    rows = (Path(t.save_dir) / "results.csv").read_text().strip().splitlines()
    assert rows[-1].startswith("2,")


def test_jax_resumes_a_port_checkpoint(step_pair, dataset):
    """The port's last.npz resumes in the JAX trainer: its raw weights, EMA and optimizer moments load there."""
    data, root = dataset
    tt = step_pair["tt"]
    tt.save_model(0)
    tt._saver.flush()
    jt = jtrainer.DetectionTrainer(overrides={"resume": str(tt.last), "data": str(data), "workers": 0})
    jm = JaxModel(NARROW, nc=3)
    jt.set_model(jm, *jm.init(0))
    jt._setup_train()
    assert jt.start_epoch == 1 and jt.ema.updates == 1
    p, s = ckpt.jax_trees(tt.model)
    _assert_trees_close(_np(jt.params), p, 0, 0, "raw params")
    _assert_trees_close(_np(jt.state), s, 0, 0, "raw BN statistics")
    _assert_trees_close(_np(jt.ema.ema_params), ckpt.jax_trees(tt.ema.ema)[0], 0, 0, "EMA")
    mu, _ = toptim.moments("SGD", tt.optimizer, dict(tt.model.named_parameters()))
    _assert_trees_close(_np(jt.opt_state.mu), ckpt.tree_of(tt.model, mu), 0, 0, "momentum")


def _ema_host_floats(ema, model, updates):
    """The EMA update with its decay as Python floats (the form before the decay became a device tensor)."""
    d = ema_decay(updates)
    e_f, m_f = [], []
    with torch.no_grad():
        for e, m in zip(ema.state_dict().values(), model.state_dict().values()):
            if e.is_floating_point():
                e_f.append(e)
                m_f.append(m.detach())
            else:
                e.copy_(m)
        torch._foreach_mul_(e_f, d)
        torch._foreach_add_(e_f, torch._foreach_mul(m_f, float(np.float32(1) - np.float32(d))))


class _HostApply:
    """The apply with its scalars as host values: the plain clip, each rule step with lr and momentum made into
    fresh tensors from Python floats, the step counted on the host, moments of its own, the EMA's decay as Python
    floats."""

    def __init__(self, tr):
        self.opt = tr.optimizer
        self.mu = [torch.zeros_like(p) for p in self.opt.params]
        self.nu = [torch.zeros_like(p) for p in self.opt.params]
        self.step, self.extra = 0, torch.ones(())

    @torch.no_grad()
    def __call__(self, lr_vec, momentum):
        o = self.opt
        self.step += 1
        b1 = torch.tensor(float(np.float32(momentum)))
        s, extra = optim_kernels.step_scalars(o.name, torch.tensor(self.step, dtype=torch.int32), b1, self.extra)
        self.extra = self.extra if extra is None else extra
        scale = optim_kernels.clip_scale(optim_kernels.grad_norm_plain([p.grad for p in o.params]))
        for i, (p, gid) in enumerate(zip(o.params, o.groups)):
            g = p.grad * scale
            lr = torch.tensor(float(np.float32(lr_vec[gid])))
            p_new, self.mu[i], self.nu[i] = optim_kernels.rule_update(o.name, p, g, self.mu[i], self.nu[i], lr, b1,
                                                                      o.weight_decay, gid == 1, s)
            p.copy_(p_new)


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
@pytest.mark.parametrize("acc", [1, 2], ids=["accumulate1", "accumulate2"])
def test_step_scalars_in_tensors_match_host_floats(dataset, opt, acc):
    """Over a warmup ramp (lr, momentum and accumulate ramping in; accumulate 1 is the fused step), the trainer's
    step, with each group's lr, the momentum and the EMA decay in 0-d tensors written in place before each apply,
    the optimizer's step advanced on the device and its gradients allocated once and added into in place, gives
    the weights, BN statistics, EMA and loss items of the step with host floats, a host step count and set_to_none
    gradients, bit for bit. The reference (`_HostApply`) runs the port's own plain clip and rule steps, so this
    checks only the plumbing of the device scalars; the rules themselves are held to the JAX package's update
    functions in tests/test_torch_optim.py."""
    data, root = dataset
    kw = dict(nbs=2 * acc, optimizer=opt, imgsz=64)
    tt, ref = (ttrainer.DetectionTrainer(overrides=_overrides(data, root, f"{name}_{opt}{acc}", **kw), device="cpu")
               for name in ("scalars", "floats"))
    for t in (tt, ref):
        t.set_model(DetectionModel(NARROW, nc=3).init(0))
        t._setup_train()
    assert tt.fused == (acc == 1) and isinstance(tt.ema.d, torch.Tensor)
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0 for x in (*tt.optimizer.lr, tt.optimizer.momentum))
    host_apply = _HostApply(ref)
    for p in ref.model.parameters():
        p.grad = None
    nw, last, updates, applies = 5, -1, 0, 0
    batches = [_batch(60 + ni, imgsz=64) for ni in range(8)]
    for ni, ((staged, _), b) in enumerate(zip(tt.feed(batches), batches)):
        tt.accumulate, lr_vec, momentum = tt._schedule(ni, nw, 0)
        apply = tt.fused or ni - last >= tt.accumulate
        got = tt._train_batch(staged, apply, lr_vec, momentum)
        total, want, _ = ref.loss_fn.forward(ref._forward(torch.from_numpy(b["img"])), ref._targets(b))
        total.backward()
        if apply:
            host_apply(lr_vec, momentum)
            for p in ref.model.parameters():
                p.grad = None
            updates += 1
            _ema_host_floats(ref.ema.ema, ref.model, updates)
            last, applies = ni, applies + 1
        assert torch.equal(got, want), ni
        for what, a, b_ in (("weights", tt.model, ref.model), ("EMA", tt.ema.ema, ref.ema.ema)):
            for (k, x), y in zip(a.state_dict().items(), b_.state_dict().values()):
                assert torch.equal(x, y), (ni, what, k)
    assert tt.ema.updates == updates == applies and applies >= (8 if acc == 1 else 5)
    assert int(tt.optimizer.step) == host_apply.step == applies
    assert float(tt.optimizer.lr[1]) == float(np.float32(lr_vec[1]))
    assert float(tt.optimizer.momentum) == float(np.float32(momentum))


def test_multi_scale_grid_coarsens_like_jax(dataset):
    """Both trainers record the same 13 (batch shape, GT bucket) variants and draw the same multi-scale sizes: both
    switch from the /32 grid to /64 at the 13th variant, and give the same sizes before and after."""
    data, root = dataset
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, root, "jax_ms", multi_scale=True))
    tt = ttrainer.DetectionTrainer(overrides=_overrides(data, root, "port_ms", multi_scale=True), device="cpu")
    jt.imgsz = tt.imgsz = 128
    np.random.seed(7)  # the JAX trainer's draws come from np.random, the port's from its own generator
    tt.np_rng = np.random.RandomState(7)
    variants = [((2, 64 + 32 * (k % 6), 64 + 32 * (k % 6), 3), 16 << (k // 6)) for k in range(13)]
    img = np.zeros((2, 16, 16, 3), np.uint8)
    quants, sizes = [], []
    for k in range(24):
        got = [t.preprocess_batch({"img": img.copy()})["img"].shape[1] for t in (jt, tt)]
        assert got[0] == got[1], k
        if k < len(variants):
            for t in (jt, tt):
                t._track_compiles(*variants[k])
        assert jt._ms_quant == tt._ms_quant, k
        quants.append(tt._ms_quant)
        sizes.append(got[1])
    assert quants.index(64) == 12 and len(jt._step_shapes) == len(tt._step_shapes) == 13
    assert all(s % 32 == 0 for s in sizes[:13]) and any(s % 64 for s in sizes[:13])
    assert all(s % 64 == 0 for s in sizes[13:])


# ---------------- augmentations and the loader ----------------


@pytest.mark.parametrize("seed", [0, 5])
def test_augmented_items_match_jax(dataset, seed):
    """Mosaic, copy-paste, perspective, mixup, HSV and flips under aligned seeds: images bit-equal, labels within 1e-5."""
    data, root = dataset
    hyp = dict(imgsz=128, degrees=5.0, shear=2.0, perspective=0.0005, flipud=0.5, mixup=0.5, copy_paste=0.5)
    kw = dict(imgsz=128, batch_size=2, augment=True, data={"names": {0: "a", 1: "b", 2: "c"}})
    images = str(root / "images" / "train")
    random.seed(seed)
    np.random.seed(seed)
    want = JaxYOLODataset(images, hyp=jax_get_cfg(overrides=hyp), **kw)
    got = YOLODataset(images, hyp=get_cfg(overrides=hyp), seed=seed, **kw)
    n_boxes = 0
    for i in [0, 1, 2, 3, 2, 0, 3, 1]:
        g, w = got[i], want[i]
        assert set(g) == set(w)
        assert g["img"].shape == (128, 128, 3) and g["img"].flags.c_contiguous
        np.testing.assert_array_equal(g["img"], w["img"])
        np.testing.assert_array_equal(g["cls"], w["cls"])
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=0, atol=1e-5)
        n_boxes += len(g["cls"])
    assert got.buffer == want.buffer and n_boxes > 0


def test_close_mosaic_and_train_transforms(dataset):
    """close_mosaic turns mosaic, copy-paste and mixup off; a rect train set never mosaics."""
    data, root = dataset
    images = str(root / "images" / "train")
    hyp = get_cfg(overrides={"imgsz": 128, "mixup": 0.5})
    ds = YOLODataset(images, imgsz=128, augment=True, hyp=hyp, data={"names": {0: "a", 1: "b", 2: "c"}})
    assert hyp.mosaic == 1.0
    ds.close_mosaic(hyp)
    assert hyp.mosaic == hyp.mixup == hyp.copy_paste == 0.0
    assert ds[0]["img"].shape == (128, 128, 3)
    rect_hyp = get_cfg(overrides={"imgsz": 128})
    YOLODataset(images, imgsz=128, augment=True, hyp=rect_hyp, rect=True, data={"names": {0: "a", 1: "b", 2: "c"}})
    assert rect_hyp.mosaic == 0.0


def test_short_loss_curve_matches_jax(dataset):
    """2 epochs x 2 batches through both trainers' loops (mosaic on, workers=0): each epoch's mean loss items within 1e-3.

    The JAX transforms draw from the process-wide random and np.random, the
    port's from generators seeded with args.seed; seeding the former alike
    gives both loops the same images. Warmup moves accumulate from 1 to 2 and
    'auto' picks AdamW.
    """
    data, root = dataset
    kw = dict(epochs=2, imgsz=96, close_mosaic=0, optimizer="auto", multi_scale=False)
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, root, "jax_curve", **kw))
    jm = JaxModel(NARROW, nc=3)
    jt.set_model(jm, *jm.init(0))
    random.seed(0)
    jt.train()
    tt = ttrainer.DetectionTrainer(overrides=_overrides(data, root, "port_curve", **kw), device="cpu")
    tt.set_model(DetectionModel(NARROW, nc=3).init(0))
    tt.train()
    assert tt.opt_name == jt.opt_name == "AdamW" and tt.args.warmup_bias_lr == 0.0
    rows = [np.loadtxt(t.csv, delimiter=",", skiprows=1, ndmin=2) for t in (jt, tt)]
    header = [t.csv.read_text().splitlines()[0] for t in (jt, tt)]
    assert header[0] == header[1] and rows[0].shape == rows[1].shape == (2, len(header[0].split(",")))
    np.testing.assert_allclose(rows[1][:, 1:4], rows[0][:, 1:4], rtol=1e-3)
    np.testing.assert_allclose(rows[1][:, -3:], rows[0][:, -3:], rtol=1e-6)  # the lr columns
    assert len(tt.train_seconds) == 2 and tt.last.exists() and not tt.best.exists()  # no val, no best


# ---------------- checkpoints ----------------


def _separating(model):
    """Weights whose candidates do not tie (tests/test_torch_val.py val_pair), BN statistics perturbed."""
    rng = np.random.default_rng(43)
    grid = _safe_grid()
    mid = grid[(grid > -5) & (grid < 0)]
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 4:
                p.mul_(2.5)
        for seq, s in zip(model.detect.cv3, (100.0, 400.0, 1000.0)):
            seq[2].weight.mul_(s)
            seq[2].bias.copy_(torch.from_numpy(mid[rng.integers(0, len(mid), seq[2].bias.shape[0])]))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.add_(torch.from_numpy(rng.uniform(-0.1, 0.1, m.num_features).astype(np.float32)))
                m.running_var.mul_(torch.from_numpy(rng.uniform(0.8, 1.2, m.num_features).astype(np.float32)))
    return model


def test_port_checkpoint_predicts_the_same_in_jax(dataset, tmp_path):
    """The port trainer's last.npz loads in the JAX package's load_native and predicts the same detections there."""
    data, root = dataset
    t = ttrainer.DetectionTrainer(overrides=_overrides(data, tmp_path, "ck"), device="cpu")
    t.set_model(_separating(DetectionModel(NARROW, nc=3).init(0)))
    t._setup_train()
    t.save_model(0)
    t._saver.flush()
    params, state, meta = jckpt.load_native(t.last)
    assert set(state) == {"model_state", "raw_params", "raw_state", "opt"} and meta["epoch"] == 0
    _assert_trees_close(_np(params), ckpt.jax_trees(t.model)[0], 0, 0, "EMA params")
    files = sorted(str(f) for f in (root / "images" / "val").iterdir())
    kw = dict(conf=0.01, imgsz=128, batch=2, save=False, verbose=False)
    want = JaxYOLOLite(str(t.last)).predict(files, **kw)
    got = YOLOLite(str(t.last), device="cpu").predict(files, **kw)
    for g, w in zip(got, want):
        gd, wd = g.boxes.data, w.boxes.data
        assert len(gd) == len(wd) > 0
        assert _match_sets(wd, gd) == len(wd)


def test_save_is_atomic_and_strip_optimizer_works(tmp_path, monkeypatch):
    params = {"0": {"conv": {"w": np.ones((3, 3, 3, 8), np.float32)}}}
    state = {"model_state": {"0": {"bn": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}},
             "opt": {"mu": {"0": {"conv": {"w": np.zeros((3, 3, 3, 8), np.float32)}}}}}
    p = tmp_path / "w" / "last.npz"
    ckpt.save_native(p, params, state, {"epoch": 7, "ema_updates": 123})
    assert p.exists() and not list(p.parent.glob("*.tmp"))

    def broken(f, **kw):  # a write that dies half way
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_native(p, params, state, {"epoch": 8})
    monkeypatch.undo()
    assert not list(p.parent.glob("*.tmp"))
    assert ckpt.load_native(p)[2]["epoch"] == 7  # the last good checkpoint stands

    out = ckpt.strip_optimizer(p, tmp_path / "slim.npz")
    for load in (ckpt.load_native, jckpt.load_native):
        p2, s2, m2 = load(out)
        assert m2["epoch"] == -1 and "ema_updates" not in m2
        assert set(s2) == {"0"}  # the EMA's BN statistics, no training state
        np.testing.assert_array_equal(np.asarray(p2["0"]["conv"]["w"]), params["0"]["conv"]["w"])


def test_facade_save_and_load_roundtrip(tmp_path):
    """YOLOLite.save writes the native format: both packages load it to the same weights."""
    m = YOLOLite(NARROW, device="cpu")
    _separating(m.model)
    path = tmp_path / "w.npz"
    m.save(path)
    m2 = YOLOLite(str(path), device="cpu")
    for (k, a), b in zip(m.model.state_dict().items(), m2.model.state_dict().values()):
        assert torch.equal(a, b), k
    jm = JaxYOLOLite(str(path))
    _assert_trees_close(_np(jm.params), ckpt.jax_trees(m.model)[0], 0, 0, "params")
    _assert_trees_close(_np(jm.state), ckpt.jax_trees(m.model)[1], 0, 0, "BN statistics")
    with pytest.raises(FileNotFoundError):
        ckpt.attempt_load_one_weight(str(tmp_path / "missing.pt"))


# ---------------- smaller units ----------------


@pytest.mark.parametrize("patience", [0, 2, 3])
def test_early_stopping_matches_jax(patience):
    fits = [0.5, 0.4, 0.45, 0.3, 0.6, 0.6, 0.2, 0.1, None, 0.1, 0.0]
    a, b = ttrainer.EarlyStopping(patience), jtrainer.EarlyStopping(patience)
    assert [a(e, f) for e, f in enumerate(fits)] == [b(e, f) for e, f in enumerate(fits)]
    assert (a.best_epoch, a.best_fitness, a.possible_stop) == (b.best_epoch, b.best_fitness, b.possible_stop)


def test_one_cycle_matches_jax():
    f, g = ttrainer.one_cycle(1, 0.01, 10), jtrainer.one_cycle(1, 0.01, 10)
    assert [f(x) for x in range(11)] == [g(x) for x in range(11)]


def test_save_metrics_schema_matches_jax(tmp_path):
    """results.csv: the columns are fixed at the first write, a resume adopts the file's; the same text as JAX's."""

    class _M:
        keys = ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]

    class _V:
        metrics = _M()

    texts = []
    for cls, name in ((jtrainer.DetectionTrainer, "jax"), (ttrainer.DetectionTrainer, "port")):
        t = object.__new__(cls)
        t.csv = tmp_path / f"{name}.csv"
        t.loss_names = ["box_loss", "cls_loss", "dfl_loss"]
        t.metrics = None
        t.lr = {"lr/pg0": 0.01, "lr/pg1": 0.01, "lr/pg2": 0.01}
        t.validator = _V()
        t.save_metrics(0, np.array([1.0, 2.0, 3.0]))
        t.metrics = {"metrics/precision(B)": 0.5, "metrics/recall(B)": 0.4, "metrics/mAP50(B)": 0.3,
                     "metrics/mAP50-95(B)": 0.2, "fitness": 0.21}
        t.save_metrics(1, np.array([0.9, 1.8, 2.7]))
        t2 = object.__new__(cls)  # a resumed run adopts the file's columns
        t2.csv, t2.loss_names, t2.validator = t.csv, t.loss_names, None
        t2.metrics, t2.lr = {"metrics/mAP50(B)": 0.35, "other": 1.0}, {"lr/pg0": 0.02}
        t2.save_metrics(2, np.array([0.5, 0.6, 0.7]))
        texts.append(t.csv.read_text())
    assert texts[0] == texts[1]
    rows = texts[1].strip().splitlines()
    assert len({len(r.split(",")) for r in rows}) == 1 and len(rows) == 4


def test_async_saver_writes_in_order_and_errors_surface():
    import threading
    import time

    s = ttrainer._AsyncSaver()
    order, gate, submitted = [], threading.Event(), []
    s.submit(lambda: (gate.wait(5), order.append("epoch1")))
    th = threading.Thread(target=lambda: (s.submit(lambda: order.append("epoch2")), submitted.append(1)))
    th.start()
    time.sleep(0.2)
    assert not submitted  # a submit waits for the write before it: none is dropped
    gate.set()
    th.join(5)
    assert not th.is_alive()
    s.flush()
    assert order == ["epoch1", "epoch2"]
    s.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    s.submit(lambda: order.append("epoch3"))  # a failed write is logged, the next one still runs
    with pytest.raises(OSError, match="disk full"):
        s.flush()
    assert order[-1] == "epoch3"
    s.submit(lambda: None)
    s.flush()


def test_trainer_val_runs_the_current_ema_unfused(dataset, tmp_path):
    """Each trainer val runs the EMA as it stands: eval mode, BN unfused, the EMA module itself (whose weights move
    in place), through the validator's one graph cache for a trainer's vals, never the standalone one."""
    data, root = dataset
    t = ttrainer.DetectionTrainer(overrides=_overrides(data, tmp_path, "val", val=True), device="cpu")
    t.set_model(DetectionModel(NARROW, nc=3).init(0))
    t._setup_train()
    nets = []
    build = t.validator._build_infer

    def spy(net, model, half, graphs=None):
        nets.append((net, [m.running_mean.clone() for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)],
                     graphs))
        return build(net, model, half, graphs)

    t.validator._build_infer = spy
    stats = t.validate()
    with torch.no_grad():
        for m in t.ema.ema.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.add_(0.5)
    t.validate()
    assert len(nets) == 2 and nets[0][0] is nets[1][0] is t.ema.ema and not t.ema.ema.training
    assert nets[0][2] is nets[1][2] is t.validator.ema_graphs  # one cache across the trainer's vals
    assert len(nets[0][1]) > 0  # BN still there: unfused
    assert not torch.equal(nets[0][1][0], nets[1][1][0])  # the second val saw the moved statistics
    assert t.validator._infer is None and "fitness" in stats and t.fitness == stats["fitness"]


def test_facade_train_in_a_fresh_process_imports_no_jax(dataset, tmp_path):
    """YOLOLite(..., device='cpu').train() end to end (val, best.npz reload) with jax and yololite_tpu never imported."""
    data, _ = dataset
    code = ("import sys\n"
            "from yololite_tpu_torch import YOLOLite\n"
            "m = YOLOLite('yolo11n.yaml', device='cpu')\n"
            f"r = m.train(data={str(data)!r}, epochs=1, imgsz=64, batch=2, workers=0, plots=False,\n"
            f"            project={str(tmp_path / 'runs')!r}, name='fresh')\n"
            "assert r is m.metrics and 'fitness' in r and m.trainer.best.exists()\n"
            "assert m.ckpt['epoch'] == 0 and m.overrides['model'].endswith('best.npz')\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'yololite_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "runs" / "fresh" / "results.csv").exists()
