"""One train step of a zoo model in yololite_tpu_torch against the JAX trainer, and its checkpoints, on the CPU.

This file holds YOLOv10-N (`cfg.dicts.YOLOV10N`, trained by E2EDetectLoss:
one2many and one2one branches); tests/test_torch_zoo_train_gelan.py runs the
same tests on GELAN-T (`cfg.dicts.GELAN_T`, v8DetectionLoss), as a file of its
own so that the two spread over workers. The model (`MODEL`), at full width
with a 3-class head, takes one step on the small synthetic dataset and batch
of tests/test_torch_train.py: the JAX trainer's `_grad_step` and `_apply_step`
against the port's eager step from the same init(0) weights. Loss items are
held to JAX's within rtol 1e-4; params, BN statistics, EMA params and
statistics after the step within rtol 3e-5, atol STEP_ATOL.

Each gradient and each SGD momentum is also held to the same step taken by
the port in float64 (weights, batch and targets in float64 on the CPU, the
method of tools/train_step_precision.py): the port's within GRAD_REL_L2
relative L2 and no farther than the JAX step's, and the JAX step's within
JAX_FROM_FLOAT64, so that a defect shared by the port's fp32 and float64
steps (a wrong term in a loss or its backward) still fails against JAX.
The models of DIRECT_TO_JAX have their gradients and momentum held to the
JAX step directly as well, within GRAD_REL_L2.

GELAN-T is not among them: held directly to the JAX step, its gradients
came out 2.17e-3 apart at row 18's output BN on one host (and within 2e-3
on another). The port's step lies 7.0e-4 from float64 there, the JAX step
1.92e-3 (YOLOv10-N: 1.8e-4 and 4.9e-4). The JAX step's fp32 arithmetic is
the farther one, with the same max-pool and assigner picks in both steps
and loss gradients within 1e-6 on the same maps; its forward already lies
1.5e-6 from float64 after row 0 against the port's 2.1e-7 (XLA's fp32
batch statistics, and the BN folded as x * inv + (bias - mean * inv)).

JAX_FROM_FLOAT64 is 4e-3, about twice the largest distance of the JAX step
from float64 measured on any leaf (1.92e-3, GELAN-T's row 18), since that
distance moves with the host's XLA code; a wrong loss-gradient term moves
the leaves it reaches by far more.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.engine import trainer as jtrainer
from yololite_tpu.models import checkpoint as jckpt
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.utils.loss import build_targets as jax_build_targets

from yololite_tpu_torch.cfg.dicts import GELAN_T, YOLOV10N
from yololite_tpu_torch.engine import optim as toptim
from yololite_tpu_torch.engine import trainer as ttrainer
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel

from tests.test_torch_train import (GRAD_REL_L2, STEP_ATOL, _assert_trees_close, _batch, _np, _overrides, _rel_l2,
                                    _write_dataset)

SPECS = {"yolov10n": YOLOV10N, "gelan-t": GELAN_T}
MODEL = "yolov10n"  # the spec this module runs (SPECS key)
DIRECT_TO_JAX = ("yolov10n",)  # gradients and momentum also held to the JAX step's within GRAD_REL_L2
JAX_FROM_FLOAT64 = 4e-3  # the JAX step's gradients and momentum from the port's float64 step (see above)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("zootrain")
    return _write_dataset(root, n_train=4, n_val=2, seed=40), root


@pytest.fixture(scope="module")
def step_pair(request, dataset):
    """One optimizer step of the model in both packages from init(0), and what it made."""
    data, root = dataset
    name = request.module.MODEL
    spec = SPECS[name]
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, root, f"jax_{name}", nbs=2))
    jm = JaxModel(spec, nc=3)
    jt.set_model(jm, *jm.init(0))
    jt._setup_train()
    tt = ttrainer.DetectionTrainer(overrides=_overrides(data, root, f"port_{name}", nbs=2), device="cpu")
    tt.set_model(DetectionModel(spec, nc=3).init(0))
    tt._setup_train()
    _assert_trees_close(ckpt.jax_trees(tt.model), (_np(jt.params), _np(jt.state)), 0, 0, "init")
    assert type(jt.loss_fn).__name__ == type(tt.loss_fn).__name__ == (
        "E2EDetectLoss" if name == "yolov10n" else "v8DetectionLoss")
    copy_tree = lambda tr: jax.tree.map(lambda x: jnp.array(x, copy=True), tr)
    b = _batch(41)
    targets = jax_build_targets(b, 2, (128, 128), 16)
    grad_sum, state, _, jitems = jt._grad_step(
        jt.params, copy_tree(jt.state), jax.tree.map(jnp.zeros_like, jt.params), jnp.asarray(b["img"]),
        *(jnp.asarray(targets[key]) for key in ("gt_labels", "gt_bboxes", "mask_gt")))
    items = tt._grad_step(torch.from_numpy(b["img"]), tt._targets(b)).numpy()
    grads = ckpt.tree_of(tt.model, {n: p.grad for n, p in tt.model.named_parameters()})
    jgrads = _np(grad_sum)  # before the apply step, which donates grad_sum
    lr_vec, momentum = np.array([0.01, 0.02, 0.03], np.float32), 0.9
    jp, jo, _, jep, jes, _ = jt._apply_step(copy_tree(jt.params), copy_tree(jt.opt_state), grad_sum,
                                            copy_tree(jt.ema.ema_params), copy_tree(jt.ema.ema_state), state,
                                            jnp.asarray(lr_vec), jnp.float32(momentum), jnp.asarray(1))
    tt._apply_step(lr_vec, momentum)
    # the same step in float64: weights, the batch in [0, 1] and the targets (the loss keeps its fp32 parts)
    tf = ttrainer.DetectionTrainer(overrides=_overrides(data, root, f"float64_{name}", nbs=2), device="cpu")
    tf.set_model(DetectionModel(spec, nc=3).init(0).double())
    tf._setup_train()
    tf._grad_step(torch.from_numpy(b["img"]).double() / 255.0,
                  {k: v.double() if v.is_floating_point() else v for k, v in tf._targets(b).items()})
    f64_grads = ckpt.tree_of(tf.model, {n: p.grad for n, p in tf.model.named_parameters()})
    tf._apply_step(lr_vec, momentum)
    f64_mu = ckpt.tree_of(tf.model, toptim.moments("SGD", tf.optimizer, dict(tf.model.named_parameters()))[0])
    out = dict(items=items, jitems=np.asarray(jitems), grads=grads, jgrads=jgrads, jparams=_np(jp),
               jstate=_np(state), jema=(_np(jep), _np(jes)), jopt=jo, jt=jt, tt=tt, name=name,
               f64_grads=f64_grads, f64_mu=f64_mu)
    # the JAX trainer's checkpoint of this step, for the resume test
    jt.params, jt.state, jt.opt_state = jp, state, jo
    jt.ema.ema_params, jt.ema.ema_state, jt.ema.updates = jep, jes, 1
    jt.save_model(0)
    jt._saver.flush()
    return out


def _worst_from_float64(got, exact, floor):
    """(relative L2, leaf) of the leaf of `got` farthest from the float64 step's."""
    gl, el = jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(exact)
    assert len(gl) == len(el)
    return max((_rel_l2(np.asarray(g, np.float64), np.asarray(e, np.float64), floor), jax.tree_util.keystr(path))
               for (path, g), e in zip(gl, el))


def test_train_step_matches_jax(step_pair):
    o = step_pair
    np.testing.assert_allclose(o["items"], o["jitems"], rtol=1e-4)
    assert (o["items"] > 0).all()
    floor = 1e-5 * max(np.linalg.norm(e) for e in jax.tree.leaves(o["f64_grads"]))
    port = _worst_from_float64(o["grads"], o["f64_grads"], floor)
    ref = _worst_from_float64(o["jgrads"], o["f64_grads"], floor)
    direct = _worst_from_float64(o["grads"], o["jgrads"], floor)
    print(f"{o['name']}: worst gradient relative L2 from the float64 step: port {port}, JAX {ref}; port from JAX "
          f"{direct}")
    assert port[0] <= GRAD_REL_L2, port
    assert port[0] <= ref[0], (port, ref)
    assert ref[0] <= JAX_FROM_FLOAT64, ref
    if o["name"] in DIRECT_TO_JAX:
        assert direct[0] <= GRAD_REL_L2, direct
    tt = o["tt"]
    p, s = ckpt.jax_trees(tt.model)
    _assert_trees_close(p, o["jparams"], 3e-5, STEP_ATOL, "params")
    _assert_trees_close(s, o["jstate"], 3e-5, STEP_ATOL, "BN statistics")
    ep, es = ckpt.jax_trees(tt.ema.ema)
    _assert_trees_close(ep, o["jema"][0], 3e-5, STEP_ATOL, "EMA params")
    _assert_trees_close(es, o["jema"][1], 3e-5, STEP_ATOL, "EMA statistics")
    mu, _ = toptim.moments("SGD", tt.optimizer, dict(tt.model.named_parameters()))
    mu = ckpt.tree_of(tt.model, mu)
    mu_floor = 1e-5 * max(np.linalg.norm(e) for e in jax.tree.leaves(o["f64_mu"]))
    port_mu = _worst_from_float64(mu, o["f64_mu"], mu_floor)
    ref_mu = _worst_from_float64(o["jopt"].mu, o["f64_mu"], mu_floor)
    direct_mu = _worst_from_float64(mu, o["jopt"].mu, mu_floor)
    print(f"{o['name']}: worst momentum relative L2 from the float64 step: port {port_mu}, JAX {ref_mu}; port from "
          f"JAX {direct_mu}")
    assert port_mu[0] <= GRAD_REL_L2, port_mu
    assert port_mu[0] <= ref_mu[0], (port_mu, ref_mu)
    assert ref_mu[0] <= JAX_FROM_FLOAT64, ref_mu
    if o["name"] in DIRECT_TO_JAX:
        assert direct_mu[0] <= GRAD_REL_L2, direct_mu


def test_port_resumes_a_jax_checkpoint(step_pair, dataset):
    """The JAX trainer's last.npz resumes in the port: raw weights, EMA, SGD momentum and epoch come back."""
    data, _ = dataset
    last = Path(step_pair["jt"].last)
    seen = {}

    class Checked(ttrainer.DetectionTrainer):
        def resume_training(self, blob):
            super().resume_training(blob)
            named = self._named_trainable()
            seen["mu"] = ckpt.tree_of(self.model, toptim.moments(self.opt_name, self.optimizer, named)[0])
            seen["params"], seen["ema"] = ckpt.jax_trees(self.model)[0], ckpt.jax_trees(self.ema.ema)[0]
            seen["start"], seen["updates"] = self.start_epoch, self.ema.updates

        def train(self):  # set-up and restore only
            self._setup_train()

    _, state, _ = jckpt.load_native(last)
    Checked(overrides={"resume": str(last), "data": str(data), "workers": 0}, device="cpu").train()
    _assert_trees_close(seen["params"], _np(state["raw_params"]), 0, 0, "raw params")
    _assert_trees_close(seen["mu"], _np(state["opt"]["mu"]), 0, 0, "momentum")
    _assert_trees_close(seen["ema"], step_pair["jema"][0], 0, 0, "EMA")
    assert seen["start"] == 1 and seen["updates"] == 1


def test_jax_resumes_a_port_checkpoint(step_pair, dataset):
    """The port's last.npz resumes in the JAX trainer: its raw weights, EMA and optimizer moments load there."""
    data, _ = dataset
    tt = step_pair["tt"]
    tt.save_model(0)
    tt._saver.flush()
    jt = jtrainer.DetectionTrainer(overrides={"resume": str(tt.last), "data": str(data), "workers": 0})
    jm = JaxModel(SPECS[step_pair["name"]], nc=3)
    jt.set_model(jm, *jm.init(0))
    jt._setup_train()
    assert jt.start_epoch == 1 and jt.ema.updates == 1
    p, s = ckpt.jax_trees(tt.model)
    _assert_trees_close(_np(jt.params), p, 0, 0, "raw params")
    _assert_trees_close(_np(jt.state), s, 0, 0, "raw BN statistics")
    _assert_trees_close(_np(jt.ema.ema_params), ckpt.jax_trees(tt.ema.ema)[0], 0, 0, "EMA")
    mu, _ = toptim.moments("SGD", tt.optimizer, dict(tt.model.named_parameters()))
    _assert_trees_close(_np(jt.opt_state.mu), ckpt.tree_of(tt.model, mu), 0, 0, "momentum")
