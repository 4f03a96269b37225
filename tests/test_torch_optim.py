"""The port's optimizer and apply (engine/optim.py, ops/optim_kernels.py: K10's plain version) vs the JAX package,
on the CPU.

The same numpy-seeded weights and gradients go through the JAX package's
update functions (`joptim.UPDATES`), its `clip_by_global_norm` and
`ema_update`, composed as its trainer's `apply_step` composes them, and
through the port's `Optimizer.apply`, whose lr and momentum are device
scalars that move every step. A tiny model holds the three groups and a
frozen row. The kernel itself runs on the card only: tests/test_torch_kernels.py
holds it to the plain version there, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.engine import optim as joptim
from yololite_tpu.utils import ema as jema

from yololite_tpu_torch.engine import optim as toptim
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.ops import optim_kernels as OK
from yololite_tpu_torch.utils import ema as tema

from tests.test_torch_loss import _Tiny, _port_apply, _port_optimizer

WD = 0.05
# a warmup ramp: every step moves the three groups' lr and the momentum; 7 steps take RAdam past its rectification
# threshold (rho_t > 5 from step 6)
RAMP = [([0.0, 0.001, 0.002], 0.8), ([0.01, 0.02, 0.03], 0.82), ([0.02, 0.01, 0.005], 0.85),
        ([0.005, 0.03, 0.01], 0.87), ([0.03, 0.005, 0.02], 0.9), ([0.01, 0.01, 0.01], 0.9), ([0.02, 0.02, 0.02], 0.9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name, model):
    return _port_optimizer(name, model, WD)


def _port_step(model, opt, ema, grads, lr_vec, momentum):
    return _port_apply(opt, ema, dict(model.named_parameters()), grads, lr_vec, momentum)


def _jax(model):
    """The JAX side's params, state, labels, trainable mask and optimizer state, from the port's model."""
    params, state = ckpt.jax_trees(model)
    labels = joptim.build_group_labels(params)
    trainable = {k: jax.tree.map(lambda _: 0.0 if k == "2" else 1.0, v) for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    return jp, jax.tree.map(jnp.asarray, state), labels, trainable, joptim.init_state(jp)


def _grads(model, rng, scale):
    """Gradients by parameter name (the frozen row's too; the port never reads them) and the JAX tree, with the
    frozen row's zeroed as the JAX trainer's freeze mask does."""
    grads = {n: (rng.standard_normal(p.shape) * scale).astype(np.float32) for n, p in model.named_parameters()}
    jgrads = ckpt.tree_of(model, {n: torch.from_numpy(g) * (0.0 if n.startswith("model.2.") else 1.0)
                                  for n, g in grads.items()})
    return grads, jax.tree.map(jnp.asarray, jgrads)


def _close(mine, theirs, what, rtol=1e-6, atol=1e-7, atol_rel=0.0):
    """Leaf by leaf within rtol and atol, or atol_rel times the leaf's largest magnitude where that is larger."""
    a, b = jax.tree.leaves(mine), jax.tree.leaves(theirs)
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        y = np.asarray(y)
        tol = max(atol, atol_rel * float(np.abs(y).max(initial=0.0)))
        np.testing.assert_allclose(np.asarray(x), y, rtol=rtol, atol=tol, err_msg=what)


def _moments(name, opt, model):
    mu, nu = toptim.moments(name, opt, dict(model.named_parameters()))
    return ckpt.tree_of(model, mu), ckpt.tree_of(model, nu)


@pytest.mark.parametrize("name", list(toptim.OPTIMIZERS))
def test_rule_matches_jax_over_a_warmup_ramp(name):
    """7 steps with each group's lr and the momentum moving every step, gradients under the clip's norm (its factor
    is then exactly 1): params, mu, nu, the step and NAdam's mu_product equal the JAX update's at rtol 1e-6, atol
    1e-7; the frozen row is untouched."""
    model = _Tiny()
    opt, ema = _port(name, model)
    assert [opt.groups.count(g) for g in range(3)] == [2, 2, 1]  # bias, weight, bn; row 2 frozen
    jp, _, labels, trainable, jstate = _jax(model)
    frozen = ckpt.jax_trees(model)[0]["2"]
    rng = np.random.default_rng(40)
    for lr_vec, momentum in RAMP:
        grads, jgrads = _grads(model, rng, 0.05)
        clip = _port_step(model, opt, ema, grads, lr_vec, momentum)
        assert float(clip[1]) == 1.0 and 0 < float(clip[0]) < 10
        jp, jstate = joptim.UPDATES[name](jp, jgrads, jstate, labels, jnp.asarray(np.float32(lr_vec)),
                                          jnp.float32(momentum), WD, trainable=trainable)
    _close(ckpt.jax_trees(model)[0], jp, "params")
    mu, nu = _moments(name, opt, model)
    _close(mu, jstate.mu, "mu")
    _close(nu, jstate.nu, "nu")
    assert int(opt.step) == int(jstate.step) == len(RAMP)
    np.testing.assert_allclose(float(opt.extra), float(jstate.extra), rtol=1e-6)
    _close(ckpt.jax_trees(model)[0]["2"], frozen, "frozen row", rtol=0, atol=0)


@pytest.mark.parametrize("name", list(toptim.OPTIMIZERS))
def test_whole_apply_matches_jax_apply_step(name):
    """The whole apply (clip to norm 10, the rule, the gradients zeroed, the EMA of the weights and of the BN
    statistics, which move between steps) against JAX's clip_by_global_norm, UPDATES and ema_update composed as
    its apply_step composes them, with gradients far over the clip's norm.

    The norm: rtol 1e-6. The rest: rtol 1e-6, and an atol of 1e-6 times each leaf's largest magnitude: the port
    sums the squares in fp64 and XLA in fp32, so the two norms (and clip factors) can be an ulp apart (2 of these
    5 steps), which moves every clipped gradient by up to an ulp of its own size; a sum of such gradients that
    cancels to a small value (SGD's buffer) keeps that absolute error.
    """
    model = _Tiny()
    opt, ema = _port(name, model)
    jp, js, labels, trainable, jstate = _jax(model)
    jep, jes = jp, js
    rng = np.random.default_rng(41)
    for u, (lr_vec, momentum) in enumerate(RAMP[:5], start=1):
        with torch.no_grad():
            for k, t in model.state_dict().items():
                if "running" in k:
                    t.add_(torch.from_numpy(rng.uniform(0, 0.5, t.shape).astype(np.float32)))
        js = jax.tree.map(jnp.asarray, ckpt.jax_trees(model)[1])
        grads, jgrads = _grads(model, rng, 4.0)
        clip = _port_step(model, opt, ema, grads, lr_vec, momentum)
        jclipped, jnorm = joptim.clip_by_global_norm(jgrads, 10.0)
        np.testing.assert_allclose(float(clip[0]), float(jnorm), rtol=1e-6)
        assert float(clip[1]) < 1
        jp, jstate = joptim.UPDATES[name](jp, jclipped, jstate, labels, jnp.asarray(np.float32(lr_vec)),
                                          jnp.float32(momentum), WD, trainable=trainable)
        jep = jema.ema_update(jep, jp, jnp.asarray(u))
        jes = jema.ema_update(jes, js, jnp.asarray(u))
        assert all(not bool(p.grad.any()) for p in opt.params)  # zeroed in place
    _close(ckpt.jax_trees(model)[0], jp, "params", atol_rel=1e-6)
    mu, nu = _moments(name, opt, model)
    _close(mu, jstate.mu, "mu", atol_rel=1e-6)
    _close(nu, jstate.nu, "nu", atol_rel=1e-6)
    ep, es = ckpt.jax_trees(ema.ema)
    _close(ep, jep, "EMA params", atol_rel=1e-6)
    _close(es, jes, "EMA statistics", atol_rel=1e-6)
    assert ema.updates == 5


@pytest.mark.parametrize("name", list(toptim.OPTIMIZERS))
def test_resume_after_two_steps_equals_an_unbroken_third(name):
    """moments and load_moments after 2 applies (a fresh optimizer, the step and NAdam's mu_product restored from
    the count) give the unbroken run's 3rd apply: bit for bit, NAdam within 1e-6 (its mu_product comes back from
    float64 as the JAX package's resume computes it)."""
    runs = []
    for resume in (False, True):
        model = _Tiny()
        opt, ema = _port(name, model)
        rng = np.random.default_rng(42)
        for i in range(3):
            if resume and i == 2:
                named = {n: p for n, p in model.named_parameters() if p.requires_grad}
                mu, nu = toptim.moments(name, opt, named)
                mu, nu = ({k: v.clone() for k, v in d.items()} for d in (mu, nu))
                opt = toptim.build_optimizer(name, model, lr=0.01, momentum=0.9, weight_decay=WD)
                toptim.load_moments(name, opt, named, mu, nu, step=2, beta1=0.9)
                opt.track(model, ema)
                assert int(opt.step) == 2
            grads, _ = _grads(model, rng, 1.0)
            _port_step(model, opt, ema, grads, [0.01, 0.02, 0.03], 0.9)
        runs.append([t.clone() for t in (*model.state_dict().values(), *opt.mu, *opt.nu, opt.extra)])
    for a, b in zip(*runs):
        if name == "NAdam":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("name", list(toptim.OPTIMIZERS))
def test_step_scalars_follow_jax(name):
    """The per-step scalars over 12 steps at a ramping momentum (b1t, b2t, NAdam's mu schedule and running product,
    RAdam's rectification and its switch at step 6) against the JAX update's own expressions."""
    extra = torch.ones(())
    jextra = jnp.ones((), jnp.float32)
    for step in range(1, 13):
        b1 = np.float32(0.8 + 0.01 * step)
        s, new = OK.step_scalars(name, torch.tensor(step, dtype=torch.int32), torch.tensor(b1), extra)
        t = jnp.asarray(step, jnp.int32).astype(jnp.float32)
        want = {7: 1 - b1}
        if name in ("Adam", "AdamW", "Adamax", "RAdam"):
            want[0] = 1 - b1 ** t
        if name in ("Adam", "AdamW", "NAdam", "RAdam"):
            want[1] = 1 - 0.999 ** t
        if name == "NAdam":
            mu_t = b1 * (1 - 0.5 * 0.96 ** (t * 0.004))
            mu_next = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * 0.004))
            jextra = jextra * mu_t
            want[2] = (1 - mu_t) / (1 - jextra)
            want[3] = mu_next / (1 - jextra * mu_next)
            extra = new
            np.testing.assert_allclose(float(new), float(jextra), rtol=1e-6)
        if name == "RAdam":
            b2t = 1 - 0.999 ** t
            rho_inf = 2.0 / (1 - 0.999) - 1.0
            rho_t = rho_inf - 2.0 * t * 0.999 ** t / b2t
            want[4] = jnp.sqrt(jnp.maximum((rho_t - 4) * (rho_t - 2) * rho_inf
                                           / ((rho_inf - 4) * (rho_inf - 2) * rho_t), 0.0))
            want[5] = float(rho_t > 5.0)
            want[6] = jnp.sqrt(b2t)
            assert float(s[5]) == float(step >= 6)
        assert s.dtype == torch.float32 and s.shape == (OK.N_SCALARS,)
        for i in range(OK.N_SCALARS):
            np.testing.assert_allclose(float(s[i]), float(want.get(i, 0.0)), rtol=2e-6, err_msg=f"{name} {i} {step}")


def test_apply_table_rows_and_items():
    """K10's table: a row per trainable tensor (p, g, mu, nu, ema, n, group, vector flag), then one per other
    floating entry (kind 1) and integer entry (kind 2, n in bytes); items of OPTIM_CHUNK elements, the trainable
    rows' first; built on the CPU here as the card's is, and stale once a tracked tensor is replaced."""
    model = _Tiny()
    opt, ema = _port("AdamW", model)
    table = opt.table
    # 5 trainable; the two BNs' running statistics and the frozen row 2's 3 parameters; the two BN batch counters
    assert len(table.train) == 5 and len(table.floats) == 2 * 2 + 3 and len(table.ints) == 2
    table._upload()
    rows, items = table.rows.numpy(), table.items.numpy()
    assert rows.shape == (len(table.train) + len(table.floats) + len(table.ints), 8)
    for i, (p, g, mu, nu, e, gid) in enumerate(table.train):
        assert list(rows[i, :5]) == [t.data_ptr() for t in (p, g, mu, nu, e)]
        assert rows[i, 5] == p.numel() and rows[i, 6] == gid and rows[i, 7] == OK._vec16(p, g, mu, nu, e)
    kinds = rows[:, 6] >> 32
    assert list(kinds) == [0] * 5 + [1] * len(table.floats) + [2] * len(table.ints)
    assert all(rows[-k, 5] == 8 for k in range(1, 3))  # the int64 batch counters: 8 bytes each
    assert table.n_norm == 5 and table.n_items == len(rows) and list(items[:, 1]) == [0] * len(rows)
    assert not opt.stale()
    opt.params[0].grad = torch.zeros_like(opt.params[0])
    assert opt.stale()  # a replaced gradient: the table must be built again
    opt.track(model, ema)
    assert not opt.stale()
    big = OK.ApplyTable([(torch.zeros(3 * OK.OPTIM_CHUNK + 5),) * 5 + (1,)], [])
    big._upload()
    assert big.n_norm == big.n_items == 4 and big.items.numpy()[:, 1].tolist() == [0, 1, 2, 3]


def test_optim_apply_checks_its_inputs():
    model = _Tiny()
    opt, ema = _port("SGD", model)
    s, _ = OK.step_scalars("SGD", opt.step, opt.momentum, opt.extra)
    with pytest.raises(NotImplementedError):
        OK.optim_apply(opt.table, "Lion", opt.hyper, s, WD, ema.d, ema.one_minus_d)
    with pytest.raises(ValueError):
        OK.optim_apply(opt.table, "SGD", opt.hyper.double(), s, WD, ema.d, ema.one_minus_d)
    with pytest.raises(ValueError):
        OK.optim_apply(opt.table, "SGD", opt.hyper, s[:4], WD, ema.d, ema.one_minus_d)
    with pytest.raises(ValueError):  # a row's tensors must agree in shape
        OK.ApplyTable([(torch.zeros(4), torch.zeros(4), torch.zeros(4), torch.zeros(3), torch.zeros(4), 0)], [])
    row = (torch.zeros(4),) * 5 + (0,)
    with pytest.raises(ValueError):  # one floating type a table: fp32 (training) or fp64 (the reference step)
        OK.ApplyTable([row], [(torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64))])
    with pytest.raises(ValueError):
        OK.ApplyTable([(torch.zeros(4, dtype=torch.float16),) * 5 + (0,)], [])
    assert OK.ApplyTable([(torch.zeros(4, dtype=torch.float64),) * 5 + (0,)], []).dtype == torch.float64
    before = OK.optim_apply.launches
    OK.optim_apply(opt.table, "SGD", opt.hyper, s, WD, ema.d, ema.one_minus_d)
    assert OK.optim_apply.launches == before  # the plain version on the CPU: no kernel launched
