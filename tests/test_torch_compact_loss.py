"""The loss's compact box/DFL form and its foreground gather (K9) against the JAX package, on the CPU.

The JAX loss's default (`COMPACT_BOX_LOSS`, yololite_tpu/utils/loss.py:68,
:162-181) gathers the at most topk * M foreground rows with `lax.top_k` over
the foreground mask and a one-hot contraction, then runs decode, CIoU,
bbox2dist and the DFL cross-entropy on those (B, K) rows; it takes the dense
form where topk * M >= A. The port takes the same branch at the same sizes,
its gather being K9 (ops/loss_kernels.py `compact_rows`: csrc/compact_rows.cu
on the card, `compact_rows_plain` here). Inputs come from numpy seeds, as in
tests/test_torch_loss.py, whose helpers this module shares.

Tolerances, each with its reason:
- K9's indices and rows bit for bit against `lax.top_k` and numpy: a gather
  is exact.
- port against JAX, either form: loss items rtol 1e-5, d loss / d maps rtol
  1e-4 with an atol of 1e-6 of the largest gradient, as
  tests/test_torch_loss.py: the packages compute the same terms in float32
  with other roundings (XLA's fused CIoU, the segment matmuls of the DFL).
- the port's compact form against its own dense form: every gradient equal
  (torch.equal: a row left out of the compact form gets +0.0 where the dense
  form's zero weight may give -0.0), items within 1e-6 relative: the two
  forms compute each row's terms alike and differ only in the order of the
  loss's sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from yololite_tpu.utils import loss as jloss

from yololite_tpu_torch.ops import loss_kernels as LK
from yololite_tpu_torch.utils import loss as tloss

from tests.test_torch_loss import _t, _targets
from tests.test_torch_nms import STRIDES, _feats

HYP = type("H", (), {"box": 7.5, "cls": 0.5, "dfl": 1.5})()
SHAPES = ((16, 16), (8, 8), (4, 4))  # imgsz 128: A 336, as tests/test_torch_loss.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_nms.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- K9's plain version against lax.top_k ----------------


def _fg(rng, b, a, nfg):
    """(b, a) bool masks with nfg[i] foreground rows in image i, at seeded places."""
    fg = np.zeros((b, a), bool)
    for i, n in enumerate(nfg):
        fg[i, rng.choice(a, n, replace=False)] = True
    return fg


def _np_top_k(fg, k):
    """numpy's model of lax.top_k(fg as 0.0 / 1.0, k)'s indices: the foreground rows, then the others, by index."""
    return np.stack([np.concatenate([np.flatnonzero(r), np.flatnonzero(~r)])[:k] for r in fg])


# (A, K, the images' foreground counts): nfg 0, < K, = K and > K; A no multiple of any tile of csrc/compact_rows.cu
FG_CASES = [(333, 160, (0, 7, 160, 161)), (1001, 320, (320, 500, 1, 1001)), (8193, 160, (5, 160, 8193, 0)),
            (2, 2, (0, 1, 2, 2))]


@pytest.mark.parametrize("a,k,nfg", FG_CASES, ids=[f"A{a}-K{k}" for a, k, _ in FG_CASES])
def test_compact_rows_plain_picks_lax_top_k_rows(a, k, nfg):
    """K9's plain idx equals lax.top_k's over fg as floats and numpy's model of it; rows are x's rows at idx and pos
    is idx's inverse (-1 off it), bit for bit; the backward puts g's rows back at idx and +0.0 elsewhere."""
    rng = np.random.default_rng(a + k)
    fg = _fg(rng, len(nfg), a, nfg)
    x = rng.standard_normal((len(nfg), a, 24)).astype(np.float32)
    rows, idx, pos = LK.compact_rows_plain(torch.from_numpy(x), torch.from_numpy(fg), k)
    want = np.asarray(lax.top_k(jnp.asarray(fg, jnp.float32), k)[1])
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(idx.numpy(), _np_top_k(fg, k))
    assert idx.dtype == torch.int64 and pos.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.take_along_axis(x, want[..., None], 1))
    inv = np.full(fg.shape, -1)
    np.put_along_axis(inv, want, np.arange(k)[None].repeat(len(nfg), 0), 1)
    np.testing.assert_array_equal(pos.numpy(), inv)
    g = rng.standard_normal((len(nfg), k, 24)).astype(np.float32)
    dx = LK.compact_rows_backward_plain(torch.from_numpy(g), idx, pos).numpy()
    picked = inv >= 0
    np.testing.assert_array_equal(dx[picked], g[np.nonzero(picked)[0], inv[picked]])
    assert (dx[~picked].view(np.int32) == 0).all()  # +0.0, not -0.0


def test_compact_rows_equals_the_one_hot_contraction():
    """The port's gather against JAX's own (yololite_tpu/utils/loss.py:167-169: one_hot(idx) @ pred_distri) on the
    loss's (B, A, 64) slice of the maps, and its gradient against the contraction's transpose: bit for bit."""
    rng = np.random.default_rng(3)
    maps = rng.standard_normal((2, 336, 69)).astype(np.float32)
    fg = _fg(rng, 2, 336, (40, 0))
    jx = jnp.asarray(maps)[..., :64]
    idx = lax.top_k(jnp.asarray(fg, jnp.float32), 160)[1]
    gather = lambda d: jnp.einsum("bka,bar->bkr", jax.nn.one_hot(idx, 336, dtype=d.dtype), d)
    g = rng.standard_normal((2, 160, 64)).astype(np.float32)
    want, vjp = jax.vjp(gather, jx)
    x = _t(maps, grad=True)
    rows, tidx = LK.compact_rows(x[..., :64], torch.from_numpy(fg), 160)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(want))
    rows.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(x.grad[..., :64].numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


# ---------------- the loss in both forms ----------------


def _loss_pair(e2e):
    if e2e:
        return (jloss.E2EDetectLoss(5, STRIDES, 16, hyp=HYP), tloss.E2EDetectLoss(5, STRIDES, 16, hyp=HYP),
                lambda fs: {"one2many": fs[:3], "one2one": fs[3:]})
    return jloss.v8DetectionLoss(5, STRIDES, 16, hyp=HYP), tloss.v8DetectionLoss(5, STRIDES, 16, hyp=HYP), lambda fs: fs


def _inputs(seed, e2e, shapes=SHAPES, m=16, imgsz=128):
    rng = np.random.default_rng(40 + seed)
    maps = _feats(rng, B=2, shapes=shapes, nc=5)
    targets = _targets(rng, 2, m, imgsz=imgsz)
    if e2e:
        maps += _feats(rng, B=2, shapes=shapes, nc=5)
    return maps, targets


class _Counted:
    """Counts the loss's calls of K9 (the compact branch) while in place of utils/loss.py's `compact_rows`."""

    def __init__(self, monkeypatch):
        self.calls = 0
        monkeypatch.setattr(tloss, "compact_rows", self)

    def __call__(self, *args):
        self.calls += 1
        return LK.compact_rows(*args)


def _port(tl, pack, maps, targets, compact=True):
    saved = tloss.COMPACT_BOX_LOSS
    tloss.COMPACT_BOX_LOSS = compact
    try:
        tmaps = [_t(f, grad=True) for f in maps]
        total, items = tl(pack(tmaps), {k: _t(v) for k, v in targets.items()})
        total.backward()
    finally:
        tloss.COMPACT_BOX_LOSS = saved
    return total.detach(), items, [m.grad for m in tmaps]


def _jax(jl, pack, maps, targets, compact=True):
    saved = jloss.COMPACT_BOX_LOSS
    jloss.COMPACT_BOX_LOSS = compact
    try:
        jt = {k: jnp.asarray(v) for k, v in targets.items()}
        (total, items), grads = jax.value_and_grad(lambda fs: jl(pack(fs), jt), has_aux=True)(
            [jnp.asarray(f) for f in maps])
    finally:
        jloss.COMPACT_BOX_LOSS = saved  # the shipped default, whatever the test set
    return float(total), np.asarray(items), [np.asarray(g) for g in grads]


def _assert_port_matches_jax(port, want):
    total, items, grads = port
    jtotal, jitems, jgrads = want
    np.testing.assert_allclose(items.numpy(), jitems, rtol=1e-5)
    np.testing.assert_allclose(total.item(), jtotal, rtol=1e-5)
    assert items.numpy().min() > 0
    g_all = np.concatenate([g.ravel() for g in jgrads])
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6 * np.abs(g_all).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("e2e", [False, True], ids=["v8", "e2e"])
@pytest.mark.parametrize("m", [16, 32])
def test_compact_loss_matches_jax(seed, e2e, m, monkeypatch):
    """The shipped defaults: at A 336 with M 16 and 32 (K 160 and 320 for topk 10, below A) both packages take the
    compact branch (K9 once a head); the port's loss items and d loss / d maps against jax.grad of JAX's."""
    assert tloss.COMPACT_BOX_LOSS and jloss.COMPACT_BOX_LOSS
    counted = _Counted(monkeypatch)
    jl, tl, pack = _loss_pair(e2e)
    maps, targets = _inputs(seed, e2e, m=m)
    port = _port(tl, pack, maps, targets)
    assert counted.calls == (2 if e2e else 1)
    _assert_port_matches_jax(port, _jax(jl, pack, maps, targets))


@pytest.mark.parametrize("e2e", [False, True], ids=["v8", "e2e"])
def test_dense_loss_matches_jax(e2e, monkeypatch):
    """COMPACT_BOX_LOSS False in both packages (restored after): the dense form everywhere, no K9 call; the port
    against JAX at the same bounds."""
    counted = _Counted(monkeypatch)
    jl, tl, pack = _loss_pair(e2e)
    maps, targets = _inputs(2, e2e)
    port = _port(tl, pack, maps, targets, compact=False)
    assert counted.calls == 0 and tloss.COMPACT_BOX_LOSS
    _assert_port_matches_jax(port, _jax(jl, pack, maps, targets, compact=False))
    assert jloss.COMPACT_BOX_LOSS


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("e2e", [False, True], ids=["v8", "e2e"])
def test_compact_form_equals_the_dense_form(seed, e2e):
    """The port's two forms on the same maps: every gradient equal (torch.equal), loss items within 1e-6 relative;
    the d loss / d maps rows that carry no weight are zeros in both."""
    _, tl, pack = _loss_pair(e2e)
    maps, targets = _inputs(10 + seed, e2e, m=32)
    total_c, items_c, grads_c = _port(tl, pack, maps, targets, compact=True)
    total_d, items_d, grads_d = _port(tl, pack, maps, targets, compact=False)
    np.testing.assert_allclose(items_c.numpy(), items_d.numpy(), rtol=1e-6)
    np.testing.assert_allclose(total_c.item(), total_d.item(), rtol=1e-6)
    for gc, gd in zip(grads_c, grads_d):
        assert torch.equal(gc, gd)
    assert any(bool((g[..., :64] == 0).all(-1).any()) for g in grads_c)


@pytest.mark.parametrize("e2e", [False, True], ids=["v8", "e2e"])
def test_dense_branch_where_topk_times_m_reaches_a(e2e, monkeypatch):
    """imgsz 64 (A 84) with M 16: topk * M = 160 >= A for the one-to-many head, so both packages take the dense
    branch with the shipped defaults, and the port makes no K9 call there; the end2end's one-to-one head (topk 1,
    K 16 < 84) stays compact in both."""
    counted = _Counted(monkeypatch)
    jl, tl, pack = _loss_pair(e2e)
    maps, targets = _inputs(3, e2e, shapes=((8, 8), (4, 4), (2, 2)), imgsz=64)
    port = _port(tl, pack, maps, targets)
    assert counted.calls == (1 if e2e else 0)
    _assert_port_matches_jax(port, _jax(jl, pack, maps, targets))


# the trainer's GT buckets (powers of two, 16-256) at imgsz 320 (A 2,100) and 640 (A 8,400)
@pytest.mark.parametrize("imgsz,m", [(320, 16), (320, 128), (320, 256), (640, 256)])
def test_compact_k_is_the_loss_rule(imgsz, m, monkeypatch):
    """`v8DetectionLoss.compact_k`, the rule the loss and chip_smoke.py read: K = topk * M where topk * M < A (both
    heads of the end2end loss), None where it reaches A or with COMPACT_BOX_LOSS False."""
    a = sum((imgsz // s) ** 2 for s in STRIDES)
    for topk in (10, 1):
        head = tloss.v8DetectionLoss(80, STRIDES, 16, hyp=HYP, tal_topk=topk)
        assert head.compact_k(m, a) == (topk * m if topk * m < a else None)
        monkeypatch.setattr(tloss, "COMPACT_BOX_LOSS", False)
        assert head.compact_k(m, a) is None
        monkeypatch.setattr(tloss, "COMPACT_BOX_LOSS", True)
    assert (tloss.v8DetectionLoss(80, STRIDES, 16, hyp=HYP).compact_k(m, a) is None) == (imgsz == 320 and m == 256)
