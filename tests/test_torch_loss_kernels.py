"""The loss-tail kernels' public wrappers and ops (ops/loss_kernels.py: K5, K6a, K6b, K7, K9) against the JAX package.

On the CPU every wrapper runs its kernel's plain version through the
`torch.library` op; csrc/dfl.cu, csrc/bce_sum.cu, csrc/topk_rows.cu and
csrc/compact_rows.cu are held to those plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py). Inputs come from a numpy seed and reach the port as the loss
passes them: the box and class logits as column slices of one (B, A, 144)
tensor (rows with a stride of 144), at B 2 and A 300 or 8,400.

Tolerances, each with its reason:
- forwards against JAX: rtol 1e-6, atol 1e-6. The JAX package sums each
  side's exp and products as segment matmuls (and its loss in another
  order), so the float32 sums differ in their last bits.
- fp32 backwards against JAX's custom vjps: rtol 1e-5, atol 1e-7 (K6a),
  2e-7 (K6b) or 2e-6 (K5) times max |grad|: in K5 the same sums (m, z, E)
  enter every element of a side; in K6b XLA's fp32 sigmoid lies up to 4
  ulps from torch's (2.4e-7 near 1: one element in 1.3 million at A 8,400).
- bf16 backwards: rtol 2^-7 (one bf16 ulp), atol 2^-6 times max |grad|: both
  packages round to bf16 once at the end (K5, K6a), and K6b's bf16 sigmoid
  rounds otherwise in XLA than in torch.
- fp32 backwards against torch autograd of the plain forward: the same
  bounds as against JAX (autograd takes another route through the sums).
- K7 bit for bit in values and indices: the top-k is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from yololite_tpu.ops import decode as jdecode
from yololite_tpu.utils import loss as jloss
from yololite_tpu.utils import tal as jtal

from yololite_tpu_torch.ops import loss_kernels as LK
from yololite_tpu_torch.ops.decode import dfl_expectation_mm
from yololite_tpu_torch.utils.loss import bce_sum, dfl_ce_mean
from yololite_tpu_torch.utils.tal import TaskAlignedAssigner


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_nms.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(rng, a, underflow=False):
    """(2, a, 144) float32 logits: 64 box logits (one side far below the others with `underflow`), 80 class ones."""
    x = (rng.standard_normal((2, a, 144)) * 3).astype(np.float32)
    if underflow:  # side 1 sits 120 below sides 0, 2, 3: exp of it against a shared max would underflow to 0
        x[:, :, 16:32] -= 120.0
        x[:, :, 32:48] += 40.0
    return x


def _targets(rng, a):
    """(2, a, 4) continuous bins: past both clips (< 0, > R - 1 - 0.01), exactly at R - 1 - 0.01, and inside."""
    t = rng.uniform(-1, 16, (2, a, 4)).astype(np.float32)
    t[:, ::7, 1] = np.float32(15 - 0.01)  # the tr clamp: tl 14, tr 15
    t[:, ::11, 2] = 0.0
    return t


def _labels(rng, a):
    return (rng.uniform(0, 1, (2, a, 80)) * (rng.uniform(size=(2, a, 80)) > 0.9)).astype(np.float32)


def _assert_close(got, want, rtol, atol_rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _check(name, x144, rest, dtype, atol_rel):
    """The wrapper on the strided slice against JAX's forward and custom vjp, and (fp32) torch autograd of the
    plain forward; the gradient lands in the slice's columns of the (B, A, 144) tensor, in the logits' dtype."""
    cols = slice(0, 64) if name != "bce_sum" else slice(64, 144)
    port_fn = {"dfl_expectation": lambda v: dfl_expectation_mm(v, 16), "dfl_ce_mean": dfl_ce_mean,
               "bce_sum": bce_sum}[name]
    jax_fn = {"dfl_expectation": lambda v: jdecode.dfl_expectation_mm(v, 16), "dfl_ce_mean": jloss.dfl_ce_mean,
              "bce_sum": jloss.bce_sum}[name]
    plain_fn = {"dfl_expectation": lambda v: LK.dfl_expectation_plain(v, 16), "dfl_ce_mean": LK.dfl_ce_plain,
                "bce_sum": LK.bce_sum_plain}[name]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = x144[..., cols]
    jx = jnp.asarray(x, jdt)
    jrest = [jnp.asarray(r) for r in rest]
    trest = [torch.from_numpy(r) for r in rest]
    full = torch.from_numpy(x144).to(dtype).requires_grad_(True)
    tout = port_fn(full[..., cols], *trest)
    jout, vjp = jax.vjp(lambda v: jax_fn(v, *jrest), jx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)

    g = np.random.default_rng(3).standard_normal(tout.shape).astype(np.float32)
    tout.backward(torch.from_numpy(g))
    assert full.grad.dtype == dtype and not full.grad[..., [c for c in range(144) if c not in range(144)[cols]]].any()
    got = full.grad[..., cols].float().numpy()
    (jg,) = vjp(jnp.asarray(g))
    if dtype == torch.bfloat16:
        _assert_close(got, np.asarray(jg, np.float32), 2 ** -7, 2 ** -6)
        return
    _assert_close(got, np.asarray(jg), 1e-5, atol_rel)
    tx = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    plain_fn(tx, *trest).backward(torch.from_numpy(g))
    _assert_close(got, tx.grad.numpy(), 1e-5, atol_rel)


CASES = [("dfl_expectation", 2e-6), ("dfl_ce_mean", 1e-7), ("bce_sum", 2e-7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("a,underflow", [(300, False), (300, True), (8400, False)], ids=["A300", "A300-underflow",
                                                                                     "A8400"])
@pytest.mark.parametrize("name,atol_rel", CASES, ids=[c[0] for c in CASES])
def test_loss_tail_matches_jax(name, atol_rel, a, underflow, dtype):
    """K5, K6a, K6b forward and backward through the wrappers, on the loss's strided slices, against JAX."""
    rng = np.random.default_rng(a + underflow)
    x = _maps(rng, a, underflow)
    rest = {"dfl_expectation": [], "dfl_ce_mean": [_targets(rng, a)], "bce_sum": [_labels(rng, a)]}[name]
    _check(name, x, rest, dtype, atol_rel)


def test_the_underflowing_side_keeps_a_finite_expectation():
    """A side 120 below the others: its own max keeps exp(0) = 1 in its sum, so E, ce and their gradients stay
    finite, and E equals the expectation of the side alone."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_maps(rng, 50, underflow=True))[..., :64].requires_grad_(True)
    e = dfl_expectation_mm(x, 16)
    alone = dfl_expectation_mm(x.detach()[..., 16:32].repeat(1, 1, 4), 16)[..., 1]
    torch.testing.assert_close(e[..., 1].detach(), alone, rtol=0, atol=0)
    ce = dfl_ce_mean(x, torch.from_numpy(_targets(rng, 50)))
    (e.sum() + ce.sum()).backward()
    assert torch.isfinite(e).all() and torch.isfinite(ce).all() and torch.isfinite(x.grad).all()


# ---------------- K7 ----------------


def _metrics(rng, a, kind):
    """(2, 6, a) float32 rows: random, quantized to four values (ties everywhere), or with all-zero masked rows."""
    m = rng.uniform(0, 1, (2, 6, a)).astype(np.float32)
    if kind == "ties":
        m = np.floor(m * 4) / 4
    elif kind == "masked":
        m *= rng.uniform(size=(2, 6, a)) > 0.97  # mostly zero, as outside the GT boxes
        m[1, 3:] = 0.0  # padded GT rows
    return m.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "masked"])
@pytest.mark.parametrize("a", [129, 300, 8400])
@pytest.mark.parametrize("k", [1, 10, 13])
def test_topk_rows_matches_lax_top_k_and_the_blocked_forms(k, a, kind):
    """K7 bit for bit against lax.top_k, topk_blockmax_gather and topk_hierarchical: values and indices."""
    m = _metrics(np.random.default_rng(k * 1000 + a), a, kind)
    vals, idx = LK.topk_rows(torch.from_numpy(m), k)
    jm = jnp.asarray(m)
    for fn in (lambda v: lax.top_k(v, k), lambda v: jtal.topk_blockmax_gather(v, k),
               lambda v: jtal.topk_hierarchical(v, k)):
        wv, wi = fn(jm)
        np.testing.assert_array_equal(vals.numpy().view(np.int32), np.asarray(wv).view(np.int32))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    assert idx.dtype == torch.int64 and vals.dtype == torch.float32


@pytest.mark.parametrize("a,k", [(5, 10), (13, 13), (1, 1)])
def test_topk_rows_of_a_short_row_is_the_row_sorted(a, k):
    """n <= k: every element, sorted (min(k, n) columns), as lax.top_k(m, min(k, n)) and the blocked forms give."""
    m = np.floor(np.random.default_rng(a).uniform(0, 3, (2, 4, a))).astype(np.float32)
    vals, idx = LK.topk_rows(torch.from_numpy(m), k)
    assert vals.shape == (2, 4, min(k, a))
    for fn in (lax.top_k, jtal.topk_blockmax_gather, jtal.topk_hierarchical):
        wv, wi = fn(jnp.asarray(m), min(k, a)) if fn is lax.top_k else fn(jnp.asarray(m), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))


def test_topk_rows_orders_nan_first_and_signed_zeros_by_index():
    """NaN above every number (torch.sort's descending order), -0.0 tied with 0.0 and taken by index."""
    row = torch.tensor([[0.0, -0.0, float("nan"), 1.0, -0.0, float("nan"), 0.5, 0.0]])
    vals, idx = LK.topk_rows(row, 6)
    assert idx.tolist() == [[2, 5, 3, 6, 0, 1]]
    assert torch.equal(vals[:, :2].isnan(), torch.ones(1, 2, dtype=torch.bool))


def test_assigner_picks_through_topk_rows_match_jax():
    """The assigner's per-GT picks (K7 plus the count rule) on rows with ties and masked GTs equal JAX's."""
    m = _metrics(np.random.default_rng(12), 8400, "masked")
    mask_gt = np.ones((2, 6, 1), np.float32)
    mask_gt[1, 3:] = 0
    for topk in (1, 10, 13):
        got = TaskAlignedAssigner(topk=topk)._select_topk_candidates(torch.from_numpy(m), torch.from_numpy(mask_gt))
        want = jtal.TaskAlignedAssigner(topk=topk)._select_topk_candidates(jnp.asarray(m), jnp.asarray(mask_gt))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------- the ops and the routing ----------------


def _op_args(requires_grad: bool):
    rng = np.random.default_rng(13)
    full = torch.from_numpy(_maps(rng, 40)).requires_grad_(requires_grad)
    box, cls = full[..., :64], full[..., 64:]
    t, lab = torch.from_numpy(_targets(rng, 40)), torch.from_numpy(_labels(rng, 40))
    fg = torch.from_numpy(rng.uniform(size=(2, 40)) > 0.7)
    ops = torch.ops.yololite_tpu_torch
    return [
        (ops.dfl_expectation.default, (box, 16)),
        (ops.dfl_expectation_backward.default, (box.detach(), torch.randn(2, 40, 4), 16)),
        (ops.dfl_ce_mean.default, (box, t)),
        (ops.dfl_ce_backward.default, (box.detach(), t, torch.randn(2, 40, 1))),
        (ops.bce_sum.default, (cls, lab)),
        (ops.bce_sum_backward.default, (cls.detach(), lab, torch.tensor(0.7))),
        (ops.topk_rows.default, (torch.from_numpy(_metrics(rng, 300, "ties")), 10)),
        (ops.compact_rows.default, (box, fg, 16)),
        (ops.compact_rows_backward.default, (torch.randn(2, 16, 64), *ops.compact_rows(box.detach(), fg, 16)[1:])),
    ]


@pytest.mark.parametrize("i", range(9), ids=["dfl_expectation", "dfl_expectation_backward", "dfl_ce_mean",
                                              "dfl_ce_backward", "bce_sum", "bce_sum_backward", "topk_rows",
                                              "compact_rows", "compact_rows_backward"])
@pytest.mark.parametrize("requires_grad", [False, True], ids=["nograd", "grad"])
def test_loss_tail_ops_pass_opcheck(i, requires_grad):
    """Schema, fake tensor, autograd registration and AOT dispatch of each op (the backward ops and K7 take no
    gradient)."""
    op, args = _op_args(requires_grad)[i]
    torch.library.opcheck(op, args)


def test_cpu_tensors_route_to_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's bits and counts no launch."""
    rng = np.random.default_rng(14)
    full = torch.from_numpy(_maps(rng, 60))
    box, cls = full[..., :64], full[..., 64:]
    t, lab = torch.from_numpy(_targets(rng, 60)), torch.from_numpy(_labels(rng, 60))
    g4, g1, g0 = torch.randn(2, 60, 4), torch.randn(2, 60, 1), torch.tensor(1.3)
    m = torch.from_numpy(_metrics(rng, 300, "ties"))
    before = [w.launches for w in LK.COUNTED]
    pairs = [
        (LK.dfl_expectation(box, 16), LK.dfl_expectation_plain(box, 16)),
        (LK.dfl_expectation_backward(box, g4, 16), LK.dfl_expectation_backward_plain(box, g4, 16)),
        (LK.dfl_ce_mean(box, t), LK.dfl_ce_plain(box, t)),
        (LK.dfl_ce_backward(box, t, g1), LK.dfl_ce_backward_plain(box, t, g1)),
        (LK.bce_sum(cls, lab), LK.bce_sum_plain(cls, lab)),
        (LK.bce_sum_backward(cls, lab, g0), LK.bce_sum_backward_plain(cls, lab, g0)),
        (*LK.topk_rows(m, 10), *LK.topk_stable(m, 10)),
    ]
    for got, want in pairs[:-1]:
        assert torch.equal(got, want)
    vals, idx, wv, wi = pairs[-1]
    assert torch.equal(vals, wv) and torch.equal(idx, wi)
    fg = torch.from_numpy(rng.uniform(size=(2, 60)) > 0.8)
    rows, kidx = LK.compact_rows(box, fg, 20)
    wrows, widx, wpos = LK.compact_rows_plain(box, fg, 20)
    assert torch.equal(rows, wrows) and torch.equal(kidx, widx)
    g = torch.randn(2, 20, 64)
    assert torch.equal(LK.compact_rows_backward(g, widx, wpos), LK.compact_rows_backward_plain(g, widx, wpos))
    assert [w.launches for w in LK.COUNTED] == before
    from yololite_tpu_torch.engine.graphs import COUNTERS

    assert all((w, "launches") in COUNTERS for w in LK.COUNTED)  # a replayed train graph adds their launches


def test_wrappers_reject_what_no_version_takes():
    x = torch.zeros(2, 10, 64)
    with pytest.raises(ValueError):
        LK.dfl_expectation(x, 8)  # 64 logits are 4 x 16
    with pytest.raises(ValueError):
        LK.dfl_ce_mean(x, torch.zeros(2, 10, 3))
    with pytest.raises(ValueError):
        LK.bce_sum(x, torch.zeros(2, 10, 63))
    with pytest.raises(ValueError):
        LK.dfl_expectation(x.to("meta"), 16)  # neither a CUDA nor a CPU tensor
    with pytest.raises(ValueError):
        LK.topk_rows(torch.zeros(()), 3)
    fg = torch.zeros(2, 10, dtype=torch.bool)
    with pytest.raises(ValueError):
        LK.compact_rows(x, fg, 11)  # k past A
    with pytest.raises(ValueError):
        LK.compact_rows(x, fg[:, :9], 4)
    with pytest.raises(ValueError):
        LK.compact_rows(x[0], fg, 4)  # not (B, A, C)
    with pytest.raises(TypeError):
        LK.compact_rows(x, fg.float(), 4)  # the mask is bool
    with pytest.raises(ValueError):
        LK.compact_rows(x.to("meta"), fg.to("meta"), 4)
    with pytest.raises(ValueError):
        LK.compact_rows_backward(torch.zeros(2, 4, 64), torch.zeros(2, 5, dtype=torch.int64),
                                 torch.zeros(2, 10, dtype=torch.int32))


@pytest.mark.parametrize("view,want", [
    (lambda x: x[..., :64], (60, 144)),
    (lambda x: x[..., 64:], (60, 144)),
    (lambda x: x[:, 3], (2, 4320)),
    (lambda x: x[0, :1], (1, 144)),
    (lambda x: x.reshape(2, 30, 144)[:, :0], (0, 144)),
])
def test_rows_of_reads_evenly_spaced_rows_in_place(view, want):
    """The kernels read a slice's rows through their stride; a layout they cannot read raises, never copies."""
    assert LK._rows_of(view(torch.zeros(2, 30, 144))) == want


@pytest.mark.parametrize("view", [lambda x: x.transpose(1, 2), lambda x: x[:, ::2, :].transpose(0, 1)[:, :, :64],
                                  lambda x: x[:, :, ::2], lambda x: x[:, :1].expand(2, 5, 144)])
def test_rows_of_refuses_other_layouts(view):
    with pytest.raises(ValueError):
        LK._rows_of(view(torch.zeros(2, 30, 144)))


# ---------------- numpy models of the redesigned schedules (K5 and K6a at R 16, K6b, K7) ----------------
# csrc/dfl.cu, csrc/bce_sum.cu and csrc/topk_rows.cu run only on the card; these models replay their orders of
# addition, their walks and their selection in numpy (float32 IEEE adds, round to nearest; the same keys) so that a
# change of any can be checked here first.


def _row_sum16(v):
    """torch's CUDA sum over a row of 16 (csrc/dfl_math.cuh row_sum): thread t starts at 0 and adds v[t] (its four
    accumulators, three of them 0), then the shuffle-down tree with offsets 8, 4, 2, 1."""
    z = np.float32(0)
    part = [((z + v[t]) + z) + z + z for t in range(16)]
    for o in (8, 4, 2, 1):
        part = [part[t] + part[t + o] for t in range(o)]
    return part[0]


def _lanes16(e):
    """K6a's z at R 16 (`Side16`): lane h holds bins 8h..8h+7; one swap of the halves, each lane adds its bin j and
    the other half's (bin j + 8 on lane 0, bin j on lane 1), then levels 4, 2, 1 in registers. Both lanes' z."""
    out = []
    for h in (0, 1):
        mine, other = e[8 * h:8 * h + 8], e[8 - 8 * h:16 - 8 * h]
        p = [mine[j] + other[j] for j in range(8)]
        p = [p[j] + p[j + 4] for j in range(4)]
        p = [p[j] + p[j + 2] for j in range(2)]
        out.append(p[0] + p[1])
    return out


def _adversarial_rows(rng):
    """Rows of 16 non-negative float32 (or NaN, inf), as exp's outputs are: random, one large among tiny ones in
    every position, binades apart so that the order of addition changes the bits, denormals, zeros, NaN, inf."""
    rows = [rng.exponential(size=16).astype(np.float32) for _ in range(200)]
    rows += [np.exp(rng.uniform(-30, 0, 16)).astype(np.float32) for _ in range(200)]
    for i in range(16):
        r = np.full(16, 2.0 ** -24, np.float32)
        r[i] = 1.0
        rows.append(r)
        rows.append(np.float32(2.0) ** -np.arange(16, dtype=np.float32)[np.roll(np.arange(16), i)])
    rows += [np.zeros(16, np.float32), np.full(16, 1.4e-45, np.float32), np.full(16, 3e38, np.float32)]
    for bad in (np.nan, np.inf):
        r = np.ones(16, np.float32)
        r[5] = bad
        rows.append(r)
    return rows


def test_k6a_lanes_sum_in_row_sums_order():
    """The two lanes of a side get z with the bits of torch's CUDA order, on random and adversarial rows."""
    rows = _adversarial_rows(np.random.default_rng(21))
    with np.errstate(over="ignore", invalid="ignore"):
        for e in rows:
            want = np.float32(_row_sum16(e)).view(np.int32)
            got = [np.float32(z).view(np.int32) for z in _lanes16(e)]
            assert got[0] == want and got[1] == want, (e, got, want)
        # the order matters on these rows: a plain left-to-right sum differs somewhere
        assert any(np.float32(_row_sum16(e)) != np.cumsum(e, dtype=np.float32)[-1] for e in rows[400:432])


def _same_float(a, b):
    """The same float32 bits, or both NaN (the card's arithmetic gives the canonical NaN either way)."""
    a, b = np.float32(a), np.float32(b)
    return a.view(np.int32) == b.view(np.int32) or (np.isnan(a) and np.isnan(b))


def test_k5_lanes_sum_in_row_sums_order():
    """K5 at R 16 (csrc/dfl.cu `expectation16`): both lanes of a side get z and the numerator sum(e_j * j) with the
    bits of torch's CUDA order, so E = num / z has the plain version's bits on both, on random and adversarial
    rows."""
    rows = _adversarial_rows(np.random.default_rng(23))
    bins = np.arange(16, dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for e in rows:
            w = e * bins  # the lane's products, bin 8 * half + j
            want_z, want_num = np.float32(_row_sum16(e)), np.float32(_row_sum16(w))
            want_e = want_num / want_z
            for z, num in zip(_lanes16(e), _lanes16(w)):
                assert _same_float(z, want_z) and _same_float(num, want_num), (e, z, num, want_z, want_num)
                assert _same_float(np.float32(num) / np.float32(z), want_e)
        # the numerator's order matters on these rows too
        assert any(np.float32(_row_sum16(e * bins)) != np.cumsum(e * bins, dtype=np.float32)[-1]
                   for e in rows[:200])


def _k7_keys(x):
    """csrc/topk_rows.cu `key_of`: order-preserving unsigned keys, NaN on top, -0.0 folded onto 0.0."""
    ut, sign = (np.uint32, np.uint32(1 << 31)) if x.dtype == np.float32 else (np.uint64, np.uint64(1 << 63))
    u = x.view(ut).copy()
    u[x == 0] = 0
    key = np.where(u & sign, ~u, u | sign)
    key[np.isnan(x)] = np.iinfo(ut).max
    return key


def _k7_radix_raise(keys, owner, k, t0):
    """csrc/topk_rows.cu `radix_raise` (a streamed row's t0): where at least k keys lie above t0, the k-th largest of
    the row's keys by a radix select over those keys, digits of 11 bits from the top, the keys that carry the prefix
    so far counted by their next digit (a thread whose largest key, `owner` for each key, lies below the prefix
    counts none and holds none), the bins scanned highest first for the one that holds the k-th of those left;
    else t0."""
    ut = keys.dtype.type
    prefix, mask, left = ut(0), ut(0), k
    keys, owner = keys[keys > t0], owner[keys > t0]
    if keys.size < k:
        return t0
    for hi in range(8 * keys.itemsize, 0, -11):
        lo = max(hi - 11, 0)
        dmask = ut((1 << (hi - lo)) - 1)
        carry = (keys & mask) == prefix
        assert not (carry & ((owner & mask) < prefix)).any()  # a skipped thread holds none of them
        hist = np.bincount(((keys[carry] >> ut(lo)) & dmask).astype(np.int64), minlength=2048)
        at_or_above = np.cumsum(hist[::-1])  # keys in each bin and the bins above it, highest first
        i = int(np.searchsorted(at_or_above, left))
        digit = 2047 - i
        left -= int(at_or_above[i] - hist[digit])
        prefix, mask = prefix | (ut(digit) << ut(lo)), mask | (dmask << ut(lo))
    return prefix


def _k7_select(x, k, plan):
    """csrc/topk_rows.cu's select on (rows, n) values as the plan lays them out: thread t's load step s holds values
    (s * threads + t) * V + j (-inf past the row's end); t0 the key of the k-th largest of the threads' maxima (NaN
    winning), on a streamed row raised to the k-th largest key where at least k keys lie above it
    (`_k7_radix_raise`); the values above t0 (NaN too, unless t0 is NaN's key) ranked by key, then index, at most
    (k - 1) * values a thread (fewer than k on a streamed row); then, below k of them, the values of key t0 in the
    row in the steps' order. Returns (vals, idx), how many rows took the fill and how many rows' t0 was raised."""
    rows, n = x.shape
    v = 16 // x.itemsize if plan["route"] == "vector" else 1
    threads, items = LK.TOPK_THREADS, plan["items"]
    steps = items // v if items else -(-n // (threads * v))
    s, t, j = np.meshgrid(np.arange(steps), np.arange(threads), np.arange(v), indexing="ij")
    index = (s * threads + t) * v + j  # (steps, threads, V): in C order the row's index order
    assert np.array_equal(index.reshape(-1), np.arange(index.size)) and index.size >= n
    padded = np.full((rows, index.size), -np.inf, x.dtype)
    padded[:, :n] = x
    held, live = padded[:, index], index < n
    with np.errstate(invalid="ignore"):
        maxima = np.where(np.isnan(held).any(axis=(1, 3)), np.nan, held.max(axis=(1, 3)))  # (rows, threads)
    mine = _k7_keys(maxima)
    top = np.iinfo(mine.dtype).max
    out, fills, raised = np.empty((rows, k), np.int64), 0, 0
    for r in range(rows):
        keys = _k7_keys(held[r])
        t0 = np.sort(mine[r])[::-1][k - 1]
        assert t0 <= np.sort(keys[live])[::-1][k - 1]
        if not items:
            owner = np.broadcast_to(mine[r][None, :, None], live.shape)[live]
            t1 = _k7_radix_raise(keys[live], owner, k, t0)
            if t1 != t0:
                raised += 1
                assert t1 == np.sort(keys[live])[::-1][k - 1]
            t0 = t1
        nan0 = t0 == top
        tv = held[r][keys == t0][0]  # a value t0 stands for
        with np.errstate(invalid="ignore"):
            above = np.zeros_like(live) if nan0 else ~(held[r] <= tv)
            equal = (np.isnan(held[r]) if nan0 else held[r] == tv) & live
        assert (mine[r] > t0).sum() <= k - 1 and above.sum() <= (k - 1) * (steps * v if items else 1)
        assert np.array_equal(above.any(axis=(0, 2)), mine[r] > t0)  # only those threads hold any
        ka, ia = keys[above], index[above]
        ranked = ia[np.lexsort((ia, top - ka))][:k]
        if ranked.size < k:
            fills += 1
            ranked = np.concatenate([ranked, index[equal][:k - ranked.size]])
        out[r] = ranked
    return np.take_along_axis(x, out, 1), out, fills, raised


def _k7_rows(rng, kind, a, dtype):
    """(6, a) rows: random, quantized (more than k entries equal the k-th), the assigner's (mostly zero, values on a
    grid of 1/64, two padded all-zero rows), a GT's smooth bump (distinct values that fall off from a peak over 400
    anchors each side, zero elsewhere: the largest sit side by side, so a thread holds several), all zero, with NaN,
    +-inf and -0.0 / 0.0 ties, or ones with a handful above them."""
    m = rng.uniform(0, 1, (6, a))
    if kind == "ties":
        m = np.floor(m * 4) / 4
    elif kind == "assigner":
        m = np.floor(m * 64) / 64 * (rng.uniform(size=(6, a)) > 0.9)
        m[4:] = 0.0
    elif kind == "boxes":
        d = np.arange(a)[None] - rng.integers(0, a, (6, 1))
        m = np.exp(-(d / 200.0) ** 2) * (np.abs(d) < 400)
    elif kind == "zeros":
        m[:] = 0.0
    elif kind == "special":
        m = rng.standard_normal((6, a)) * (rng.uniform(size=(6, a)) > 0.5)
        m[rng.uniform(size=(6, a)) < 0.3] = -0.0
        m[:, ::7] = np.nan
        m[:3, 3::11] = np.inf
        m[3:, 5::13] = -np.inf
    elif kind == "plateau":
        m = np.ones((6, a))
        m[:, rng.integers(0, a, 4)] = 2.0
    return m.astype(dtype)


K7_KINDS = ["random", "ties", "assigner", "boxes", "zeros", "special", "plateau"]
K7_LENGTHS = [5, 129, 2101, 8400, 9300]  # the A <= k case, every register tile, the scalar route, a streamed row


@pytest.mark.parametrize("a", K7_LENGTHS)
@pytest.mark.parametrize("k", [1, 10, 13, 32])
@pytest.mark.parametrize("kind", K7_KINDS)
def test_k7_select_model_equals_topk_stable(kind, k, a):
    """The numpy model of csrc/topk_rows.cu (t0 from the threads' maxima, on a streamed row raised by a radix select
    over the keys above it; the values above t0 ranked, the tie fill by index) on fp32 rows laid out by
    `topk_rows_plan`: values (bits) and indices equal to topk_stable's."""
    x = _k7_rows(np.random.default_rng(k * 100 + a), kind, a, np.float32)
    kk = min(k, a)
    vals, idx, fills, raised = _k7_select(x, kk, LK.topk_rows_plan(torch.from_numpy(x), k))
    wv, wi = LK.topk_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(vals.view(np.int32), wv.numpy().view(np.int32))
    np.testing.assert_array_equal(idx, wi.numpy())
    if kind == "zeros":  # an all-zero row is t0 alone: every slot comes from the fill
        assert fills == x.shape[0]
    if kind == "boxes" and k > 1 and LK.TOPK_THREADS * max(LK.TOPK_ITEMS) < a:  # a bump's rows take the raise
        assert raised == x.shape[0]


@pytest.mark.parametrize("a", K7_LENGTHS)
@pytest.mark.parametrize("kind", K7_KINDS)
def test_k7_select_model_equals_topk_stable_in_fp64(kind, a):
    """The same model on fp64 rows (64-bit keys, two values a 16-byte load) at k 32."""
    x = _k7_rows(np.random.default_rng(a + 7), kind, a, np.float64)
    vals, idx, _, _ = _k7_select(x, min(32, a), LK.topk_rows_plan(torch.from_numpy(x), 32))
    wv, wi = LK.topk_stable(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(vals.view(np.int64), wv.numpy().view(np.int64))
    np.testing.assert_array_equal(idx, wi.numpy())


def _bce_walk(rows, cols, piece, chunk_threads=256, per=4):
    """csrc/bce_sum.cu's pieces as its threads visit them, for one element count: (block, thread, i, j, flat
    element) of every term in the order a thread adds them; on the vector route each piece's (row, first column) by
    the kernel's stepping (one division for the thread's first piece, then dr rows and dq pieces a step)."""
    n = rows * cols
    pieces = -(-n // piece)
    chunk = chunk_threads * per
    blocks = -(-pieces // chunk)
    b, t, i = np.meshgrid(np.arange(blocks), np.arange(chunk_threads), np.arange(per), indexing="ij")
    p = b * chunk + i * chunk_threads + t
    e = p[..., None] * piece + np.arange(piece)
    live = e < n
    vec = None
    if cols % piece == 0:
        ppr = cols // piece
        dr, dq = chunk_threads // ppr, chunk_threads % ppr
        p0 = b[..., 0] * chunk + t[..., 0]
        r, q = p0 // ppr, p0 % ppr
        steps = []
        for _ in range(per):
            steps.append((r.copy(), q.copy()))
            r, q = r + dr, q + dq
            wrap = q >= ppr
            q, r = np.where(wrap, q - ppr, q), np.where(wrap, r + 1, r)
        vec = np.stack([np.stack(s, -1) for s in steps], 2)  # (block, thread, i, (row, piece in row))
    return e, live, vec


@pytest.mark.parametrize("rows,cols,piece", [(16800, 80, 4), (16800, 80, 8), (900, 80, 2), (1001, 80, 4),
                                             (1, 80, 8), (7, 81, 4), (333, 80, 8), (5, 3, 8), (2100, 64, 4)])
def test_bce_partition_covers_every_element_once(rows, cols, piece):
    """Every element in exactly one piece of one thread of one chunk, for ragged row counts; the vector route's
    stepped (row, piece) equal to the scalar route's division of the same flat element; the walk a function of
    the element count and the piece alone (the same for (rows, cols) of one product)."""
    e, live, vec = _bce_walk(rows, cols, piece)
    flat = e[live]
    assert flat.size == rows * cols and np.array_equal(np.sort(flat), np.arange(rows * cols))
    if vec is not None:
        first = e[..., 0]
        ok = live[..., 0]
        assert np.array_equal(vec[..., 0][ok], first[ok] // cols) and np.array_equal(vec[..., 1][ok] * piece,
                                                                                       first[ok] % cols)
    if rows % 2 == 0:
        e2, live2, _ = _bce_walk(rows // 2, cols * 2, piece)
        assert np.array_equal(e2, e) and np.array_equal(live2, live)


def test_bce_sum_kernel_order_model_is_the_threads_loop():
    """chip_smoke.bce_sum_kernel_order (the card's check of K6b's sum) on the CPU against a direct replay of the
    kernel's loops over `_bce_walk` (each thread's terms in order, each warp's shuffle-down tree, the warps in
    order, then the partials on 512 threads): the same bits."""
    import chip_smoke

    rng = np.random.default_rng(22)
    for rows, dtype in ((37, torch.float32), (2100, torch.bfloat16), (9, torch.float64)):
        full = torch.from_numpy((rng.standard_normal((rows, 144)) * 3).astype(np.float32)).to(dtype)
        lab = torch.from_numpy(_labels(rng, rows)[0].astype(np.float32))
        x = full[:, 64:]
        terms = LK.sigmoid_bce(x.float(), lab).reshape(-1).numpy()
        e, live, _ = _bce_walk(rows, 80, 16 // dtype.itemsize)
        vals = np.where(live, terms[np.minimum(e, terms.size - 1)], np.float32(0))
        acc = np.zeros(vals.shape[:2], np.float32)
        for i in range(vals.shape[2]):
            for j in range(vals.shape[3]):
                acc = acc + vals[:, :, i, j]

        def block(a, threads):
            lanes = a.reshape(a.shape[0], threads // 32, 32).copy()
            for o in (16, 8, 4, 2, 1):
                lanes[..., :o] = lanes[..., :o] + lanes[..., o:2 * o]
            s = lanes[:, 0, 0].copy()
            for w in range(1, threads // 32):
                s = s + lanes[:, w, 0]
            return s

        partials = block(acc, 256)
        fin = np.zeros(512, np.float32)
        for k in range(0, partials.size, 512):
            chunk = np.zeros(512, np.float32)
            chunk[:min(512, partials.size - k)] = partials[k:k + 512]
            fin = fin + chunk
        want = block(fin[None], 512)[0]
        got = chip_smoke.bce_sum_kernel_order(x, lab)
        assert np.float32(got.item()).view(np.int32) == want.view(np.int32)
        assert abs(float(got) - float(LK.bce_sum_plain(x, lab))) <= 1e-6 * abs(float(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64], ids=["fp32", "bf16", "fp64"])
def test_plans_pick_the_routes_the_layouts_allow(dtype):
    """K6b's, K5's and K6a's (one plan), and K7's plans on the maps' slices and on shifted layouts (the scalar routes);
    K6b's blocks are its chunks of BCE_CHUNK pieces; another reg_max takes the generic DFL kernels; K7's block is the
    first register tile that holds the row, a longer row streams."""
    maps = torch.zeros(2, 300, 144, dtype=dtype)
    lab = torch.zeros(2, 300, 80, dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    plan = LK.bce_sum_plan(maps[..., 64:], lab)
    g = 16 // dtype.itemsize
    assert plan["route"] == "vector" and plan["piece"] == g and plan["pieces"] == 600 * 80 // g
    assert plan["blocks"] == -(-plan["pieces"] // LK.BCE_CHUNK) and plan["x_row_stride"] == 144
    assert LK.dfl_plan(maps[..., :64]) == {"route": "lanes", "rows": 600, "row_stride": 144}
    wide = torch.zeros(2, 300, 146, dtype=dtype)
    assert LK.dfl_plan(wide[..., 1:65])["route"] == "lanes-scalar"
    assert LK.bce_sum_plan(wide[..., 66:], torch.zeros(2, 300, 81, dtype=lab.dtype)[..., 1:])["route"] == "scalar"
    assert LK.bce_sum_plan(maps[..., 63:143], lab)["route"] == "scalar"  # logits one column off
    assert LK.dfl_plan(maps[..., :32])["route"] == "generic"
    odd = torch.zeros(5, 3)  # 3 columns: no whole pieces a row
    assert LK.bce_sum_plan(odd, odd)["route"] == "scalar" and LK.bce_sum_plan(odd, odd)["pieces"] == 4
    # K7 takes fp32 and fp64 metrics
    mdt = torch.float32 if dtype == torch.bfloat16 else dtype

    def k7(n, k=10, view=lambda m: m):
        p = LK.topk_rows_plan(view(torch.zeros(2, 6, n, dtype=mdt)), k)
        return p["route"], p["items"], p["k"]

    assert k7(8400) == ("vector", 36, 10) and k7(2100) == ("vector", 12, 10) and k7(128, 32) == ("vector", 12, 32)
    assert k7(3072)[1] == 12 and k7(3076)[1] == 36 and k7(9216)[1] == 36 and k7(9220)[1] == 0
    assert k7(2101) == ("scalar", 12, 10) and k7(5) == ("scalar", 12, 5)
    assert k7(8401, view=lambda m: m[..., 1:])[0] == "scalar"  # one column in: the pointer off 16 bytes
    plan = LK.topk_rows_plan(torch.zeros(2, 6, 8400, dtype=mdt)[:, ::2], 13)
    assert plan["rows"] == 6 and plan["row_stride"] == 16800 and plan["n"] == 8400
    # K9 reads the maps' box slice, a contiguous tensor (its rows, the backward's gradient) in 16-byte pieces; a slice
    # one column in, or rows whose bytes are no multiple of 16, one element at a time
    assert LK.compact_rows_plan(maps[..., :64]) == {"route": "vector", "rows": 600, "row_stride": 144}
    assert LK.compact_rows_plan(torch.zeros(2, 300, 64, dtype=dtype))["route"] == "vector"
    assert LK.compact_rows_plan(wide[..., 1:65])["route"] == "scalar"
    assert LK.compact_rows_plan(maps[..., :65])["route"] == "scalar"


K9_THREADS, K9_WORDS = 256, 2  # csrc/compact_rows.cu kThreads and kWords: a forward thread's two 32-entry words
K9_TILE = K9_THREADS * K9_WORDS * 32  # kTile: fg entries a tile


def _k9_block_scan(v):
    """csrc/compact_rows.cu block_exclusive_scan over 256 threads' counts v in numpy: each warp's shuffle-up
    (Hillis-Steele) inclusive scan, then each thread adds the totals of the warps before its own. Returns (exclusive
    prefixes, total)."""
    lanes = np.arange(32)
    w = v.reshape(K9_THREADS // 32, 32).copy()
    for o in (1, 2, 4, 8, 16):  # as __shfl_up_sync with `if (lane >= o) inc += n`
        up = np.concatenate([np.zeros_like(w[:, :o]), w[:, :-o]], 1)
        w = np.where(lanes >= o, w + up, w)
    sums = w[:, 31]
    before = (np.cumsum(sums) - sums)[:, None] + w - v.reshape(w.shape)
    return before.reshape(-1), int(sums.sum())


def _k9_nth_set_bit(m, r):
    """csrc/compact_rows.cu nth_set_bit, elementwise: the position of m's r-th set bit (from 0), by halving."""
    m, r, at = m.astype(np.uint32), r.astype(np.int64), np.zeros(np.shape(r), np.int64)
    for width in (16, 8, 4, 2, 1):
        c = np.bitwise_count(m & np.uint32((1 << width) - 1)).astype(np.int64)
        go = r >= c
        r, m, at = np.where(go, r - c, r), np.where(go, m >> np.uint32(width), m), at + np.where(go, width, 0)
    return at


def _k9_scan(fg, k, shares):
    """csrc/compact_rows.cu compact_forward's positions in numpy, block by block of its (B, S) grid. Each block reads
    its image's whole fg row in the row's 16-byte frame (entry e at bit e + head, head the row's offset in its 16-byte
    piece: rows of a contiguous mask start at b * A), tiles of K9_TILE entries, thread t the words 2t and 2t + 1 of a
    tile; the block scan over the threads' counts carried from tile to tile gives each word the foreground entries
    before it. Block s writes pos over its slice [s * ceil(A / S), ..) of A (the foreground entry with f foreground
    entries before it at f, another e at nfg + (e - f), -1 from K on) and resolves its share [s * ceil(K / S), ..) of
    the K positions into a list, tile by tile: a foreground position by the last word whose count before it is at
    most p and a select of the bit, another by the same over the other entries; the list goes to idx. Returns
    (idx (B, K), pos (B, A), the writes of each idx entry, of each pos entry); entries never written hold -7."""
    b, a = fg.shape
    idx, pos = np.full((b, k), -7, np.int64), np.full((b, a), -7, np.int64)
    idx_writes, pos_writes = np.zeros((b, k), np.int64), np.zeros((b, a), np.int64)
    share, piece = -(-k // shares), -(-a // shares)
    bit = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for i in range(b):
        head = i * a % 16
        tiles = -(-(head + a) // K9_TILE)
        frame = np.zeros(tiles * K9_TILE, bool)
        frame[head:head + a] = fg[i]
        words = (frame.reshape(-1, 32) * bit).sum(1, dtype=np.uint64).astype(np.uint32)
        ones = np.bitwise_count(words).astype(np.int64)
        before = np.zeros(len(words), np.int64)  # foreground entries of the row before each word
        in_tile, carry = [], 0
        for tile in range(tiles):
            w = slice(tile * K9_TILE // 32, (tile + 1) * K9_TILE // 32)
            c = ones[w].reshape(K9_THREADS, K9_WORDS)
            f, total = _k9_block_scan(c.sum(1))
            before[w] = (carry + f[:, None] + np.cumsum(c, 1) - c).reshape(-1)
            in_tile.append(total)
            carry += total
        nfg = carry
        first = np.arange(len(words)) * 32 - head  # each word's first entry
        others = np.clip(first, 0, a) - before  # the row's other entries before each word
        for s in range(shares):
            p0, lo = min(s * piece, a), min(s * share, k)
            e = np.arange(p0, min(p0 + piece, a))
            g = e + head
            mw = words[g >> 5]
            fb = before[g >> 5] + np.bitwise_count(mw & ((np.uint32(1) << (g & 31).astype(np.uint32)) - np.uint32(1)))
            q = np.where((mw >> (g & 31).astype(np.uint32)) & 1, fb, nfg + e - fb)
            pos[i, e] = np.where(q < k, q, -1)
            pos_writes[i, e] += 1
            p = np.arange(lo, min(lo + share, k))
            anchor = np.full(len(p), -7, np.int64)  # the block's list: position p - lo -> row
            carry = 0
            for tile in range(tiles):
                w0, t0 = tile * K9_TILE // 32, tile * K9_TILE
                w = slice(w0, w0 + K9_TILE // 32)
                bg0 = max(t0 - head, 0) - carry
                bg1 = min(t0 + K9_TILE - head, a) - carry - in_tile[tile]
                fgp = (p < nfg) & (p >= carry) & (p < carry + in_tile[tile])
                u = w0 + np.searchsorted(before[w], p[fgp], side="right") - 1
                anchor[fgp] = first[u] + _k9_nth_set_bit(words[u], p[fgp] - before[u])
                q = p - nfg
                bgp = (p >= nfg) & (q >= bg0) & (q < bg1)
                u = w0 + np.searchsorted(others[w], q[bgp], side="right") - 1
                valid = ((first[u][:, None] + np.arange(32) >= 0) & (first[u][:, None] + np.arange(32) < a)) * bit
                anchor[bgp] = first[u] + _k9_nth_set_bit(~words[u] & valid.sum(1, dtype=np.uint64).astype(np.uint32),
                                                         q[bgp] - others[u])
                carry += in_tile[tile]
            idx[i, p] = anchor
            idx_writes[i, p] += 1
    return idx, pos, idx_writes, pos_writes


@pytest.mark.parametrize("shares", ["one", "production", "ragged"])
@pytest.mark.parametrize("a,k,frac", [(8400, 320, 0.02), (8400, 2560, 0.3), (2100, 2100, 0.5), (8193, 160, 0.0),
                                      (33600, 160, 0.01), (300, 16, 1.0)])
def test_k9_scan_model_gives_the_plain_positions(a, k, frac, shares):
    """The numpy model of K9's forward grid (`_k9_scan`: the per-block row read, the block scan, the pos slices and
    the share lists) writes every pos and every idx entry exactly once, and both equal the plain version's
    (`compact_rows_plain`: lax.top_k's order) at the train step's A (8,400; 2,100 at 320, rows not 16-byte aligned;
    33,600 at 1,280, several tiles), A one past a 16-byte piece, nfg 0, nfg > k and every row foreground; with one
    block an image, the wrapper's S (`compact_rows_shares`) and 13, which divides none of the K."""
    s = {"one": 1, "production": LK.compact_rows_shares(2, k), "ragged": 13}[shares]
    assert shares != "ragged" or k % s
    rng = np.random.default_rng(a + k)
    fg = rng.uniform(size=(2, a)) < frac
    idx, pos, idx_writes, pos_writes = _k9_scan(fg, k, s)
    _, widx, wpos = LK.compact_rows_plain(torch.zeros(2, a, 1), torch.from_numpy(fg), k)
    assert (idx_writes == 1).all() and (pos_writes == 1).all()
    np.testing.assert_array_equal(idx, widx.numpy())
    np.testing.assert_array_equal(pos, wpos.numpy())


def test_k9_shares_follow_the_shapes_alone():
    """S, K9's forward blocks an image (`compact_rows_shares`): 8 at the train step's B 16, K 320 (shares of 40, 128
    blocks); at least 32 positions a block, about 132 blocks in all, and at least one block an image, K 0 included."""
    assert LK.compact_rows_shares(16, 320) == 8
    assert LK.compact_rows_shares(1, 320) == 10 and LK.compact_rows_shares(16, 160) == 5
    assert LK.compact_rows_shares(16, 200) == 7 and 200 % 7  # a ragged share (chip_smoke.COMPACT_CASES, M 20)
    assert LK.compact_rows_shares(16, 2560) == 8 and -(-2560 // 8) > K9_THREADS  # a share walked in two chunks
    assert LK.compact_rows_shares(256, 320) == 1 and LK.compact_rows_shares(2, 0) == 1
