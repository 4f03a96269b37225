"""yololite_tpu_torch train math vs the JAX package, on the CPU: box algebra, K5-K7, TAL, the loss, optimizers, EMA.

The same numpy-seeded inputs go through the JAX function and the port's.
The hand-written backwards (K5 `dfl_expectation_mm`, K6a `dfl_ce_mean` and
K6b `bce_sum`, ops of ops/loss_kernels.py with autograd registered) are held
to JAX's custom vjps and to torch autograd of the plain forward. The assigner's outputs are held exactly where they are exact
(foreground mask, assigned GT, labels, boxes); inputs are drawn so that
candidates do not tie within rounding: class logits on the grid where both
frameworks' sigmoid agree (tests/test_torch_nms.py `_safe_grid`) and box
logits spread wide.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from yololite_tpu.engine import optim as joptim
from yololite_tpu.ops import boxes as jboxes
from yololite_tpu.ops import decode as jdecode
from yololite_tpu.utils import ema as jema
from yololite_tpu.utils import loss as jloss
from yololite_tpu.utils import tal as jtal

from yololite_tpu_torch.engine import optim as toptim
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models import modules as TM
from yololite_tpu_torch.ops import boxes as tboxes
from yololite_tpu_torch.ops import decode as tdecode
from yololite_tpu_torch.ops import loss_kernels as LK
from yololite_tpu_torch.ops import optim_kernels as OK
from yololite_tpu_torch.utils import ema as tema
from yololite_tpu_torch.utils import loss as tloss
from yololite_tpu_torch.utils import tal as ttal

from tests.test_torch_nms import STRIDES, _feats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _assert_grad(got, want, rtol=1e-5, atol_rel=1e-7):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _boxes(rng, shape, span=100.0):
    c = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(1, span / 2, shape + (2,))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


# ---------------- box algebra ----------------


@pytest.mark.parametrize("kind", ["IoU", "CIoU"])
@pytest.mark.parametrize("xywh", [False, True], ids=["xyxy", "xywh"])
def test_bbox_iou_matches_jax(kind, xywh):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (64, 1)), _boxes(rng, (1, 80))
    kw = {kind: True} if kind != "IoU" else {}
    want = np.asarray(jboxes.bbox_iou(jnp.asarray(a), jnp.asarray(b), xywh=xywh, **kw))
    got = tboxes.bbox_iou(_t(a), _t(b), xywh=xywh, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_bbox_iou_ciou_gradient_holds_alpha_constant():
    """d CIoU / d box1 equals jax.grad's, which stops the gradient at the aspect term's alpha."""
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, (50,)), _boxes(rng, (50,))
    want = jax.grad(lambda x: jboxes.bbox_iou(x, jnp.asarray(b), xywh=False, CIoU=True).sum())(jnp.asarray(a))
    ta = _t(a, grad=True)
    tboxes.bbox_iou(ta, _t(b), xywh=False, CIoU=True).sum().backward()
    _assert_grad(ta.grad.numpy(), np.asarray(want), rtol=1e-5)


def test_bbox2dist_and_bbox_ioa_match_jax():
    rng = np.random.default_rng(2)
    anchors = rng.uniform(0, 20, (300, 2)).astype(np.float32)
    boxes = _boxes(rng, (2, 300), span=20.0)
    want = np.asarray(jboxes.bbox2dist(jnp.asarray(anchors), jnp.asarray(boxes), 15))
    got = tboxes.bbox2dist(_t(anchors), _t(boxes), 15).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.max() <= 15 - 0.01 and got.min() >= 0
    a, b = _boxes(rng, (40,)), _boxes(rng, (30,))
    np.testing.assert_array_equal(tboxes.bbox_ioa(a, b), jboxes.bbox_ioa(a, b))


# ---------------- K5, K6: the hand-written backwards ----------------


def _check_function(torch_fn, plain_fn, jax_fn, inputs, dtype, atol_rel=1e-7):
    """Forward vs JAX (rtol 1e-6); backward vs JAX's custom vjp and vs torch autograd of the plain forward.

    fp32 backward: rtol 1e-5, atol atol_rel * max|grad|. bf16: rtol 2^-7 (one
    bf16 ulp) and atol 2^-6 * max|grad|: bce_sum's backward runs in bf16 in
    both packages, and XLA's bf16 sigmoid rounds otherwise than torch's
    (measured 1.3e-2 * |g| apart, each within 1.1e-2 * |g| of the exact value).
    """
    rng = np.random.default_rng(3)
    x32, *rest = inputs
    x = x32.astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    jrest = [jnp.asarray(r) for r in rest]
    trest = [_t(r) for r in rest]

    jout, vjp = jax.vjp(lambda v: jax_fn(v, *jrest), jx)
    tout = torch_fn(tx, *trest)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)

    g = rng.standard_normal(tout.shape).astype(np.float32)
    tout.backward(_t(g))
    assert tx.grad.dtype == dtype  # the gradient comes out in the logits' dtype
    (jg,) = vjp(jnp.asarray(g))
    assert jg.dtype == jx.dtype
    got = tx.grad.float().numpy()
    if dtype == torch.bfloat16:
        want = np.asarray(jg, np.float32)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -6 * np.abs(want).max())
        return
    _assert_grad(got, np.asarray(jg), atol_rel=atol_rel)
    tx2 = torch.from_numpy(x).requires_grad_(True)
    plain_fn(tx2, *trest).backward(_t(g))
    _assert_grad(got, tx2.grad.numpy(), atol_rel=atol_rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dfl_expectation_backward_matches_jax(dtype):
    """K5 `dfl_expectation_mm`: dE/dx = softmax * (proj - E) per side.

    Against JAX the atol is 2e-6 * max|grad|: the two forwards sum E in other
    orders (XLA as a matmul), so E differs by up to 2 ulps, and proj - E
    cancels where E sits near a bin (measured 5.8e-6 at max|grad| 7.2).
    Autograd of the plain forward cancels in its own order: 4.2e-6 from the
    closed form on the same E.
    """
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 300, 64)) * 3).astype(np.float32)
    _check_function(tdecode.dfl_expectation_mm, lambda v: LK._dfl_mm_parts(v, 16)[0],
                    lambda v: jdecode.dfl_expectation_mm(v, 16), [x], dtype, atol_rel=2e-6)


def test_dfl_expectation_forward_keeps_its_bits():
    """With a gradient to take, the forward gives the bits of the inference path."""
    x = torch.from_numpy((np.random.default_rng(5).standard_normal((3, 50, 64)) * 4).astype(np.float32))
    with torch.no_grad():
        plain = tdecode.dfl_expectation_mm(x)
    out = tdecode.dfl_expectation_mm(x.clone().requires_grad_(True))
    assert torch.equal(out.detach(), plain)
    assert "yololite_tpu_torch_dfl_expectation" in type(out.grad_fn).__name__  # the K5 op's registered backward


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dfl_ce_backward_matches_jax(dtype):
    """K6a `dfl_ce_mean`: (softmax - two-hot target) / 4, the targets clipped to reg_max - 1.01."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 300, 64)) * 3).astype(np.float32)
    target = rng.uniform(-1, 16, (2, 300, 4)).astype(np.float32)  # past both clips
    _check_function(tloss.dfl_ce_mean, lambda v, t: LK._dfl_ce_parts(v, t)[0], jloss.dfl_ce_mean, [x, target],
                    dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_bce_sum_backward_matches_jax(dtype):
    """K6b `bce_sum`: sigmoid(x) - y, in the logits' dtype."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 300, 80)) * 4).astype(np.float32)
    y = (rng.uniform(0, 1, (2, 300, 80)) * (rng.uniform(size=(2, 300, 80)) > 0.9)).astype(np.float32)
    _check_function(tloss.bce_sum, lambda v, t: LK.sigmoid_bce(v, t).sum(), jloss.bce_sum, [x, y], dtype)


# ---------------- TAL (K7 and the assigner) ----------------


def _tal_inputs(rng, B=2, M=6, n_valid=(6, 3), nc=5, shapes=((16, 16), (8, 8), (4, 4))):
    feats = _feats(rng, B=B, shapes=shapes, nc=nc)
    x = np.concatenate([f.reshape(B, -1, f.shape[-1]) for f in feats], 1)
    anchors, strides = (np.asarray(a) for a in jboxes.make_anchors(shapes, STRIDES, 0.5))
    dist = np.asarray(jdecode.dfl_expectation_mm(jnp.asarray(x[..., :64]), 16))
    pd_bboxes = (np.asarray(jboxes.dist2bbox(jnp.asarray(dist), jnp.asarray(anchors), xywh=False)) * strides)
    pd_scores = np.asarray(jax.nn.sigmoid(jnp.asarray(x[..., 64:])))
    gt_bboxes = np.zeros((B, M, 4), np.float32)
    gt_labels = np.zeros((B, M, 1), np.int32)
    mask_gt = np.zeros((B, M, 1), np.float32)
    for b, n in enumerate(n_valid):
        gt_bboxes[b, :n] = _boxes(rng, (n,), span=128.0)
        gt_labels[b, :n, 0] = rng.integers(0, nc, n)
        mask_gt[b, :n] = 1
    return pd_scores, pd_bboxes.astype(np.float32), anchors * strides, gt_labels, gt_bboxes, mask_gt


def _check_assign(args, topk=10, nc=5):
    want = jtal.TaskAlignedAssigner(topk=topk, num_classes=nc, alpha=0.5, beta=6.0)(*(jnp.asarray(a) for a in args))
    got = ttal.TaskAlignedAssigner(topk=topk, num_classes=nc, alpha=0.5, beta=6.0)(*(_t(a) for a in args))
    labels, bboxes, scores, fg, gt_idx = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[3].numpy(), fg)
    np.testing.assert_array_equal(got[4].numpy(), gt_idx)
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_array_equal(got[1].numpy(), bboxes)
    np.testing.assert_allclose(got[2].numpy(), scores, rtol=1e-5, atol=1e-7)
    return fg


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("topk", [10, 1])
def test_assigner_matches_jax(seed, topk):
    fg = _check_assign(_tal_inputs(np.random.default_rng(100 + seed)), topk=topk)
    assert fg.sum() > 0


def test_assigner_without_gts_matches_jax():
    """Every GT row masked, and no GT rows at all (M = 0): nothing is foreground."""
    args = list(_tal_inputs(np.random.default_rng(9), n_valid=(0, 0)))
    assert not _check_assign(args).any()
    args[3], args[4], args[5] = args[3][:, :0], args[4][:, :0], args[5][:, :0]
    got = ttal.TaskAlignedAssigner(topk=10, num_classes=5)(*(_t(a) for a in args))
    want = jtal.TaskAlignedAssigner(topk=10, num_classes=5)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_ties_go_to_the_lowest_index():
    """K7: the per-GT top-k over a metric full of ties picks the lowest indices, as lax.top_k does."""
    rng = np.random.default_rng(10)
    metrics = rng.integers(0, 4, (2, 5, 500)).astype(np.float32) / 4  # four values: ties everywhere
    mask_gt = np.ones((2, 5, 1), np.float32)
    mask_gt[1, 3:] = 0
    want = jtal.TaskAlignedAssigner(topk=10)._select_topk_candidates(jnp.asarray(metrics), jnp.asarray(mask_gt))
    got = ttal.TaskAlignedAssigner(topk=10)._select_topk_candidates(_t(metrics), _t(mask_gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    top = metrics[0, 0].max()
    assert (got[0, 0].numpy().nonzero()[0] == np.flatnonzero(metrics[0, 0] == top)[:10]).all()


# ---------------- the loss ----------------


def _targets(rng, B, M, imgsz=128, nc=5):
    """A ragged batch of GTs (normalized xywh) and its padding by build_targets in both packages."""
    n = [int(rng.integers(1, M)) for _ in range(B)]
    bi = np.concatenate([np.full(k, b) for b, k in enumerate(n)]).astype(np.float32)
    c = rng.uniform(0.2, 0.8, (len(bi), 2))
    wh = rng.uniform(0.1, 0.4, (len(bi), 2))
    batch = {"batch_idx": bi, "cls": rng.integers(0, nc, (len(bi), 1)).astype(np.float32),
             "bboxes": np.concatenate([c, wh], 1).astype(np.float32)}
    want = jloss.build_targets(batch, B, (imgsz, imgsz), M)
    got = tloss.build_targets(batch, B, (imgsz, imgsz), M)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    return got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("e2e", [False, True], ids=["v8", "e2e"])
def test_loss_and_gradient_match_jax(seed, e2e):
    """Loss items within rtol 1e-5 and d loss / d maps within rtol 1e-4 of jax.grad, both packages in their default
    compact box/DFL form (A 336, K 160)."""
    rng = np.random.default_rng(20 + seed)
    shapes = ((16, 16), (8, 8), (4, 4))
    feats = _feats(rng, B=2, shapes=shapes, nc=5)
    targets = _targets(rng, 2, 16)
    hyp = type("H", (), {"box": 7.5, "cls": 0.5, "dfl": 1.5})()
    if e2e:
        feats2 = _feats(rng, B=2, shapes=shapes, nc=5)
        jl = jloss.E2EDetectLoss(5, STRIDES, 16, hyp=hyp)
        tl = tloss.E2EDetectLoss(5, STRIDES, 16, hyp=hyp)
        pack = lambda fs: {"one2many": fs[:3], "one2one": fs[3:]}
        maps = feats + feats2
    else:
        jl = jloss.v8DetectionLoss(5, STRIDES, 16, hyp=hyp)
        tl = tloss.v8DetectionLoss(5, STRIDES, 16, hyp=hyp)
        pack = lambda fs: fs
        maps = feats
    assert jloss.COMPACT_BOX_LOSS

    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    (jtotal, jitems), jgrads = jax.value_and_grad(lambda fs: jl(pack(fs), jt), has_aux=True)(
        [jnp.asarray(f) for f in maps])
    tmaps = [_t(f, grad=True) for f in maps]
    total, items = tl(pack(tmaps), {k: _t(v) for k, v in targets.items()})
    total.backward()
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), rtol=1e-5)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    assert items.numpy().min() > 0
    g_all = np.concatenate([np.asarray(g).ravel() for g in jgrads])
    for tm, jg in zip(tmaps, jgrads):
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6 * np.abs(g_all).max())


# ---------------- optimizers, clip, EMA ----------------


class _Tiny(nn.Module):
    """A decay group (conv weights), a BN group, a bias group (BN and conv biases) and a frozen row 2."""

    def __init__(self):
        super().__init__()
        self.model = nn.Sequential(TM.Conv(3, 4, 3), nn.Conv2d(4, 5, 1), TM.Conv(5, 2, 1))
        rng = np.random.default_rng(30)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        for p in self.model[2].parameters():
            p.requires_grad_(False)


def _port_optimizer(name, model, wd):
    """The port's optimizer over the model with its gradients allocated and K10's table over them and an EMA."""
    opt = toptim.build_optimizer(name, model, lr=0.01, momentum=0.9, weight_decay=wd)
    for p in opt.params:
        p.grad = torch.zeros_like(p)
    ema = tema.ModelEMA(model)
    opt.track(model, ema)
    return opt, ema


def _port_apply(opt, ema, named, grads, lr_vec, momentum):
    for n, p in named.items():
        if p.requires_grad:
            p.grad.copy_(_t(grads[n]))
    opt.set_lr_momentum(np.float32(lr_vec), momentum)
    ema.advance()
    return opt.apply(ema.d, ema.one_minus_d)


@pytest.mark.parametrize("name", list(toptim.OPTIMIZERS))
def test_optimizers_match_jax(name):
    """3 steps with lr and momentum moving between steps: params and moments equal to the JAX update's, rtol 1e-6,
    atol 1e-7 for all 7 rules. The port computes the bias corrections on the device in fp32 as the JAX package
    does, and AdamW takes sqrt(v / b2t) as it does. The gradients stay under the clip's norm (its factor is then
    exactly 1), so the step is the update rule's alone."""
    model = _Tiny()
    params, _ = ckpt.jax_trees(model)
    labels = joptim.build_group_labels(params)
    trainable = {k: jax.tree.map(lambda _: 0.0 if k == "2" else 1.0, v) for k, v in params.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = joptim.init_state(jparams)
    wd = 0.05
    opt, ema = _port_optimizer(name, model, wd)
    named = dict(model.named_parameters())
    assert [opt.groups.count(g) for g in range(3)] == [2, 2, 1]  # bias, weight, bn; row 2 frozen
    rng = np.random.default_rng(31)
    for lr_vec, momentum in (([0.01, 0.02, 0.03], 0.8), ([0.02, 0.01, 0.005], 0.85), ([0.005, 0.03, 0.01], 0.9)):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) * 0.1 for n, p in named.items()}
        jgrads = ckpt.tree_of(model, {n: _t(g) * (0.0 if n.startswith("model.2.") else 1.0)
                                      for n, g in grads.items()})
        clip = _port_apply(opt, ema, named, grads, lr_vec, momentum)
        assert float(clip[1]) == 1.0
        jparams, jstate = joptim.UPDATES[name](jparams, jax.tree.map(jnp.asarray, jgrads), jstate, labels,
                                               jnp.asarray(np.float32(lr_vec)), jnp.float32(momentum), wd,
                                               trainable=trainable)
    got, _ = ckpt.jax_trees(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    mu, nu = toptim.moments(name, opt, named)
    for mine, theirs in ((ckpt.tree_of(model, mu), jstate.mu), (ckpt.tree_of(model, nu), jstate.nu)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ckpt.jax_trees(model)[0]["2"]["conv"]["w"], params["2"]["conv"]["w"])


def test_load_moments_resumes_the_trajectory():
    """Moments saved after 2 steps and loaded into a fresh optimizer give the 3rd step of an unbroken run."""
    for name in toptim.OPTIMIZERS:
        runs = []
        for resume in (False, True):
            model = _Tiny()
            opt, ema = _port_optimizer(name, model, 0.05)
            named = {n: p for n, p in model.named_parameters() if p.requires_grad}
            rng = np.random.default_rng(32)
            for step in range(3):
                if resume and step == 2:
                    mu, nu = toptim.moments(name, opt, named)
                    mu, nu = ({k: v.clone() for k, v in d.items()} for d in (mu, nu))
                    opt = toptim.build_optimizer(name, model, lr=0.01, momentum=0.9, weight_decay=0.05)
                    toptim.load_moments(name, opt, named, mu, nu, step=2, beta1=0.9)
                    opt.track(model, ema)
                grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in named.items()}
                _port_apply(opt, ema, named, grads, [0.01, 0.01, 0.01], 0.9)
            runs.append([p.detach().clone() for p in named.values()])
        for a, b in zip(*runs):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def test_clip_and_nadam_mu_product_match_jax():
    rng = np.random.default_rng(33)
    grads = {"a": rng.standard_normal((40, 3)).astype(np.float32) * 3, "b": rng.standard_normal(7).astype(np.float32)}
    jclipped, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 10.0)
    norm = OK.grad_norm_plain([_t(g) for g in grads.values()])  # K10's clip, plain
    clipped = [_t(g) * OK.clip_scale(norm, 10.0) for g in grads.values()]
    assert float(jnorm) > 10
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for c, k in zip(clipped, grads):
        np.testing.assert_allclose(c.numpy(), np.asarray(jclipped[k]), rtol=1e-6)
    for step in (0, 1, 7, 500):
        assert toptim.nadam_mu_product(step, 0.9) == joptim.nadam_mu_product(step, 0.9)


def test_ema_matches_jax():
    """EMA of params and BN statistics over 3 updates, the decay ramped by the update count."""
    model = _Tiny()
    ema = tema.ModelEMA(model)
    p0, s0 = ckpt.jax_trees(model)
    jp, js = jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, s0)
    rng = np.random.default_rng(34)
    for u in range(1, 4):
        with torch.no_grad():
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.add_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        ema.update(model)
        p, s = ckpt.jax_trees(model)
        jp = jema.ema_update(jp, jax.tree.map(jnp.asarray, p), jnp.asarray(u))
        js = jema.ema_update(js, jax.tree.map(jnp.asarray, s), jnp.asarray(u))
    assert tema.ema_decay(2000) == pytest.approx(float(jema.ema_decay(jnp.asarray(2000))), rel=2.4e-7)  # 1 ulp: XLA exp
    gp, gs = ckpt.jax_trees(ema.ema)
    for a, b in zip(jax.tree.leaves((gp, gs)), jax.tree.leaves((jp, js))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    assert not ema.ema.training and not any(p.requires_grad for p in ema.ema.parameters())
