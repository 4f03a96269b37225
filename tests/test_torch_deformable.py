"""yololite_tpu_torch.models.deformable against yololite_tpu.models.deformable on the CPU.

The same numpy-seeded inputs go through the JAX function and the port's, at
a small size, within the zoo's bounds (rtol 1e-4, atol 2e-4). Init draws the
JAX init bit for bit (MSDeformAttn's grid bias and zeroed offset and weight
projections included), and the weight bridge carries each JAX tree across
with strict=True.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.models import deformable as JD
from yololite_tpu.models.modules import Ctx, KeyGen

from yololite_tpu_torch.models import deformable as TD
from yololite_tpu_torch.models import transformer as TT
from yololite_tpu_torch.models.checkpoint import jax_trees, state_dict_from_jax
from yololite_tpu_torch.models.modules import init_weights_

RTOL, ATOL = 1e-4, 2e-4
SHAPES = [(6, 6), (3, 3)]
D, HEADS, LEVELS, POINTS = 32, 4, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _perturb(params, seed):
    """Every leaf moved off its init value, so zeroed projections take part."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + rng.uniform(-0.1, 0.1, np.shape(x)), jnp.float32),
                        params)


def _pair(jmod, tmod, seed=0):
    """Init both from one seed, check the draw, then give both the same perturbed weights."""
    p, s = jmod.init(KeyGen(seed))
    init_weights_(tmod, np.random.default_rng(seed))
    want = state_dict_from_jax(_np_tree(p), _np_tree(s), prefix="")
    got = tmod.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    jp, jt = jax_trees(tmod, prefix="")
    assert jax.tree.structure(jp) == jax.tree.structure(_np_tree(p))  # the bridge knows every leaf
    p = _perturb(p, seed + 1)
    tmod.load_state_dict(state_dict_from_jax(_np_tree(p), _np_tree(s), prefix=""), strict=True)
    return p, s


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_inverse_sigmoid_matches_jax():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (50,)).astype(np.float32)
    np.testing.assert_allclose(TD.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(JD.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_grid_sample_bilinear_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((3, 8, 10, 4), dtype=np.float32)
    grid = rng.uniform(-1.3, 1.3, (3, 5, 7, 2)).astype(np.float32)  # out-of-range taps included
    _close(TD.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid)),
           JD.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid)))


def test_multi_scale_deformable_attn_matches_jax():
    rng = np.random.default_rng(1)
    B, c, Q = 2, 8, 6
    len_v = sum(h * w for h, w in SHAPES)
    value = rng.standard_normal((B, len_v, HEADS, c), dtype=np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, HEADS, LEVELS, 3, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Q, HEADS, LEVELS, 3)).astype(np.float32)
    _close(TD.multi_scale_deformable_attn(torch.from_numpy(value), SHAPES, torch.from_numpy(loc), torch.from_numpy(w)),
           JD.multi_scale_deformable_attn(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w)))


@pytest.mark.parametrize("refer", [2, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_msdeformattn_matches_jax(refer, masked):
    jmod, tmod = JD.MSDeformAttn(D, LEVELS, HEADS, POINTS), TD.MSDeformAttn(D, LEVELS, HEADS, POINTS)
    p, s = _pair(jmod, tmod, seed=3)
    rng = np.random.default_rng(2)
    len_v = sum(h * w for h, w in SHAPES)
    B, Q = 2, 5
    query = rng.standard_normal((B, Q, D), dtype=np.float32)
    refer_bbox = rng.uniform(0.2, 0.8, (B, Q, LEVELS, refer)).astype(np.float32)
    value = rng.standard_normal((B, len_v, D), dtype=np.float32)
    mask = rng.uniform(size=(B, len_v)) > 0.3
    jin = (jnp.asarray(query), jnp.asarray(refer_bbox), jnp.asarray(value), SHAPES) + (
        (jnp.asarray(mask),) if masked else ())
    want = jmod(p, s, jin, Ctx(False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(query), torch.from_numpy(refer_bbox), torch.from_numpy(value), SHAPES,
                   torch.from_numpy(mask) if masked else None)
    _close(got, want)


def test_msdeformattn_init_is_the_grid_prior():
    tmod = TD.MSDeformAttn(D, LEVELS, HEADS, POINTS)
    init_weights_(tmod, np.random.default_rng(0))
    assert not tmod.sampling_offsets.weight.any() and not tmod.attention_weights.weight.any()
    assert not tmod.attention_weights.bias.any() and tmod.sampling_offsets.bias.abs().max() == POINTS
    with pytest.raises(ValueError, match="2 or 4"):
        tmod(torch.zeros(1, 2, D), torch.zeros(1, 2, LEVELS, 3), torch.zeros(1, 45, D), SHAPES)


def _layer_inputs(rng, B=2, Q=5):
    len_v = sum(h * w for h, w in SHAPES)
    return (rng.standard_normal((B, Q, D), dtype=np.float32), rng.uniform(0.2, 0.8, (B, Q, 2)).astype(np.float32),
            rng.standard_normal((B, len_v, D), dtype=np.float32), rng.standard_normal((B, Q, D), dtype=np.float32))


@pytest.mark.parametrize("with_pos", [False, True], ids=["nopos", "pos"])
def test_decoder_layer_matches_jax(with_pos):
    args = dict(d_model=D, n_heads=HEADS, d_ffn=64, n_levels=LEVELS, n_points=POINTS)
    jmod, tmod = JD.DeformableTransformerDecoderLayer(**args), TD.DeformableTransformerDecoderLayer(**args)
    p, s = _pair(jmod, tmod, seed=5)
    embed, refer, feats, pos = _layer_inputs(np.random.default_rng(3))
    jin = (jnp.asarray(embed), jnp.asarray(refer), jnp.asarray(feats), SHAPES, None) + (
        (jnp.asarray(pos),) if with_pos else ())
    want = jmod(p, s, jin, Ctx(False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(embed), torch.from_numpy(refer), torch.from_numpy(feats), SHAPES, None,
                   torch.from_numpy(pos) if with_pos else None)
    _close(got, want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_matches_jax(train):
    """Three layers with per-layer bbox and score heads and a query-position MLP (Linear layers here)."""
    n_layers, nc = 3, 5
    layer = lambda lib: lambda: lib.DeformableTransformerDecoderLayer(D, HEADS, 64, 0.0, LEVELS, POINTS)
    jdec, tdec = JD.DeformableTransformerDecoder(D, layer(JD), n_layers), TD.DeformableTransformerDecoder(
        D, layer(TD), n_layers)
    p, s = jdec.init(KeyGen(7))
    tdec.init(7)
    want_sd = state_dict_from_jax(_np_tree(p), _np_tree(s), prefix="")
    assert all(torch.equal(v, want_sd[k]) for k, v in tdec.state_dict().items()) and set(want_sd) == set(
        tdec.state_dict())
    p = _perturb(p, 8)
    tdec.load_state_dict(state_dict_from_jax(_np_tree(p), _np_tree(s), prefix=""), strict=True)

    rng = np.random.default_rng(9)
    heads = []
    for c2 in [4] * n_layers + [nc] * n_layers + [D]:
        w = rng.uniform(-0.3, 0.3, (c2, D if c2 != D else 4)).astype(np.float32)
        b = rng.uniform(-0.3, 0.3, (c2,)).astype(np.float32)
        heads.append((w, b))
    jf = [lambda x, w=w, b=b: x @ jnp.asarray(w).T + jnp.asarray(b) for w, b in heads]
    tf = [lambda x, w=w, b=b: x @ torch.from_numpy(w).T + torch.from_numpy(b) for w, b in heads]
    embed, _, feats, _ = _layer_inputs(rng)
    refer_logit = rng.uniform(-2, 2, (2, 5, 4)).astype(np.float32)  # cxcywh logits
    want = jdec(p, s, (jnp.asarray(embed), jnp.asarray(refer_logit), jnp.asarray(feats), SHAPES), Ctx(train),
                bbox_heads=jf[:n_layers], score_heads=jf[n_layers:2 * n_layers], pos_mlp=jf[-1], train=train)
    with torch.no_grad():
        got = tdec(torch.from_numpy(embed), torch.from_numpy(refer_logit), torch.from_numpy(feats), SHAPES,
                   bbox_heads=tf[:n_layers], score_heads=tf[n_layers:2 * n_layers], pos_mlp=tf[-1], train=train)
    assert got[0].shape == want[0].shape == ((n_layers if train else 1), 2, 5, 4)
    for g, w in zip(got, want):
        _close(g, w)


def test_decoder_backward_runs():
    """Train mode: the refined boxes are detached between layers, and every layer's weights get a gradient."""
    tdec = TD.DeformableTransformerDecoder(D, lambda: TD.DeformableTransformerDecoderLayer(D, HEADS, 64, 0.0, LEVELS,
                                                                                           POINTS), 2).init(0)
    lin = [TT.Linear(D, 4) for _ in range(2)] + [TT.Linear(D, 3) for _ in range(2)]
    embed, _, feats, _ = _layer_inputs(np.random.default_rng(1))
    refer = torch.zeros(2, 5, 4)
    boxes, logits = tdec(torch.from_numpy(embed), refer, torch.from_numpy(feats), SHAPES,
                         bbox_heads=lin[:2], score_heads=lin[2:], train=True)
    (boxes.sum() + logits.sum()).backward()
    assert all(p.grad is not None for n, p in tdec.named_parameters() if "linear" in n)
