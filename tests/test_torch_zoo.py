"""yololite_tpu_torch's extended block zoo vs the JAX package's, block by block, on the CPU.

Each block is built in both packages with the same arguments; the port's
`init_weights_` must draw the JAX `init` bit for bit. The JAX block's weights,
with its biases, BN statistics and small leaves perturbed, go into the port
through `state_dict_from_jax`, and the same numpy input goes through both:

- eval: outputs within rtol 1e-4, atol 2e-4 (tests/test_model_parity.py's
  tolerance: the two frameworks sum convolutions in different orders);
- train: outputs from batch statistics within the same tolerance, and every
  BN's running statistics after the step equal to the JAX update (ctx.updates
  merged into the state) within it too;
- fused: `fuse_tree` in JAX against `fuse_` here, outputs within the same
  tolerance.

The YOLO-World blocks take their guide or text inputs. Every name of the JAX
registry also builds in the port inside a small spec with equal init(0)
weights, Detect strides and save list.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.models import modules as JM
from yololite_tpu.models import transformer as JT
from yololite_tpu.models import zoo as JZ
from yololite_tpu.models.model import REGISTRY as JAX_REGISTRY
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.models.modules import fuse_tree

from yololite_tpu_torch.models import modules as TM
from yololite_tpu_torch.models import transformer as TT
from yololite_tpu_torch.models import zoo as TZ
from yololite_tpu_torch.models.checkpoint import jax_trees, state_dict_from_jax
from yololite_tpu_torch.models.model import REGISTRY, YOLO11_REGISTRY, DetectionModel

RTOL, ATOL = 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _perturb(params, state, seed):
    """Biases, BN affine and statistics and every small leaf moved off their init values (weights kept)."""
    rng = np.random.default_rng(seed)

    def p(path, x):
        x = np.asarray(x)
        if x.ndim <= 1 or getattr(path[-1], "key", None) == "scale":
            x = x + rng.uniform(-0.2, 0.2, x.shape)
        return jnp.asarray(x, jnp.float32)

    def s(path, x):
        x = np.asarray(x)
        is_var = getattr(path[-1], "key", None) == "var"
        return jnp.asarray(x * rng.uniform(0.5, 1.5, x.shape) if is_var else x + rng.uniform(-0.2, 0.2, x.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(p, params), jax.tree_util.tree_map_with_path(s, state)


# input kinds: NHWC maps go to the port as NCHW; tokens (B, N, C) go as they are
def _map(*shape):
    return ("map", shape)


def _tokens(*shape):
    return ("tokens", shape)


# (label, JAX module, port module, constructor args, inputs)
BLOCKS = [
    ("Focus", JZ.Focus, TZ.Focus, (3, 16, 3), [_map(2, 16, 12, 3)]),
    ("GhostConv", JZ.GhostConv, TZ.GhostConv, (16, 32, 3, 1), [_map(2, 8, 8, 16)]),
    ("GhostBottleneck-s2", JZ.GhostBottleneck, TZ.GhostBottleneck, (16, 32, 3, 2), [_map(2, 8, 8, 16)]),
    ("GhostBottleneck-s1", JZ.GhostBottleneck, TZ.GhostBottleneck, (32, 32, 3, 1), [_map(2, 8, 8, 32)]),
    ("ConvTranspose", JZ.ConvTranspose, TZ.ConvTranspose, (16, 8, 2, 2), [_map(2, 5, 6, 16)]),
    ("ConvTranspose-nobn", JZ.ConvTranspose, TZ.ConvTranspose, (16, 8, 4, 2, 1, False), [_map(2, 5, 6, 16)]),
    ("RepConv", JZ.RepConv, TZ.RepConv, (16, 32, 3, 2), [_map(2, 8, 8, 16)]),
    ("RepConv-idbn", JZ.RepConv, TZ.RepConv, (16, 16, 3, 1, 1, 1, 1, True, True), [_map(2, 8, 8, 16)]),
    ("LightConv", JZ.LightConv, TZ.LightConv, (16, 32, 3), [_map(2, 8, 8, 16)]),
    ("SPP", JZ.SPP, TZ.SPP, (32, 32), [_map(2, 16, 16, 32)]),
    ("SPPELAN", JZ.SPPELAN, TZ.SPPELAN, (32, 32, 16), [_map(2, 8, 8, 32)]),
    ("RepNCSPELAN4", JZ.RepNCSPELAN4, TZ.RepNCSPELAN4, (16, 32, 32, 16, 2), [_map(2, 8, 8, 16)]),
    ("ELAN1", JZ.ELAN1, TZ.ELAN1, (16, 32, 32, 16), [_map(2, 8, 8, 16)]),
    ("AConv", JZ.AConv, TZ.AConv, (16, 32), [_map(2, 9, 8, 16)]),
    ("ADown", JZ.ADown, TZ.ADown, (16, 32), [_map(2, 10, 9, 16)]),
    ("SCDown", JZ.SCDown, TZ.SCDown, (16, 32, 3, 2), [_map(2, 8, 8, 16)]),
    ("PSA", JZ.PSA, TZ.PSA, (128, 128), [_map(2, 4, 3, 128)]),
    ("C1", JZ.C1, TZ.C1, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("C2", JZ.C2, TZ.C2, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("C3x", JZ.C3x, TZ.C3x, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("C3Ghost", JZ.C3Ghost, TZ.C3Ghost, (16, 32, 1), [_map(2, 8, 8, 16)]),
    ("C3TR", JT.C3TR, TT.C3TR, (16, 32, 2), [_map(2, 4, 5, 16)]),
    ("RepC3", JZ.RepC3, TZ.RepC3, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("RepCSP", JZ.RepCSP, TZ.RepCSP, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("BottleneckCSP", JZ.BottleneckCSP, TZ.BottleneckCSP, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("C2fCIB-lk", JZ.C2fCIB, TZ.C2fCIB, (16, 32, 2, True, True), [_map(2, 8, 8, 16)]),
    ("C2fCIB", JZ.C2fCIB, TZ.C2fCIB, (16, 32, 1), [_map(2, 8, 8, 16)]),
    ("C2fPSA", JZ.C2fPSA, TZ.C2fPSA, (128, 128, 1), [_map(2, 4, 4, 128)]),
    ("C3f", JZ.C3f, TZ.C3f, (16, 32, 2), [_map(2, 8, 8, 16)]),
    ("CIB", JZ.CIB, TZ.CIB, (16, 16, True, 0.5, True), [_map(2, 8, 8, 16)]),
    ("RepVGGDW", JZ.RepVGGDW, TZ.RepVGGDW, (16,), [_map(2, 9, 9, 16)]),
    ("CBAM", JZ.CBAM, TZ.CBAM, (16, 7), [_map(2, 8, 8, 16)]),
    ("CBAM-k3", JZ.CBAM, TZ.CBAM, (16, 3), [_map(2, 8, 8, 16)]),
    ("ChannelAttention", JZ.ChannelAttention, TZ.ChannelAttention, (16,), [_map(2, 8, 8, 16)]),
    ("HGStem", JZ.HGStem, TZ.HGStem, (3, 16, 32), [_map(2, 17, 15, 3)]),
    ("HGBlock", JZ.HGBlock, TZ.HGBlock, (16, 8, 32, 3, 2), [_map(2, 8, 8, 16)]),
    ("HGBlock-light", JZ.HGBlock, TZ.HGBlock, (32, 8, 32, 5, 2, True, True), [_map(2, 8, 8, 32)]),
    ("ResNetLayer-first", JZ.ResNetLayer, TZ.ResNetLayer, (3, 16, 1, True, 1), [_map(2, 16, 16, 3)]),
    ("ResNetLayer", JZ.ResNetLayer, TZ.ResNetLayer, (32, 8, 2, False, 2), [_map(2, 8, 8, 32)]),
    ("CBLinear", JZ.CBLinear, TZ.CBLinear, (16, [8, 16], 3), [_map(2, 8, 8, 16)]),
    ("CBFuse", JZ.CBFuse, TZ.CBFuse, ([1, 0],), [[[_map(2, 4, 4, 8), _map(2, 4, 4, 16)],
                                                  [_map(2, 2, 2, 16), _map(2, 2, 2, 8)], _map(2, 8, 8, 16)]]),
    ("AIFI", JT.AIFI, TT.AIFI, (32, 64, 4), [_map(2, 4, 6, 32)]),
    ("TransformerBlock", JT.TransformerBlock, TT.TransformerBlock, (16, 32, 4, 2), [_map(2, 4, 4, 16)]),
    ("Proto", JZ.Proto, TZ.Proto, (16, 32, 8), [_map(2, 6, 5, 16)]),
    ("Conv2", JZ.Conv2, TZ.Conv2, (16, 32, 3, 1), [_map(2, 8, 8, 16)]),
    ("Conv2-s2", JZ.Conv2, TZ.Conv2, (16, 32, 3, 2), [_map(2, 8, 8, 16)]),
    ("DWConvTranspose2d", JZ.DWConvTranspose2d, TZ.DWConvTranspose2d, (16, 8, 2, 2), [_map(2, 5, 6, 16)]),
    ("DWConvTranspose2d-p1", JZ.DWConvTranspose2d, TZ.DWConvTranspose2d, (16, 16, 4, 2, 1), [_map(2, 5, 6, 16)]),
    # the YOLO-World blocks, with their guide or text inputs
    ("MaxSigmoidAttnBlock", JZ.MaxSigmoidAttnBlock, TZ.MaxSigmoidAttnBlock, (16, 32, 2, 32, 24, True),
     [[_map(2, 8, 8, 16), _tokens(2, 5, 24)]]),
    ("MaxSigmoidAttnBlock-noec", JZ.MaxSigmoidAttnBlock, TZ.MaxSigmoidAttnBlock, (32, 32, 4, 32, 24),
     [[_map(2, 8, 8, 32), _tokens(2, 5, 24)]]),
    ("C2fAttn", JZ.C2fAttn, TZ.C2fAttn, (16, 32, 2, 16, 2, 24), [[_map(2, 8, 8, 16), _tokens(2, 5, 24)]]),
    ("ImagePoolingAttn", JZ.ImagePoolingAttn, TZ.ImagePoolingAttn, (16, (8, 12), 24, 4, 3, True),
     [[_map(2, 10, 10, 8), _map(2, 5, 5, 12), _tokens(2, 7, 24)]]),
    ("ContrastiveHead", JZ.ContrastiveHead, TZ.ContrastiveHead, (), [[_map(2, 8, 8, 16), _tokens(2, 6, 16)]]),
    ("BNContrastiveHead", JZ.BNContrastiveHead, TZ.BNContrastiveHead, (16,), [[_map(2, 8, 8, 16), _tokens(2, 6, 16)]]),
    # blocks the registry does not name, used inside others or by RT-DETR style heads
    ("MaxPool-ceil", JZ.MaxPool, TZ.MaxPool, (3, 2, 0, True), [_map(2, 8, 9, 16)]),
    ("LayerNorm2d", JT.LayerNorm2d, TT.LayerNorm2d, (16,), [_map(2, 4, 4, 16)]),
    ("TransformerEncoderLayer-prenorm", JT.TransformerEncoderLayer, TT.TransformerEncoderLayer,
     (16, 32, 4, 0.0, "relu", True), [_tokens(2, 6, 16)]),
    ("MLPBlock", JT.MLPBlock, TT.MLPBlock, (16, 32), [_tokens(2, 6, 16)]),
    ("MLP", JT.MLP, TT.MLP, (16, 32, 8, 3, True), [_tokens(2, 6, 16)]),
]


def _inputs(spec, rng):
    """(JAX input, port input) from a nested input spec: lists stay lists, one spec alone is the input itself."""
    def one(s):
        if isinstance(s, list):
            pairs = [one(x) for x in s]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        kind, shape = s
        x = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(x)
        return jnp.asarray(x), (t.permute(0, 3, 1, 2) if kind == "map" else t)

    return one(spec[0])


def _port_out(y):
    """The port's output in the JAX layout (NCHW maps to NHWC), lists flattened."""
    if isinstance(y, (list, tuple)):
        return [a for v in y for a in _port_out(v)]
    y = y.detach()
    return [(y.permute(0, 2, 3, 1) if y.ndim == 4 else y).numpy()]


def _jax_out(y):
    return [np.asarray(a) for a in y] if isinstance(y, (list, tuple)) else [np.asarray(y)]


def _apply_updates(state, updates):
    """The JAX state with ctx.updates (path -> {'mean', 'var'}) merged in."""
    state = jax.tree.map(lambda a: a, state)
    for path, upd in updates.items():
        node = state
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = dict(upd)
    return state


@pytest.mark.parametrize("mode", ["eval", "train", "fused"])
@pytest.mark.parametrize("label,jcls,tcls,args,inp", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(label, jcls, tcls, args, inp, mode):
    jmod = jcls(*args)
    p, s = jmod.init(JM.KeyGen(3))
    tmod = tcls(*args)
    TM.init_weights_(tmod, np.random.default_rng(3))
    init_sd = state_dict_from_jax(_np_tree(p), _np_tree(s), prefix="")
    got_sd = {k: v for k, v in tmod.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got_sd) == {k for k in init_sd if not k.endswith("num_batches_tracked")}
    for k, v in got_sd.items():  # the port's init draws the JAX init bit for bit
        assert torch.equal(v, init_sd[k]), k

    p, s = _perturb(p, s, 4)
    if mode == "fused":
        p, s = fuse_tree(p, s)
        TM.fuse_(tmod)
    tmod.load_state_dict(state_dict_from_jax(_np_tree(p), _np_tree(s), prefix=""), strict=True)
    xj, xt = _inputs(inp, np.random.default_rng(5))
    ctx = JM.Ctx(train=mode == "train")
    want = _jax_out(jmod(p, s, xj, ctx))
    tmod.train(mode == "train")
    with torch.no_grad():
        got = _port_out(tmod(xt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=label)
    if mode == "train":
        want_state = _np_tree(_apply_updates(s, ctx.updates))
        got_state = jax_trees(tmod, prefix="")[1]
        wl, gl = jax.tree_util.tree_leaves_with_path(want_state), jax.tree.leaves(got_state)
        assert len(wl) == len(gl) == 2 * len(ctx.updates)
        for (path, w), g in zip(wl, gl):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{label} {jax.tree_util.keystr(path)}")


def test_checkpoint_layouts_round_trip():
    """jax_trees of a port block gives back the JAX trees it was loaded from: transposed convs (4- and 5-dim
    'wt'), Linear and LayerNorm, the packed attention, BN nodes beside a block's own 'scale' and 'bias'."""
    cases = ((JZ.Proto, TZ.Proto, (16, 32, 8)), (JZ.DWConvTranspose2d, TZ.DWConvTranspose2d, (16, 8, 2, 2)),
             (JT.AIFI, TT.AIFI, (32, 64, 4)), (JZ.ImagePoolingAttn, TZ.ImagePoolingAttn, (16, (8, 12), 24, 4, 3, True)),
             (JZ.MaxSigmoidAttnBlock, TZ.MaxSigmoidAttnBlock, (16, 32, 2, 32, 24, True)),
             (JZ.BNContrastiveHead, TZ.BNContrastiveHead, (16,)))
    for jcls, tcls, args in cases:
        p, s = _perturb(*jcls(*args).init(JM.KeyGen(7)), 8)
        p, s = _np_tree(p), _np_tree(s)
        tmod = tcls(*args)
        tmod.load_state_dict(state_dict_from_jax(p, s, prefix=""), strict=True)
        gp, gs = jax_trees(tmod, prefix="")
        for got, want in ((gp, p), (gs, s)):
            gl, wl = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
            assert [k for k, _ in gl] == [k for k, _ in wl], jcls.__name__
            for (k, g), (_, w) in zip(gl, wl):
                np.testing.assert_array_equal(g, w, err_msg=f"{jcls.__name__} {jax.tree_util.keystr(k)}")


# ---- the registry: every JAX name builds here, inside a small spec ----

_HEAD = [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]]]
_ROWS = {  # spec rows after two stride-2 Convs (16 and 32 channels); three stride-2 Convs and Detect follow
    "Focus": [[-1, 1, "Focus", [32, 3]]],
    "GhostConv": [[-1, 1, "GhostConv", [32, 3, 1]]],
    "GhostBottleneck": [[-1, 2, "GhostBottleneck", [32, 3, 2]]],
    "ConvTranspose": [[-1, 1, "ConvTranspose", [32, 2, 2]]],
    "RepConv": [[-1, 1, "RepConv", [32, 3, 1]]],
    "LightConv": [[-1, 1, "LightConv", [32, 3]]],
    "SPP": [[-1, 1, "SPP", [32]]],
    "SPPELAN": [[-1, 1, "SPPELAN", [32, 16]]],
    "RepNCSPELAN4": [[-1, 1, "RepNCSPELAN4", [32, 32, 16, 2]]],
    "ELAN1": [[-1, 1, "ELAN1", [32, 32, 16]]],
    "AConv": [[-1, 1, "AConv", [32]]],
    "ADown": [[-1, 1, "ADown", [32]]],
    "SCDown": [[-1, 1, "SCDown", [32, 3, 2]]],
    "PSA": [[-1, 1, "PSA", [32]]],
    "C1": [[-1, 2, "C1", [32]]],
    "C2": [[-1, 2, "C2", [32]]],
    "C3x": [[-1, 2, "C3x", [32]]],
    "C3Ghost": [[-1, 2, "C3Ghost", [32]]],
    "C3TR": [[-1, 2, "C3TR", [32]]],
    "RepC3": [[-1, 2, "RepC3", [32]]],
    "RepCSP": [[-1, 2, "RepCSP", [32]]],
    "BottleneckCSP": [[-1, 2, "BottleneckCSP", [32]]],
    "C2fCIB": [[-1, 2, "C2fCIB", [32, True, True]]],
    "C2fPSA": [[-1, 2, "C2fPSA", [32]]],
    "C3f": [[-1, 2, "C3f", [32]]],
    "CIB": [[-1, 2, "CIB", [32]]],
    "RepVGGDW": [[-1, 1, "RepVGGDW", []]],
    "CBAM": [[-1, 1, "CBAM", [7]]],
    "ChannelAttention": [[-1, 1, "ChannelAttention", []]],
    "HGStem": [[-1, 1, "HGStem", [16, 32]]],
    "HGBlock": [[-1, 2, "HGBlock", [16, 32, 3, True, True]]],
    "ResNetLayer": [[-1, 1, "ResNetLayer", [32, 8, 1, False, 2]]],
    "CBLinear": [[-1, 1, "CBLinear", [[16, 32]]], [1, 1, "Conv", [32, 3, 1]], [[2, -1], 1, "CBFuse", [[1]]]],
    "AIFI": [[-1, 1, "AIFI", [64, 4]]],
    "TransformerBlock": [[-1, 1, "TransformerBlock", [32, 4, 1]]],
    "Proto": [[-1, 1, "Proto", [32, 16]]],
    "Conv2": [[-1, 1, "Conv2", [32, 3, 2]]],
    "DWConvTranspose2d": [[-1, 1, "DWConvTranspose2d", [32, 2, 2]]],
    "MaxSigmoidAttnBlock": [[[-1, 0], 1, "MaxSigmoidAttnBlock", [32, 2, 32, 16]]],
    "C2fAttn": [[[-1, 0], 2, "C2fAttn", [32, 16, 2, 24]]],
    "ImagePoolingAttn": [[[0, 1], 1, "ImagePoolingAttn", [32]], [1, 1, "Conv", [32, 3, 1]]],
    "ContrastiveHead": [[[-1, 0], 1, "ContrastiveHead", []]],
    "BNContrastiveHead": [[[-1, 0], 1, "BNContrastiveHead", []]],
}
_ROWS["CBFuse"] = _ROWS["CBLinear"]
ZOO = sorted(set(JAX_REGISTRY) - set(YOLO11_REGISTRY))


def test_registry_matches_jax():
    assert set(REGISTRY) == set(JAX_REGISTRY) and set(ZOO) == set(_ROWS)
    assert {k: v[1] for k, v in REGISTRY.items()} == {k: v[1] for k, v in JAX_REGISTRY.items()}
    assert [c.__name__ for c, _ in REGISTRY.values()] == [c.__name__ for c, _ in JAX_REGISTRY.values()]


@pytest.mark.parametrize("name", ZOO)
def test_registry_block_builds_as_in_jax(name):
    """A spec holding the block builds in both packages: the same init(0) weights, Detect strides and save list."""
    rows = _ROWS[name]
    n = 2 + len(rows) + len(_HEAD)
    spec = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]], *rows, *_HEAD],
            "head": [[[n - 3, n - 2, n - 1], 1, "Detect", ["nc"]]]}
    jm = JaxModel(spec)
    p, s = jm.init(0)
    tm = DetectionModel(spec).init(0)
    assert tm.strides == jm.strides and tm.save == jm.save
    assert [m.name for m in tm.model] == [r.name for r in jm.rows]
    want = state_dict_from_jax(_np_tree(p), _np_tree(s))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert tm.num_params() == jm.num_params(p)
