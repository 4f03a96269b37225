"""int8 serving in yololite_tpu_torch vs the JAX package, on the CPU.

On the CPU the port's quantized convs run K8's plain version (a float64
convolution of the int8 values, then the fp32/bf16 epilogue), the function
the card's kernel is held to bit for bit. Held here against the JAX
package's quantized path on the same weights:
- `quantize_model`: the same quantized paths and the same convs writing
  int8 (`sout`), int8 weights equal, `sw` within rtol 1e-6, and `s_act`
  within rtol 2e-2 (it comes from a bf16 forward, which the two frameworks
  round differently);
- each quantized conv of a JAX quantized tree carried across, on equal int8
  inputs: int8 outputs within 1 LSB (one bf16 ulp of the SiLU can move a
  requantized value by one), bf16 outputs within 2 bf16 ulps (XLA computes
  a bf16 SiLU as x * sigmoid(x) with the sigmoid rounded to bf16 first,
  torch as x / (1 + exp(-x)) rounded once: 1 ulp apart was measured, and
  the two roundings bound it by 2);
- the whole int8 forward on that tree: Detect maps at cosine >= 0.999 (the
  measured values print with -s; differences compound through the int8
  edges).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.models import modules as JM
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.models.quant import quantize_model as jax_quantize_model

from yololite_tpu_torch.engine.predictor import DetectionPredictor, forward_nhwc, inference_net
from yololite_tpu_torch.models import modules as M
from yololite_tpu_torch.models.checkpoint import load_jax_trees, quantized_from_jax
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.models.quant import conv_paths, quantize_model, quantized_paths
from yololite_tpu_torch.ops import kernels as K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module holds the port against JAX (see tests/test_torch_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """JAX yolo11n init(0) with BN statistics perturbed, the port's model on the same weights, and a JAX
    quantized tree calibrated on one random batch at 96."""
    jm = JaxModel("yolo11n.yaml")
    params, state = jm.init(0)
    rng = np.random.default_rng(3)
    state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + rng.uniform(0.0, 0.2, x.shape), jnp.float32), state)
    tm = load_jax_trees(DetectionModel("yolo11n.yaml"), jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, state))
    calib = [np.random.default_rng(0).random((2, 96, 96, 3), np.float32)]
    qp, qs, scales = jax_quantize_model(jm, params, state, calib)
    return jm, params, state, tm, calib, (qp, qs, scales)


def _jax_quantized_paths(tree, path=(), out=None):
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            if k == "q":
                out[path] = "sout" in v
            else:
                _jax_quantized_paths(v, path + (k,), out)
    return out


def _jax_node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits), normal range."""
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 2.0 ** -126))) - 7)


def _jax_module(jm, path):
    mod = jm.rows[int(path[0])].mod
    for p in path[1:]:
        mod = mod.sub[p] if hasattr(mod, "sub") and p in mod.sub else mod.mods[int(p)]
    return mod


def test_quantize_model_matches_jax(pair):
    jm, params, state, tm, calib, (qp, qs, scales) = pair
    qnet, got = quantize_model(tm, calib)
    assert got["s_act"] == pytest.approx(scales["s_act"], rel=2e-2)
    want_paths = _jax_quantized_paths(qp)
    assert quantized_paths(qnet) == want_paths
    assert len(want_paths) == 76 and sum(want_paths.values()) == 66  # yolo11n: 10 convs write bf16
    assert "q" not in qp["10"]["m"]["0"]["attn"]["qkv"] and qp["0"]["q"]["w"].dtype == jnp.int8
    for path, mod in conv_paths(qnet):
        if path not in want_paths:
            continue
        q = _jax_node(qp, path)["q"]
        np.testing.assert_array_equal(mod.conv.weight.numpy(), np.asarray(q["w"]).transpose(3, 0, 1, 2),
                                      err_msg=str(path))
        np.testing.assert_allclose(mod.conv.sw.numpy(), np.asarray(q["sw"]), rtol=1e-6, err_msg=str(path))
        np.testing.assert_allclose(mod.conv.bias.numpy(), np.asarray(_jax_node(qp, path)["conv"]["b"]), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    # the float modules are bf16, the quantized convs' scales fp32
    assert qnet.model[10].m[0].attn.qkv.conv.weight.dtype == torch.bfloat16
    assert qnet.model[0].conv.scale.dtype == torch.float32 and qnet.model[0].conv.weight.dtype == torch.int8


def test_int8_convs_match_jax(pair):
    """Every quantized conv of the JAX tree carried across, on equal random int8 inputs (and the stem on floats)."""
    jm, params, state, tm, calib, (qp, qs, scales) = pair
    qnet = quantized_from_jax(tm, jax.tree.map(np.asarray, qp))
    assert quantized_paths(qnet) == _jax_quantized_paths(qp)
    rng = np.random.default_rng(8)
    stats = {"int8": [0.0, 0, 0], "bf16": [0.0, 0, 0]}  # worst, outputs that differ, outputs
    for path, mod in conv_paths(qnet):
        node = _jax_node(qp, path)
        if "q" not in node:
            continue
        cin = node["q"]["w"].shape[2] * mod.conv.groups
        x = rng.integers(-127, 128, (2, 9, 7, cin)).astype(np.int8)
        want = np.asarray(_jax_module(jm, path)(node, {}, jnp.asarray(x), JM.Ctx(train=False)).astype(jnp.float32))
        with torch.no_grad():
            got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
        if mod.conv.sout is not None:
            err = float(np.abs(got - want).max())
            assert err <= 1, (path, err)
        else:
            err = float((np.abs(got - want) / _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).max())
            assert err <= 2, (path, err)
        st = stats["int8" if mod.conv.sout is not None else "bf16"]
        st[0] = max(st[0], err)
        st[1] += int((got != want).sum())
        st[2] += got.size
    print("int8 convs vs JAX: " + "; ".join(f"{k} outputs: worst {v[0]} {'LSB' if k == 'int8' else 'ulp'}, "
                                             f"{v[1]} of {v[2]} differ" for k, v in stats.items()))
    # the stem quantizes its float input on the fly
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    want = np.asarray(_jax_module(jm, ("0",))(_jax_node(qp, ("0",)), {}, jnp.asarray(x), JM.Ctx()), np.int32)
    with torch.no_grad():
        got = qnet.model[0](torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).int().numpy()
    assert np.abs(got - want).max() <= 1


def test_int8_forward_matches_jax(pair):
    """The whole int8 forward of the carried-across tree against JAX's: Detect maps at cosine >= 0.999."""
    jm, params, state, tm, calib, (qp, qs, scales) = pair
    qnet = quantized_from_jax(tm, jax.tree.map(np.asarray, qp))
    x = np.random.default_rng(9).random((1, 96, 96, 3)).astype(np.float32)
    want = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(qp, qs, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = forward_nhwc(qnet, torch.from_numpy(x).to(torch.bfloat16))
    coss = []
    for g, w in zip(got, want):
        a, b = g.float().numpy().ravel(), np.asarray(w, np.float32).ravel()
        assert g.dtype == torch.bfloat16 and a.shape == b.shape
        coss.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    print(f"int8 forward vs JAX, Detect maps cosine per level: {coss}")
    assert min(coss) >= 0.999, coss


def test_quantized_forward_close_to_bf16(pair):
    """Mirror of JAX's test_quantized_forward_close_to_bf16: the int8 forward against the bf16 one, cos > 0.99."""
    _, _, _, tm, _, _ = pair
    rng = np.random.default_rng(0)
    qnet, scales = quantize_model(tm, [rng.random((2, 160, 160, 3), np.float32)])
    assert scales["s_act"] > 0
    x = torch.from_numpy(rng.random((1, 160, 160, 3)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        feats_bf = forward_nhwc(inference_net(tm, torch.device("cpu"), half=True), x)
        before = K.int8_conv.launches
        feats_q = forward_nhwc(qnet, x)
    assert K.int8_conv.launches == before  # the CPU runs the plain version; only the card's kernel counts
    for a, b in zip(feats_bf, feats_q):
        a, b = a.float().numpy().ravel(), b.float().numpy().ravel()
        assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)) > 0.99


def test_int8_edges_stay_int8(pair):
    """Between quantized convs the edges are int8: SPPF's pools, the Upsamples and the Concats see int8."""
    _, _, _, tm, calib, _ = pair
    qnet, _ = quantize_model(tm, calib)
    seen = {}
    hooks = [m.register_forward_hook(lambda mod, i, y, n=n: seen.__setitem__(n, (i[0].dtype if torch.is_tensor(i[0])
                                                                                 else i[0][0].dtype, y.dtype)))
             for n, m in qnet.named_modules() if isinstance(m, (M.SPPF, M.Upsample, M.Concat, M.Bottleneck))]
    with torch.no_grad():
        forward_nhwc(qnet, torch.from_numpy(calib[0][:1]))
    for h in hooks:
        h.remove()
    assert len(seen) > 10 and all(v == (torch.int8, torch.int8) for v in seen.values()), seen
    # the int8 max-pool and upsample against their float counterparts on the same integers
    x = torch.randint(-127, 128, (2, 8, 9, 7), dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    sppf = M.SPPF(8, 8)
    want = torch.nn.functional.max_pool2d(x.float(), 5, 1, 2)
    assert torch.equal(sppf._pool(x).float(), want)
    up = M.Upsample(None, 2)
    assert torch.equal(up(x).float(), up(x.float()))


def test_predictor_int8_tensor_source_calibrates(pair, tmp_path):
    """Mirror of JAX's test: int8=True with an NHWC tensor source calibrates on that batch and detects; uint8
    frames calibrate on their host letterbox."""
    tm = pair[3]
    batch = np.random.default_rng(7).random((2, 160, 160, 3)).astype(np.float32)
    kw = dict(imgsz=160, batch=2, conf=1e-6, save=False, verbose=False, project=str(tmp_path), int8=True)
    pred = DetectionPredictor(overrides=dict(kw), device="cpu")
    pred.setup_model(tm, half=False)
    results = pred(batch)
    assert pred._quantized and any(isinstance(m, M.QConv) for m in pred.net.modules())
    assert len(results) == 2 and all(len(r) > 0 for r in results)
    frames = [np.random.default_rng(i).integers(0, 255, (120, 160, 3), np.uint8) for i in range(2)]
    pred2 = DetectionPredictor(overrides=dict(kw), device="cpu")
    pred2.setup_model(tm)
    res2 = pred2(frames)
    assert pred2._quantized and len(res2) == 2 and all(np.isfinite(r.boxes.data).all() for r in res2)
