"""yololite_tpu_torch model vs the JAX package: cfg copies, init, weight bridge, forward.

The same numpy-seeded weights go into both packages through
`state_dict_from_jax`; forwards are compared in fp32 at small sizes with the
tolerance of tests/test_model_parity.py (rtol 1e-4, atol 2e-4: the two
frameworks sum the convolutions in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.models import modules as JM
from yololite_tpu.models.model import DetectionModel as JaxModel
from yololite_tpu.models.modules import fuse_tree

from yololite_tpu_torch.models import modules as TM
from yololite_tpu_torch.models.checkpoint import state_dict_from_jax
from yololite_tpu_torch.models.model import DetectionModel

RTOL, ATOL = 1e-4, 2e-4
EXPECTED_TRAINABLE = {"n": 2624064, "s": 9458736}  # tests/test_model_parity.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one CPU thread while this module holds it against JAX.

    In a process that has run XLA, a torch worker thread's first parallel
    chunk of torch.exp was seen to come out with up to 1.5e-4 relative error
    (one chunk of eight, first call only; later calls exact), enough to move
    boxes and scores past the tolerances here. One thread has no such chunk.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _perturb_state(state, seed):
    """Running stats away from (0, 1), so the BN fold is exercised."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        is_var = getattr(path[-1], "key", None) == "var"
        noise = rng.uniform(0.5, 1.5, x.shape) if is_var else rng.uniform(-0.2, 0.2, x.shape)
        return jnp.asarray(np.asarray(x) * noise if is_var else np.asarray(x) + noise, jnp.float32)

    return jax.tree_util.tree_map_with_path(f, state)


@pytest.mark.parametrize("name", ["default.yaml", "yolo11.yaml"])
def test_cfg_dicts_equal_their_yaml(name):
    import yaml

    from yololite_tpu_torch.cfg.dicts import DEFAULT_YAML, YOLO11_YAML
    from yololite_tpu_torch.utils import ROOT

    with open(ROOT / "cfg" / name) as f:
        loaded = yaml.safe_load(f)
    assert {"default.yaml": DEFAULT_YAML, "yolo11.yaml": YOLO11_YAML}[name] == loaded
    with open(ROOT.parent / "yololite_tpu" / "cfg" / name) as f:  # and the copy equals the JAX package's file
        assert yaml.safe_load(f) == loaded


@pytest.mark.parametrize("scale", ["n", "s"])
def test_param_counts_and_strides(scale):
    m = DetectionModel(f"yolo11{scale}.yaml")
    assert m.num_params() == EXPECTED_TRAINABLE[scale]
    assert m.strides == [8, 16, 32]


def test_init_matches_jax_init():
    """Port init(0) draws the same weights as JAX init(0), leaf for leaf, bit for bit."""
    jm = JaxModel("yolo11n.yaml")
    p, s = jm.init(0)
    want = state_dict_from_jax(_np_tree(p), _np_tree(s))
    got = DetectionModel("yolo11n.yaml").init(0).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# (constructor name, args, NHWC input shape)
BLOCKS = [
    ("Conv", (8, 16, 3, 2), (2, 16, 16, 8)),
    ("DWConv", (16, 16, 3), (2, 8, 8, 16)),
    ("Bottleneck", (16, 16), (2, 8, 8, 16)),
    ("C3k2", (16, 32, 1, False, 0.25), (2, 8, 8, 16)),
    ("C3k2", (16, 32, 2, True), (2, 8, 8, 16)),
    ("SPPF", (32, 32, 5), (2, 8, 8, 32)),
    ("C2PSA", (256, 256, 1), (1, 4, 4, 256)),  # two heads
    ("C2PSA", (64, 64, 2), (2, 4, 6, 64)),
]


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
@pytest.mark.parametrize("name,args,shape", BLOCKS, ids=[f"{b[0]}{b[1]}" for b in BLOCKS])
def test_block_forward_matches_jax(name, args, shape, fused):
    jmod = getattr(JM, name)(*args)
    p, s = jmod.init(JM.KeyGen(3))
    s = _perturb_state(s, 4)
    if fused:
        p, s = fuse_tree(p, s)
    tmod = getattr(TM, name)(*args).eval()
    if fused:
        TM.fuse_(tmod)
    tmod.load_state_dict(state_dict_from_jax(_np_tree(p), _np_tree(s), prefix=""), strict=True)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = np.asarray(jmod(p, s, jnp.asarray(x), JM.Ctx(train=False)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_model_forward_matches_jax(fused):
    """Whole yolo11n at 128x96 with perturbed BN stats, loaded with strict=True."""
    jm = JaxModel("yolo11n.yaml")
    p, s = jm.init(1)
    s = _perturb_state(s, 2)
    if fused:
        p, s = fuse_tree(p, s)
    tm = DetectionModel("yolo11n.yaml").eval()
    if fused:
        tm.fuse()
    tm.load_state_dict(state_dict_from_jax(_np_tree(p), _np_tree(s)), strict=True)
    x = np.random.default_rng(6).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    want = jm.apply(p, s, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_fuse_keeps_the_output():
    """Folding BN changes only rounding (atol 5e-5, as tests/test_model_parity.py for the JAX fold)."""
    m = DetectionModel("yolo11n.yaml").init(0).eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.05, 0.05, generator=torch.Generator().manual_seed(7))
        x = torch.rand(1, 3, 96, 96, generator=torch.Generator().manual_seed(8))
        y0 = m(x)
        y1 = m.fuse()(x)
    for a, b in zip(y0, y1):
        torch.testing.assert_close(b, a, rtol=0, atol=5e-5)


def test_end2end_head_matches_jax():
    """Detect(end2end=True): one2many and one2one maps, init order and names as the JAX head."""
    ch = (16, 32, 64)
    jd = JM.Detect(nc=3, ch=ch, end2end=True)
    p, s = jd.init(JM.KeyGen(9))
    p = jd.bias_init(p)
    td = TM.Detect(nc=3, ch=ch, end2end=True)
    TM.init_weights_(td, np.random.default_rng(9))
    td.bias_init()
    want_sd = state_dict_from_jax(_np_tree(p), _np_tree(s), prefix="")
    for k, v in td.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    rng = np.random.default_rng(10)
    xs = [rng.standard_normal((1, h, h, c)).astype(np.float32) for h, c in zip((8, 4, 2), ch)]
    want = jd(p, s, [jnp.asarray(x) for x in xs], JM.Ctx(train=False))
    with torch.no_grad():
        got = td.eval()([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    for key in ("one2many", "one2one"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_gflops_matches_jax():
    jm = JaxModel("yolo11n.yaml")
    p, s = jm.init(0)
    assert DetectionModel("yolo11n.yaml").gflops(640) == pytest.approx(jm.gflops(p, s, 640), rel=1e-9)


def test_unported_pieces_raise(tmp_path):
    """The extended block zoo builds (Focus among it) and predicts, but int8 serving of a zoo model raises, as
    the JAX package cannot run it; .pt loading, export and int8 serving of yolo11n run (76 quantized convs)."""
    from yololite_tpu_torch import YOLOLite
    from yololite_tpu_torch.models.quant import quantized_paths

    spec = {"nc": 2, "backbone": [[-1, 1, "Focus", [16, 3]]], "head": [[[0], 1, "Detect", ["nc"]]]}
    zoo = YOLOLite(spec, device="cpu")
    assert type(zoo.model.model[0]).__name__ == "Focus" and zoo.model.strides == [2]
    frame = [np.zeros((64, 64, 3), np.uint8)]
    assert len(zoo.predict(frame, imgsz=64, conf=1e-7, save=False, verbose=False)[0]) > 0
    with pytest.raises(NotImplementedError, match=r"row 0 \(Focus\).*JAX package"):
        zoo.predict(frame, int8=True, imgsz=64, conf=1e-7, save=False, verbose=False)
    m = YOLOLite("yolo11n.yaml", device="cpu")
    pt = tmp_path / "yolo11n.pt"
    torch.save({"model": m.model, "train_args": {"imgsz": 64}}, str(pt))
    loaded = YOLOLite(str(pt), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.model.state_dict().values(), loaded.model.state_dict().values()))
    path = m.export(tmp_path / "n.pt2", imgsz=64, batch=1, half=False)
    assert path.exists() and (tmp_path / "n.pt2.json").exists()
    res = m.predict([np.zeros((64, 64, 3), np.uint8)], int8=True, imgsz=64, conf=1e-7, save=False, verbose=False)
    assert len(res) == 1 and m.predictor._quantized and len(quantized_paths(m.predictor.net)) == 76


def test_no_jax_imports_in_the_port():
    """No module of the port, no line of chip_smoke.py and of its profiling tool imports jax or yololite_tpu."""
    import ast
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "yololite_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py",
                                                                   repo / "tools" / "torch_predict_profile.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "yololite_tpu"), f"{f}: imports {n}"
