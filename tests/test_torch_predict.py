"""yololite_tpu_torch predict vs the JAX package, end to end, on the CPU.

Both facades hold the same weights (JAX init(0) with perturbed BN statistics,
carried over by `state_dict_from_jax`) and predict the same numpy sources at
imgsz 160 with conf 1e-7, where random weights still give detections. Counts
and classes must be equal. Detections are matched as sets (same class, box
within 0.05 px, score within rtol 1e-3), not row by row, because the two
frameworks' convolutions and sigmoids round differently, so near-equal scores
may trade rows.

Random weights make this comparison fragile: the class prior puts every
logit near -11.5 with a spread of a few ulps, so hundreds of candidates tie
exactly, all boxes overlap, and one candidate that changes rank (a 1-ulp
logit difference) changes the greedy cascade after it. On identical Detect
maps the two NMS paths agree exactly (tests/test_torch_nms.py); here the seeds
and the class filter are chosen so that no such rank change happens (the
filter [1, 5, 7, 40], for one, has one).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu import YOLOLite as JaxYOLOLite
from yololite_tpu.ops.letterbox import LetterBox as JaxLetterBox, scale_img as jax_scale_img
from yololite_tpu.ops.pallas_kernels import device_letterbox as jax_device_letterbox

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.models.checkpoint import state_dict_from_jax
from yololite_tpu_torch.ops.kernels import device_letterbox
from yololite_tpu_torch.ops.letterbox import scale_img

REPO = Path(__file__).resolve().parents[1]


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


def _pad_rows_cols(shape, imgsz):
    h0, w0 = shape
    r = min(imgsz / h0, imgsz / w0)
    new_w, new_h = int(round(w0 * r)), int(round(h0 * r))
    return int(round((imgsz - new_h) / 2 - 0.1)), int(round((imgsz - new_w) / 2 - 0.1)), new_h, new_w


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (417, 333)])
def test_device_letterbox_matches_jax_and_cv2(shape):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, *shape, 3), np.uint8)
    got = device_letterbox(torch.from_numpy(imgs), imgsz=320).numpy()
    want = np.asarray(jax_device_letterbox(jnp.asarray(imgs), imgsz=320))
    assert got.shape == want.shape == (2, 320, 320, 3)
    top, left, new_h, new_w = _pad_rows_cols(shape, 320)
    pad = np.ones((320, 320), bool)
    pad[top:top + new_h, left:left + new_w] = False
    np.testing.assert_array_equal(got[:, pad], want[:, pad])  # the 114 fill, exactly
    np.testing.assert_allclose(got[:, pad], 114 / 255, rtol=1e-7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # two fp32 matmuls, summed in another order
    host = JaxLetterBox((320, 320))(imgs[0]).astype(np.float32) / 255.0  # cv2 INTER_LINEAR
    assert np.abs(got[0] - host).max() < 2.0 / 255.0
    assert device_letterbox(torch.from_numpy(imgs), 320, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("ratio", [0.83, 0.67])
def test_scale_img_matches_jax(ratio):
    x = np.random.default_rng(2).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    got = scale_img(torch.from_numpy(x), ratio).numpy()
    want = np.asarray(jax_scale_img(jnp.asarray(x), ratio))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port facade with the same weights: JAX init(0), BN stats perturbed."""
    jm = JaxYOLOLite("yolo11n.yaml")
    rng = np.random.default_rng(3)
    jm.state = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + rng.uniform(0.0, 0.2, x.shape), jnp.float32), jm.state)
    tm = YOLOLite("yolo11n.yaml", device="cpu")
    tm.model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params),
                                                 jax.tree.map(np.asarray, jm.state)), strict=True)
    return jm, tm


def _match_sets(a, b, box_tol=0.05, score_rtol=1e-3):
    """Rows of a with an unused partner in b: same class, box within box_tol px, score within score_rtol."""
    used = np.zeros(len(b), bool)
    n = 0
    for row in a:
        ok = (b[:, 5] == row[5]) & ~used & (np.abs(b[:, :4] - row[:4]).max(1) < box_tol) & (
            np.abs(b[:, 4] - row[4]) <= score_rtol * abs(row[4]))
        hit = np.flatnonzero(ok)
        if len(hit):
            used[hit[0]] = True
            n += 1
    return n


def _sources():
    rng = np.random.default_rng(4)
    same = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(3)]  # device letterbox, padded to 4
    mixed = [rng.integers(0, 256, (120, 160, 3), np.uint8), rng.integers(0, 256, (100, 90, 3), np.uint8)]
    return {"same-shape": (same, {}), "mixed-shape": (mixed, {}),
            "classes-agnostic": (same, {"classes": [0, 2, 3], "agnostic_nms": True, "iou": 0.5}),
            "tta": (same, {"augment": True})}


@pytest.mark.parametrize("source", list(_sources()))
def test_predict_matches_jax(pair, source):
    jm, tm = pair
    src, extra = _sources()[source]
    kw = dict(conf=1e-7, imgsz=160, batch=4, save=False, verbose=False, **extra)
    want = jm.predict(src, **kw)
    got = tm.predict(src, **kw)
    assert len(got) == len(want) == len(src)
    for g, w, im in zip(got, want, src):
        gd, wd = g.boxes.data, w.boxes.data
        assert g.orig_shape == w.orig_shape == im.shape[:2]
        assert len(gd) == len(wd) > 0
        np.testing.assert_array_equal(np.sort(gd[:, 5]), np.sort(wd[:, 5]))
        assert _match_sets(wd, gd) == len(wd)
        if "classes" in extra:
            assert set(gd[:, 5].astype(int)) <= set(extra["classes"])


def test_predict_bf16_detect_maps_match_jax(pair):
    """bf16 predict's Detect maps, port against JAX's bf16 on the same fused weights: cosine >= 0.9995 per level.

    The two frameworks round bf16 at other places, so the maps are not equal and detections near a tie may
    differ (ROADMAP Queue 3 measured cosine 0.99990-0.99991, as close as JAX's own bf16 is to its fp32).
    """
    from yololite_tpu.models.modules import fuse_tree

    from yololite_tpu_torch.engine.predictor import forward_nhwc, inference_net

    jm, tm = pair
    x = np.random.default_rng(6).random((2, 160, 160, 3)).astype(np.float32)
    params, state = fuse_tree(jm.params, jm.state)
    cast = lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)
    want = jax.jit(lambda p, s, x: jm.model.apply(p, s, x, train=False))(cast(params), cast(state),
                                                                       jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = forward_nhwc(inference_net(tm.model, torch.device("cpu"), half=True),
                           torch.from_numpy(x).to(torch.bfloat16))
    coss = []
    for g, w in zip(got, want):
        a, b = g.float().numpy().ravel(), np.asarray(w, np.float32).ravel()
        assert g.dtype == torch.bfloat16 and a.shape == b.shape
        coss.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    print(f"bf16 Detect maps vs JAX bf16, cosine per level: {coss}")
    assert min(coss) >= 0.9995, coss


def test_predict_tta_and_half_run(pair):
    """TTA (augment) and the bf16 path on the CPU: finite detections inside the frame."""
    _, tm = pair
    src = _sources()["same-shape"][0][:2]
    for kw in ({"augment": True}, {"half": True}):
        res = tm.predict(src, conf=1e-7, imgsz=160, batch=2, save=False, verbose=False, **kw)
        for r in res:
            d = r.boxes.data
            assert len(d) > 0 and np.isfinite(d).all()
            assert (d[:, [0, 2]] <= 160).all() and (d[:, [1, 3]] <= 120).all() and (d[:, :4] >= 0).all()


def test_predict_tensor_source_and_results(pair):
    _, tm = pair
    x = np.random.default_rng(5).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    res = tm.predict(x, conf=1e-7, imgsz=160, batch=2, save=False, verbose=False)
    assert [r.orig_shape for r in res] == [(96, 128), (96, 128)]
    r = res[0]
    assert r.boxes.xyxy.shape == (len(r), 4) and r.boxes.conf.shape == (len(r),)
    assert len(r.summary()) == len(r) and r.verbose().endswith(", ")


def test_predict_path_imports_no_jax_cv2_or_yaml():
    """The port predicts a uint8 batch with jax, yololite_tpu, cv2, yaml, PIL and matplotlib unimported."""
    code = (
        "import sys, numpy as np\n"
        "from yololite_tpu_torch import YOLOLite\n"
        "m = YOLOLite('yolo11n.yaml', device='cpu')\n"
        "r = m.predict(np.zeros((2, 64, 96, 3), np.uint8), conf=1e-7, imgsz=64, batch=2, save=False, verbose=False)\n"
        "assert len(r) == 2 and len(r[0]) > 0\n"
        "bad = ('jax', 'jaxlib', 'yololite_tpu', 'cv2', 'yaml', 'PIL', 'matplotlib')\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YOLOLite("yolo11n.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YOLOLite("yolo11n.yaml", device="cuda")
