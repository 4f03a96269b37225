"""The port's host helpers against the JAX package's, on the CPU (the counterparts of tests/test_utils.py).

Where a JAX helper gives an output, the port's must give the same: the same
image bytes for plot_images and the Annotator, the same arrays for
output_to_target, crops, coordinates and version parses, the same files for
the settings store. No probe touches the network: is_online is monkeypatched.
"""

import io
import logging
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from yololite_tpu.ops import boxes as jboxes
from yololite_tpu.utils import checks as jchecks, misc as jmisc, plotting as jplot

from yololite_tpu_torch.ops import boxes as tboxes
from yololite_tpu_torch.utils import LOGGER, checks as tchecks, misc as tmisc, plotting as tplot
from yololite_tpu_torch.utils import get_latest_run, yaml_load, yaml_print, yaml_save
from yololite_tpu_torch.utils.patches import imread, imshow, imwrite
from yololite_tpu_torch.utils.profile import Profile, trace_to


# ---------------- misc ----------------


def test_jsondict_and_settings_persist(tmp_path):
    d = tmisc.JSONDict(tmp_path / "d.json")
    d["alpha"] = 1
    d.update({"beta": [1, 2, 3]})
    d2 = tmisc.JSONDict(tmp_path / "d.json")
    assert d2 == {"alpha": 1, "beta": [1, 2, 3]}
    del d2["alpha"]
    assert "alpha" not in tmisc.JSONDict(tmp_path / "d.json")
    s = tmisc.SettingsManager(file=tmp_path / "s.json", version="9.9")
    js = jmisc.SettingsManager(file=tmp_path / "js.json", version="9.9")
    assert set(s) == set(js) and s["settings_version"] == "9.9"
    s["runs_dir"] = str(tmp_path / "runs")
    assert tmisc.SettingsManager(file=tmp_path / "s.json", version="9.9")["runs_dir"] == str(tmp_path / "runs")
    s.reset()
    assert s["runs_dir"] != str(tmp_path / "runs") and s["settings_version"] == "9.9"


def test_get_settings_is_lazy_and_cached(monkeypatch, tmp_path):
    monkeypatch.setattr(tmisc, "SETTINGS", None)
    monkeypatch.setattr(Path, "home", classmethod(lambda cls: tmp_path))
    s = tmisc.get_settings()
    assert s is tmisc.get_settings() and s.file_path == tmp_path / ".config" / "yololite_tpu_torch" / "settings.json"


def test_retry_tryexcept_and_threading_locked():
    calls = []

    @tmisc.retry(times=3, delay=0.01)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("boom")
        return "ok"

    assert flaky() == "ok" and len(calls) == 3

    @tmisc.TryExcept("ctx")
    def bad():
        raise RuntimeError("x")

    bad()
    state = {"inside": 0, "max": 0}

    @tmisc.ThreadingLocked()
    def work():
        state["inside"] += 1
        state["max"] = max(state["max"], state["inside"])
        time.sleep(0.01)
        state["inside"] -= 1

    threads = [threading.Thread(target=work) for _ in range(6)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert state["max"] == 1


@pytest.mark.parametrize("name,args", [
    ("url2file", ("https://x.com/a/weights.pt?token=abc",)),
    ("clean_url", ("https://x.com/a/file.txt?auth",)),
    ("remove_colorstr", ("\x1b[34m\x1b[1mhello\x1b[0m",)),
    ("emojis", ("plain",)),
    ("clean_str", ("a|b@c#d",)),
    ("is_colab", ()), ("is_kaggle", ()), ("is_jupyter", ()), ("is_docker", ()), ("is_ubuntu", ()),
    ("get_ubuntu_version", ()), ("is_raspberrypi", ()), ("is_jetson", ()), ("read_device_model", ()),
    ("is_github_action_running", ()), ("is_pytest_running", ()), ("is_git_dir", ()), ("get_git_dir", ()),
    ("get_git_branch", ()), ("get_git_origin_url", ()), ("get_cpu_info", ()), ("is_pip_package", ("numpy",)),
])
def test_misc_probe_matches_jax(name, args):
    assert getattr(tmisc, name)(*args) == getattr(jmisc, name)(*args)


def test_is_online_is_a_probe_that_tests_stub(monkeypatch):
    for m in (tmisc, jmisc):
        monkeypatch.setattr(m, "is_online", lambda: False)
    assert tmisc.is_online() is jmisc.is_online() is False


def test_host_helpers_match_jax(tmp_path):
    assert tmisc.is_dir_writeable(tmp_path) == jmisc.is_dir_writeable(tmp_path) is True
    assert tmisc.get_user_config_dir("x") == jmisc.get_user_config_dir("x")
    assert tmisc.get_user_config_dir().name == "yololite_tpu_torch"
    fn = lambda a, b=3, c="x": None
    assert tmisc.get_default_args(fn) == jmisc.get_default_args(fn) == {"b": 3, "c": "x"}
    assert tmisc.default_class_names() == jmisc.default_class_names()
    (tmp_path / "d.yaml").write_text("names: {0: a, 1: b}\n")
    assert tmisc.default_class_names(tmp_path / "d.yaml") == jmisc.default_class_names(tmp_path / "d.yaml")

    class A:
        pass

    class B:
        def __init__(self):
            self.x, self._h, self.y = 1, 2, 3

    a = A()
    tmisc.copy_attr(a, B(), exclude=("y",))
    assert a.x == 1 and not hasattr(a, "_h") and not hasattr(a, "y")
    done = []
    tmisc.threaded(lambda: done.append(1))().join(5)
    assert done == [1] and tmisc.threaded(lambda: 42)(threaded=False) == 42
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    LOGGER.addHandler(h)
    try:
        tmisc.deprecation_warn("old", "new")
    finally:
        LOGGER.removeHandler(h)
    assert "'old' is deprecated" in buf.getvalue()


def test_init_seeds_seeds_torch_numpy_and_random():
    import random

    tmisc.init_seeds(5)
    v = (random.random(), np.random.rand(), torch.rand(1).item())
    tmisc.init_seeds(5)
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == v
    jmisc.init_seeds(5)
    assert (random.random(), np.random.rand()) == v[:2]  # the host draws are the JAX package's
    tmisc.init_seeds(1, deterministic=True)
    try:
        assert torch.are_deterministic_algorithms_enabled() and torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
    finally:
        tmisc.init_seeds(0)
    assert not torch.are_deterministic_algorithms_enabled()


def test_inference_mode_time_sync_and_plt_settings():
    @tmisc.smart_inference_mode()
    def f(x):
        return x * 2, torch.is_inference_mode_enabled()

    y, inside = f(torch.ones(2, requires_grad=True))
    assert inside and not y.requires_grad
    assert tmisc.time_sync() > 0

    @tmisc.plt_settings({"font.size": 7})
    def size():
        import matplotlib.pyplot as plt

        return plt.rcParams["font.size"], plt.get_backend().lower()

    assert size() == (7, "agg")


def test_simpleclass_display():
    class Thing(tmisc.SimpleClass):
        """Thing docs."""

        def __init__(self):
            self.alpha, self._hidden = 1, 2

    t = Thing()
    assert "alpha: 1" in str(t) and "_hidden" not in str(t) and repr(t) == str(t)
    with pytest.raises(AttributeError, match="Thing docs."):
        t.nope


# ---------------- checks ----------------


def test_checks_match_jax(tmp_path):
    for imgsz, kw in ((640, dict(min_dim=1)), (600, dict(min_dim=2)), ([640, 480], {})):
        assert tchecks.check_imgsz(imgsz, stride=32, **kw) == jchecks.check_imgsz(imgsz, stride=32, **kw)
    for cur, req in (("2.1.0", "1.10.0"), ("0.9", "1.0"), ("1.0", "1.0")):
        assert tchecks.check_version(cur, req) == jchecks.check_version(cur, req)
    for v in ("11.2.9+cpu", "2.5", "junk"):
        assert tchecks.parse_version(v) == jchecks.parse_version(v)
    req = tmp_path / "requirements.txt"
    req.write_text("# header\nnumpy>=1.20  # inline\n\npyyaml\n")
    assert [vars(r) for r in tchecks.parse_requirements(req)] == [vars(r) for r in jchecks.parse_requirements(req)]
    assert [vars(r) for r in tchecks.parse_requirements(package="numpy")] == [
        vars(r) for r in jchecks.parse_requirements(package="numpy")]
    assert tchecks.check_imshow(warn=False) == jchecks.check_imshow(warn=False)


def test_print_args_logs_the_callers_arguments():
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    LOGGER.addHandler(h)
    try:
        def demo(alpha=3, beta="x"):
            tchecks.print_args()

        demo()
        tchecks.print_args({"k": 1}, show_file=False, show_func=True)
    finally:
        LOGGER.removeHandler(h)
    out = buf.getvalue()
    assert "alpha=3" in out and "beta=x" in out and "k=1" in out


# ---------------- plotting ----------------


def _same_file(a: Path, b: Path):
    assert a.exists() and b.exists() and a.read_bytes() == b.read_bytes()


def test_plot_images_matches_jax(tmp_path):
    imgs = np.random.default_rng(0).random((5, 64, 64, 3)).astype(np.float32)
    batch_idx = np.array([0, 0, 1, 2, 4])
    cls = np.array([1, 2, 3, 4, 0])
    bboxes = np.array([[0.5, 0.5, 0.3, 0.3], [0.3, 0.3, 0.2, 0.4], [20, 20, 10, 12], [0.5, 0.5, 0.9, 0.9],
                       [0.1, 0.2, 0.1, 0.1]], np.float32)
    names = {i: f"c{i}" for i in range(5)}
    for m, f in ((tplot, "port.jpg"), (jplot, "jax.jpg")):
        m.plot_images(imgs, batch_idx, cls, bboxes, fname=str(tmp_path / f), names=names)
    _same_file(tmp_path / "port.jpg", tmp_path / "jax.jpg")
    a, b = imread(tmp_path / "port.jpg"), imread(tmp_path / "jax.jpg")
    assert np.array_equal(a, b)


def test_plot_results_labels_and_tune_results_write_files(tmp_path):
    csv = tmp_path / "results.csv"
    csv.write_text("epoch,box_loss,cls_loss\n1,3.0,5.0\n2,2.5,4.5\n3,2.0,4.0\n")
    assert Path(tplot.plot_results(csv)).exists()
    rng = np.random.default_rng(0)
    tplot.plot_labels(rng.uniform(0.1, 0.9, (30, 4)), rng.integers(0, 3, 30), {0: "a", 1: "b", 2: "c"},
                      save_dir=tmp_path)
    assert (tmp_path / "labels.jpg").exists()
    tune = tmp_path / "tune" / "tune_results.csv"
    tune.parent.mkdir()
    tune.write_text("\n".join(["fitness,lr0,momentum"] + [",".join(f"{v:.5f}" for v in rng.random(3))
                                                          for _ in range(20)]))
    tplot.plot_tune_results(str(tune))
    assert (tune.parent / "tune_scatter_plots.png").exists() and (tune.parent / "tune_fitness.png").exists()


def test_plt_color_scatter_runs():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(1)
    tplot.plt_color_scatter(rng.random(50), rng.random(50))
    plt.close("all")


def test_output_to_target_matches_jax():
    dets = np.zeros((3, 5, 6), np.float32)
    dets[0, 0] = [10, 20, 30, 40, 0.9, 2]
    dets[1, 0] = [0, 0, 10, 10, 0.8, 1]
    dets[1, 1] = [5, 5, 15, 15, 0.7, 0]
    for got, want in zip(tplot.output_to_target(torch.from_numpy(dets)), jplot.output_to_target(dets)):
        np.testing.assert_array_equal(got, want)
    obb = np.zeros((2, 4, 7), np.float32)
    obb[0, 0] = [10, 10, 20, 20, 0.9, 3, 0.5]
    obb[1, 1] = [5, 5, 8, 8, 0.7, 1, -0.2]
    for got, want in zip(tplot.output_to_rotated_target(obb), jplot.output_to_rotated_target(obb)):
        np.testing.assert_array_equal(got, want)


def _draw(m, pil=False):
    im = np.zeros((200, 300, 3), np.uint8)
    a = m.Annotator(im.copy(), example="中文" if pil else "abc")
    a.box_label([10, 10, 100, 80], "person 0.9", color=(255, 42, 4))
    a.box_label(np.array([[120, 20], [180, 30], [170, 90], [115, 75]]), "obb", rotated=True)
    a.text((5, 190), "hello", box_style=True)
    a.rectangle((200, 5, 290, 40), outline=(0, 255, 0), width=2)
    if not pil:
        a.circle_label([10, 100, 80, 160], "12345")
        a.text_label([150, 100, 280, 160], "queue")
        a.draw_region([(10, 10), (290, 10), (290, 190), (10, 190)], thickness=2)
        a.draw_centroid_and_tracks([(20, 20), (40, 35), (60, 60)])
        a.visioneye([200, 100, 260, 150], (150, 195))
        a.queue_counts_display("Queue: 3", points=[(10, 10), (100, 10), (100, 80), (10, 80)])
        a.display_objects_labels(a.im, "car", (255, 255, 255), (50, 50, 50), 60, 40, 5)
        a.display_analytics(a.im, {"total": 7, "free": 2}, (255, 255, 255), (0, 0, 0), 4)
        a.plot_workout_information("Reps 12", (20, 100))
        a.plot_angle_and_count_and_stage(93.5, 4, "up", (30, 30))
        a.plot_distance_and_line(42.0, [(10, 110), (150, 110)])
    return a.result()


@pytest.mark.parametrize("pil", [False, True], ids=["cv2", "pil"])
def test_annotator_draws_as_jax(pil):
    got, want = _draw(tplot, pil), _draw(jplot, pil)
    assert got.any() and np.array_equal(got, want)
    assert tplot.Annotator.get_bbox_dimension([10, 10, 100, 80]) == (90, 70, 6300)
    assert tplot.Annotator.estimate_pose_angle((0, 1), (0, 0), (1, 0)) == jplot.Annotator.estimate_pose_angle(
        (0, 1), (0, 0), (1, 0))


def test_save_one_box_matches_jax(tmp_path):
    im = np.arange(200 * 200 * 3, dtype=np.uint8).reshape(200, 200, 3)
    for square in (False, True):
        got = tplot.save_one_box(np.array([50.0, 60.0, 90.0, 80.0]), im.copy(), square=square, save=False, BGR=True)
        want = jplot.save_one_box(np.array([50.0, 60.0, 90.0, 80.0]), im.copy(), square=square, save=False, BGR=True)
        assert np.array_equal(got, want)
    assert got.shape[0] == got.shape[1]


# ---------------- boxes, profile, patches, yaml ----------------


def test_clip_coords_and_scale_image_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-20, 120, (10, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(tboxes.clip_coords(pts.copy(), (80, 100)), jboxes.clip_coords(pts.copy(), (80, 100)))
    t = tboxes.clip_coords(torch.from_numpy(pts.copy()), (80, 100))
    np.testing.assert_array_equal(t.numpy(), jboxes.clip_coords(pts.copy(), (80, 100)))
    mask = rng.uniform(0, 1, (64, 64, 2)).astype(np.float32)
    for shape, rp in (((48, 64), None), ((64, 48), None), ((100, 80), ((0.64, 0.64), (6.4, 0.0))), ((64, 64), None)):
        np.testing.assert_array_equal(tboxes.scale_image_np(mask, shape, rp), jboxes.scale_image_np(mask, shape, rp))
    one = tboxes.scale_image_np(mask[..., 0], (48, 64))
    assert one.shape == (48, 64, 1)


def test_profile_timer_and_trace(tmp_path):
    p = Profile()
    with p:
        time.sleep(0.02)
    assert p.dt >= 0.015
    with trace_to(tmp_path / "trace") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = tmp_path / "trace" / "trace.json"
    import json

    assert "traceEvents" in json.loads(trace.read_text())


def test_unicode_image_io_and_imshow(tmp_path, monkeypatch):
    img = np.zeros((8, 10, 3), np.uint8)
    img[2:5, 3:7] = (0, 128, 255)
    p = tmp_path / "图片_ünïcode.png"
    assert imwrite(p, img) and np.array_equal(imread(p), img)
    assert imread(tmp_path / "missing_不存在.png") is None
    assert not imwrite(tmp_path / "no_dir_目录" / "x.png", img)
    import cv2

    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda name, m: shown.append(name))
    imshow("图", img)
    assert shown == ["\\u56fe"]


def test_yaml_save_and_print(tmp_path):
    f = tmp_path / "sub" / "args.yaml"
    yaml_save(f, {"a": 1, "p": tmp_path, "names": {0: "x"}})
    assert yaml_load(f) == {"a": 1, "p": str(tmp_path), "names": {0: "x"}}
    from yololite_tpu.utils import yaml_load as jyaml_load, yaml_save as jyaml_save

    jyaml_save(tmp_path / "j.yaml", {"a": 1, "p": tmp_path, "names": {0: "x"}})
    assert (tmp_path / "j.yaml").read_text() == f.read_text() and jyaml_load(f) == yaml_load(f)
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    LOGGER.addHandler(h)
    try:
        yaml_print(f)
        yaml_print({"k": 2})
    finally:
        LOGGER.removeHandler(h)
    assert "a: 1" in buf.getvalue() and "k: 2" in buf.getvalue()


def test_get_latest_run_picks_the_newest(tmp_path):
    assert get_latest_run(tmp_path) == ""
    for name in ("train10", "train9"):
        d = tmp_path / name / "weights"
        d.mkdir(parents=True)
        (d / "last.npz").write_bytes(b"x")
        time.sleep(0.01)
    assert "train9" in str(get_latest_run(tmp_path))
