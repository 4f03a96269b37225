"""engine/graphs.py on the CPU: a CPU tensor runs the step directly and caches nothing, the key separates modules,
and the predictor and validator wire their steps through a GraphCache that is dropped when the net changes.

Capture and replay need a card: tests/test_torch_kernels.py holds graphed predict and val to the eager calls
there, bit for bit, with the launch counts of each replay.
"""

import numpy as np
import pytest
import torch

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.engine import graphs
from yololite_tpu_torch.engine.graphs import GraphCache
from yololite_tpu_torch.engine.validator import DetectionValidator
from yololite_tpu_torch.models.model import DetectionModel

NARROW = {  # yolo11's blocks at strides 8/16/32, a few rows, narrow widths
    "nc": 3,
    "scale": "n",
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "C3k2", [16, False, 0.25]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "C3k2", [32, False, 0.25]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "C3k2", [32, True]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "SPPF", [64, 5]],
    ],
    "head": [[[4, 6, 8], 1, "Detect", ["nc"]]],
}


def test_cpu_tensor_runs_the_step_directly_and_caches_nothing():
    cache = GraphCache()
    calls = []
    x = torch.arange(6.0).reshape(2, 3)
    out = cache(lambda t: calls.append(t) or t * 2, x, module=None)
    assert torch.equal(out, x * 2) and len(calls) == 1 and calls[0] is x
    assert len(cache) == 0 and cache.calls == 0 and not cache._seen
    assert graphs.pool_reserved_bytes() == 0 and graphs._pool is None  # no pool is made off the card


def test_key_separates_modules_shapes_and_settings():
    cache = GraphCache()
    a, b = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    x = torch.zeros(4, 2)
    assert cache.key(x, a) != cache.key(x, b)  # two modules on the same device and shape
    assert cache.key(x, a) == cache.key(x.clone(), a)
    assert cache.key(x, a) != cache.key(torch.zeros(5, 2), a)
    assert cache.key(x, a) != cache.key(x.double(), a)
    assert cache.key(x, a, ("uint8", 640)) != cache.key(x, a, ("uint8", 320))


def test_first_sight_runs_eagerly_the_second_captures_and_later_ones_replay():
    cache = GraphCache()
    made = []
    capture = lambda warm: made.append(warm) or object()
    assert cache._lookup("a", capture) is None and not made  # first sight: eager, nothing captured
    g = cache._lookup("a", capture)
    assert g is not None and len(cache) == 1 and cache.captures == 1
    assert made == [False] and cache.warmups == 0  # this thread ran the first call: no warm-up run
    assert cache._lookup("a", capture) is g and len(made) == 1  # a replay of the same graph
    assert cache._lookup("b", capture) is None and len(cache) == 1


def test_the_cache_holds_at_most_max_graphs_and_drops_the_least_recently_replayed():
    cache = GraphCache()
    capture = lambda warm: object()
    for k in range(graphs.MAX_GRAPHS):
        cache._lookup(k, capture)
        cache._lookup(k, capture)
    first = cache._lookup(0, capture)  # key 0 replayed last: key 1 is now the least recent
    new = graphs.MAX_GRAPHS
    cache._lookup(new, capture)
    cache._lookup(new, capture)
    assert len(cache) == graphs.MAX_GRAPHS and 1 not in cache._graphs and cache._graphs[0] is first
    assert cache._lookup(1, capture) is None  # a dropped key starts over: eager first


def test_keys_seen_once_are_bounded():
    cache = GraphCache()
    capture = lambda warm: object()
    for k in range(graphs.MAX_SEEN + 1):
        assert cache._lookup(k, capture) is None
    assert len(cache._seen) == graphs.MAX_SEEN and 0 not in cache._seen
    assert cache._lookup(0, capture) is None  # forgotten: a first sight again
    assert cache._lookup(graphs.MAX_SEEN, capture) is not None  # remembered: captured


def test_a_capture_on_another_thread_than_the_first_call_warms_up():
    import threading

    cache = GraphCache()
    made = []
    capture = lambda warm: made.append(warm) or object()
    t = threading.Thread(target=lambda: cache._lookup("a", capture))  # the first call on another thread
    t.start()
    t.join()
    assert cache._lookup("a", capture) is not None and made == [True] and cache.warmups == 1


def test_clear_forgets_graphs_and_keys_seen():
    cache = GraphCache()
    capture = lambda warm: object()
    cache._lookup("a", capture)
    cache._lookup("a", capture)
    cache._lookup("b", capture)
    cache.clear()
    assert len(cache) == 0 and not cache._seen
    assert cache._lookup("b", capture) is None


def test_eager_nests():
    assert graphs._eager == 0
    with graphs.eager():
        with graphs.eager():
            assert graphs._eager == 2
        assert graphs._eager == 1
    assert graphs._eager == 0


class _Spy(GraphCache):
    def __init__(self):
        super().__init__()
        self.calls, self.clears = [], 0

    def __call__(self, fn, x, module, extra=()):
        self.calls.append((module, tuple(x.shape), x.dtype, extra))
        return super().__call__(fn, x, module, extra)

    def clear(self):
        self.clears += 1
        super().clear()


def test_predictor_steps_go_through_its_cache_and_quantizing_drops_it():
    """infer and infer_uint8 run through the predictor's GraphCache with the net they run; set-up clears the
    cache, and so does int8 quantization after the warm-up (a stale graph would serve the float weights)."""
    m = YOLOLite(NARROW, device="cpu")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (64, 96, 3), np.uint8) for _ in range(2)]
    kw = dict(conf=1e-7, imgsz=64, batch=2, save=False, verbose=False)
    m.predict(frames, **kw)
    pred = m.predictor
    spy = pred._graphs = _Spy()
    raw = torch.from_numpy(np.stack(frames))
    pred.infer_uint8(raw, 64)
    pred.infer(torch.zeros((2, 64, 64, 3)))
    (mod1, shape1, dtype1, key1), (mod2, shape2, dtype2, key2) = spy.calls
    assert mod1 is mod2 is pred.net and (shape1, dtype1) == ((2, 64, 96, 3), torch.uint8)
    assert key1[:2] == ("uint8", 64) and key2[0] == "float" and key1[2:] == key2[1:]
    pred.setup_model(m.model)
    assert pred._graphs is spy and spy.clears == 1

    q = YOLOLite(NARROW, device="cpu")
    q.predict(frames, **kw, int8=False)
    qp = q.predictor
    qp.args.int8 = True
    spy = qp._graphs = _Spy()
    float_net = qp.net
    qp._maybe_quantize(lambda: np.stack(frames).astype(np.float32) / 255.0)
    assert spy.clears == 1 and qp.net is not float_net
    qp.infer(torch.zeros((2, 64, 64, 3)))
    assert spy.calls[-1][0] is qp.net and spy.calls[-1][3][1] is True  # keyed on the quantized net


def test_validator_graphs_standalone_and_not_the_trainers_val():
    """Standalone val steps through a cache of its own; a trainer's val through the validator's `ema_graphs`, one
    cache kept across its calls (its net's weights move in place); without a cache the step runs eagerly. On CPU
    tensors nothing is captured and all three give the same detections."""
    v = DetectionValidator(args={"imgsz": 64, "batch": 2, "conf": 1e-7, "mode": "val"}, device="cpu")
    model = DetectionModel(NARROW).init(0)
    standalone = v._build_infer(model.eval(), model, half=False, graphs=GraphCache())
    trainers = v._build_infer(model.eval(), model, half=False, graphs=v.ema_graphs)
    eager = v._build_infer(model.eval(), model, half=False)
    assert isinstance(standalone.graphs, GraphCache) and standalone.graphs is not v.ema_graphs
    assert trainers.graphs is v.ema_graphs and eager.graphs is None
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), np.uint8))
    assert torch.equal(standalone(x), eager(x)) and torch.equal(trainers(x), eager(x))
    assert len(standalone.graphs) == len(v.ema_graphs) == 0  # CPU tensors: nothing captured


@pytest.mark.parametrize("amp", [False, True])
def test_trainer_forward_feeds_an_nchw_batch(amp, monkeypatch):
    """The train step's batch is NCHW-contiguous on the CPU (and on the card, in one process or on ranks, with amp
    off); the model sees the same values."""
    from yololite_tpu_torch.engine import trainer as T

    seen = []
    monkeypatch.setattr(T, "forward_nhwc", lambda model, x: seen.append(x) or [])
    tr = T.DetectionTrainer.__new__(T.DetectionTrainer)
    tr.args = type("A", (), {"amp": amp})()
    tr.device, tr.model = torch.device("cpu"), None
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), np.uint8))
    tr._forward(images)
    x = seen[0]
    assert x.permute(0, 3, 1, 2).is_contiguous()
    assert torch.equal(x, images.float() * (1.0 / 255.0))


# ---------------- the train step's graphs: keys, static gradients, resume, the EMA val's bf16 copy ----------------


def _bare_trainer(amp=False):
    from yololite_tpu_torch.engine import trainer as T

    tr = T.DetectionTrainer.__new__(T.DetectionTrainer)
    tr.args = type("A", (), {"amp": amp})()
    tr.device = torch.device("cpu")
    return tr


def test_train_graph_keys_separate_shape_m_amp_and_kind_not_momentum():
    """A train step's key holds its kind, the batch's shape and dtype, the GT bucket and amp; lr and momentum are
    device scalars, so no key holds them: one apply graph, and one fused graph per batch key, serve the warmup
    ramp."""
    tr = _bare_trainer()
    img = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    t16, t32 = ({"gt_bboxes": torch.zeros((2, m, 4))} for m in (16, 32))
    grad = tr._step_key("grad", img, t16)
    assert grad == tr._step_key("grad", img.clone(), {"gt_bboxes": torch.ones((2, 16, 4))})
    assert grad != tr._step_key("grad", torch.zeros((2, 96, 64, 3), dtype=torch.uint8), t16)  # shape
    assert grad != tr._step_key("grad", torch.zeros((2, 64, 64, 3)), t16)  # dtype
    assert grad != tr._step_key("grad", img, t32)  # GT bucket M
    assert grad != _bare_trainer(amp=True)._step_key("grad", img, t16)  # amp
    fused = tr._step_key("fused", img, t16)
    assert fused != grad and fused[1:] == grad[1:]  # kind
    apply = tr._step_key("apply", None, None)
    assert apply == ("apply", "cpu") and apply != grad
    with pytest.raises(TypeError):  # no momentum argument left
        tr._step_key("apply", None, None, 0.9)


def test_static_grad_accumulation_equals_set_to_none():
    """Two backwards into gradients allocated once as zeros (added in place, as a captured step does) equal two
    backwards from set_to_none, bit for bit; zeroing in place then a third equals a fresh one."""
    torch.manual_seed(0)
    models = [DetectionModel(NARROW).init(0).train() for _ in range(2)]
    xs = [torch.from_numpy(np.random.default_rng(s).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
          for s in (3, 4, 5)]
    static = [p for p in models[0].parameters() if p.requires_grad]
    for p in static:
        p.grad = torch.zeros_like(p)
    grads = [p.grad for p in static]
    for m in models:
        for x in xs[:2]:
            sum(f.sum() for f in m(x)).backward()
    assert all(p.grad is g for p, g in zip(static, grads))  # in place: the same tensors
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a.grad, b.grad)
    torch._foreach_zero_(grads)
    models[1].zero_grad(set_to_none=True)
    for m in models:
        sum(f.sum() for f in m(xs[2])).backward()
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("name", ["Adam", "AdamW", "NAdam", "SGD"])
def test_load_moments_places_state_on_the_parameters_device_when_capturable(name):
    """The optimizer keeps all of its state on the parameters' device (the card's, which a captured apply reads):
    the moments, the int32 step, NAdam's fp32 mu_product and the lr and momentum scalars, allocated at
    construction; `load_moments` writes them in place, so a table or graph built before still reads them. The meta
    device stands in for the card; the CPU gives the values."""
    from yololite_tpu_torch.engine import optim as toptim

    for device in ("meta", "cpu"):
        model = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 1)).to(device)
        opt = toptim.build_optimizer(name, model, lr=0.01, momentum=0.9, weight_decay=0.0)
        named = dict(model.named_parameters())
        held = [*opt.mu, *opt.nu, opt.step, opt.extra, opt.hyper]
        mu = {n: torch.ones_like(p, device="cpu") for n, p in named.items()}
        nu = {n: torch.full_like(p, 2.0, device="cpu") for n, p in named.items()}
        toptim.load_moments(name, opt, named, mu, nu, step=5, beta1=0.9)
        assert all(a is b for a, b in zip(held, [*opt.mu, *opt.nu, opt.step, opt.extra, opt.hyper]))  # in place
        assert all(t.device.type == device for t in held)
        assert opt.step.dtype == torch.int32 and opt.extra.dtype == opt.hyper.dtype == torch.float32
        if device == "cpu":
            assert int(opt.step) == 5 and all(bool((m == 1).all()) for m in opt.mu)
            assert all(bool((v == 2).all()) for v in opt.nu)
            want = np.float32(toptim.nadam_mu_product(5, 0.9)) if name == "NAdam" else np.float32(1.0)
            assert float(opt.extra) == float(want)


def test_half_ema_val_copy_updated_in_place_equals_a_fresh_inference_net():
    """A half-precision trainer val keeps one bf16 copy of the EMA; each val copies the EMA's weights into it in
    place (so a graph captured on it reads them), equal bit for bit to a fresh inference_net(ema, half, unfused)."""
    from yololite_tpu_torch.engine.predictor import inference_net

    v = DetectionValidator(args={"imgsz": 64, "batch": 2, "conf": 1e-7, "mode": "val"}, device="cpu")
    ema = DetectionModel(NARROW).init(0).eval()
    assert v._ema_net(ema, half=False) is ema  # fp32: the EMA module itself
    first = v._ema_net(ema, half=True)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for t in ema.state_dict().values():
            if t.is_floating_point():
                t.add_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) * 0.1)
    again = v._ema_net(ema, half=True)
    assert again is first and not again.training
    fresh = inference_net(ema, torch.device("cpu"), True, fuse=False)
    got, want = again.state_dict(), fresh.state_dict()
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    other = DetectionModel(NARROW).init(1).eval()
    assert v._ema_net(other, half=True) is not first  # another trainer's EMA: a copy of its own
