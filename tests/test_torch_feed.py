"""The feed to the device (yololite_tpu_torch/data/build.py `DeviceFeed`, `PinnedRing`, `Upload`) on the CPU.

On the CPU the feed runs its thread and ring as on a card, with plain
buffers and a clone in place of the copy, so these tests hold its order,
its ownership of the host buffers and its shutdown. The train, val and
predict paths through the feed are held bit for bit to the same paths with
the direct upload they had before it (`DirectUpload`, a stand-in for
`DeviceFeed` kept here, not in the program). The card's side (pinned
buffers, the copy stream, a slowed step against the next batch's staging)
is in tests/test_torch_kernels.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.cfg import get_cfg
from yololite_tpu_torch.data import build as tbuild
from yololite_tpu_torch.data.build import DeviceFeed, PinnedRing, size_class
from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
from yololite_tpu_torch.data.utils import check_det_dataset
from yololite_tpu_torch.engine import predictor as tpredictor
from yololite_tpu_torch.engine import trainer as ttrainer
from yololite_tpu_torch.engine import validator as tvalidator
from yololite_tpu_torch.models.model import DetectionModel

from tests.test_torch_train import NARROW, _overrides, _write_dataset

HYP = dict(imgsz=96, degrees=5.0, mixup=0.5, copy_paste=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("feeddata")
    return _write_dataset(root, n_train=6, n_val=4, seed=70), root


class DirectUpload:
    """The upload the paths had before the feed, as a stand-in for `DeviceFeed`: each item prepared on the
    consumer's thread into fresh numpy arrays and uploaded with `torch.from_numpy(...).to(device)`."""

    def __init__(self, source, device, prepare=None, ring=None, depth=2):
        self.source, self.device = source, torch.device(device)
        self.prepare = prepare or tbuild._whole_batch
        self.wait_s = 0.0

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        for item in self.source:
            arrays, meta = self.prepare(item, lambda shape, dtype: np.empty(shape, dtype))
            yield {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}, meta

    def close(self):
        pass


def _train_loader(data, workers, seed=0):
    hyp = get_cfg(overrides={**HYP, "data": str(data), "mode": "train"})
    dinfo = check_det_dataset(str(data))
    return build_dataloader(build_yolo_dataset(hyp, dinfo["train"], 2, dinfo, mode="train"), 2, workers,
                            shuffle=True, seed=seed)


# ---------------- order, ownership, shutdown ----------------


def test_size_class_rounds_up_to_an_eighth():
    assert [size_class(n) for n in (0, 1, 1 << 16, (1 << 16) + 1)] == [1 << 16, 1 << 16, 1 << 16, 73728]
    for n in (19_660_800, 29_491_200, 12_345_678):
        c = size_class(n)
        assert n <= c <= n * 1.125 and size_class(c) == c


@pytest.mark.parametrize("workers", [0, 8])
def test_feed_yields_the_loaders_batches_in_order(data, workers):
    """Two epochs of a mosaic train loader through a feed (every batch held to the end, so none may alias another)
    equal the same loader's batches at workers 0 iterated directly: the loader wrote each batch's rows straight into
    a ring buffer (no staging copy), the buffers were reused (fewer allocated than batches), and every buffer is
    idle after each epoch."""
    data, _ = data
    ref = _train_loader(data, 0)
    want = [b for _ in range(2) for b in ref]
    loader, ring = _train_loader(data, workers), PinnedRing("cpu")
    got = []
    for _ in range(2):
        feed = DeviceFeed(loader, "cpu", ring=ring)
        got += list(feed)
        assert feed.upload.staged_bytes == 0 and feed.upload.batches == len(loader) and ring.in_use() == 0
    assert len(got) == len(want) == 2 * len(loader) > ring.depth >= ring.allocations and not ring.pinned
    for (tensors, batch), w in zip(got, want):
        assert list(tensors) == ["img"] and torch.equal(tensors["img"], torch.from_numpy(w["img"]))
        for k in ("cls", "bboxes", "batch_idx"):
            np.testing.assert_array_equal(batch[k], w[k])


def test_a_slow_consumer_holds_no_ring_buffer(data):
    """With a consumer slower than the loader and holding every batch, the buffers in use stay within the ring's
    depth and every batch keeps the bytes it was given: the ring hands a buffer out again only after its copy."""
    data, _ = data
    ref = _train_loader(data, 0)
    want = [b["img"] for _ in range(3) for b in ref]
    loader, ring = _train_loader(data, 2), PinnedRing("cpu", depth=4)
    got = []
    for _ in range(3):
        for tensors, _ in DeviceFeed(loader, "cpu", ring=ring):
            time.sleep(0.02)
            got.append(tensors["img"])
    assert ring.peak_in_use <= ring.depth and ring.in_use() == 0
    assert all(torch.equal(g, torch.from_numpy(w)) for g, w in zip(got, want)) and len(got) == len(want)


class _Copy:
    """An event standing for a copy out of a buffer: done when the test says so, or once waited on."""

    def __init__(self):
        self.done, self.waited = False, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def test_ring_reuses_a_buffer_only_after_its_copy():
    """A buffer whose copy is in flight is not handed out again: the ring takes another while fewer than `depth`
    of the class are in use, then waits for the oldest copy; a writer's buffer (no copy yet) never makes it
    wait; a completed copy makes its buffer idle for the next take of its class."""
    ring = PinnedRing("cpu", depth=2)
    a = ring.take(1000)
    ca = _Copy()
    ring.release([a], ca)
    b = ring.take(2000)  # the same class: a's copy is in flight, so another buffer
    assert b is not a and not ca.waited
    cb = _Copy()
    ring.release([b], cb)
    c = ring.take(3000)  # depth reached, both copying: waits for the oldest, a's
    assert c is a and ca.waited and not cb.waited
    d = ring.take(10)  # depth reached again, b's copy in flight, c held by a writer: waits for b's
    assert d is b and cb.waited
    e = ring.take(10)  # every buffer of the class held by writers: a new one, no wait
    assert e is not a and e is not b and ring.allocations == 3 and ring.peak_in_use == 3
    ring.release([c, d, e])
    assert ring.in_use() == 0 and ring.take(5) in (a, b, e) and ring.allocations == 3
    big = ring.take(1 << 20)
    assert big.capacity == size_class(1 << 20) and big.view((2, 4), np.float32).shape == (2, 4)
    assert big.tensor((3, 5), np.int32).dtype == torch.int32


def test_source_exception_surfaces_and_an_early_break_stops_the_thread(data):
    """An exception of the source or of prepare is raised in the consumer after the batches before it; leaving the
    loop early ends the feed's thread, closes the loader on it and returns every buffer to the ring."""
    def failing():
        for i in range(3):
            yield {"img": np.full((1, 4, 4, 3), i, np.uint8)}
        raise ValueError("source failed")

    seen = []
    with pytest.raises(ValueError, match="source failed"):
        for tensors, _ in DeviceFeed(failing(), "cpu"):
            seen.append(int(tensors["img"][0, 0, 0, 0]))
    assert seen == [0, 1, 2]

    def bad_prepare(item, take):
        raise KeyError("prepare failed")

    with pytest.raises(KeyError, match="prepare failed"):
        next(iter(DeviceFeed([{"img": np.zeros((1, 4, 4, 3), np.uint8)}], "cpu", bad_prepare)))

    data, _ = data
    ring = PinnedRing("cpu")
    feed = DeviceFeed(_train_loader(data, 2), "cpu", ring=ring)
    threads = []
    for tensors, _ in feed:
        threads.append(feed.thread)
        deadline = time.monotonic() + 30
        while ring.allocations < 2 and time.monotonic() < deadline:  # a later batch in flight holds a buffer too
            time.sleep(0.01)
        break
    threads[0].join(timeout=30)
    assert not threads[0].is_alive() and feed.thread is None
    assert ring.in_use() == 0 and ring.allocations >= 2  # the loader's batches in flight went back too
    assert threading.active_count() < 50


# ---------------- the paths, through the feed and with the direct upload ----------------


def _narrow_trainer(data, root, name, **kw):
    tr = ttrainer.DetectionTrainer(overrides=_overrides(data, root, name, **kw), device="cpu")
    tr.set_model(DetectionModel(NARROW, nc=3).init(0))
    return tr


def test_trainer_through_the_feed_equals_the_direct_upload(data, monkeypatch):
    """Three steps of a multi-scale epoch (accumulate 2, loader at 2 threads), the batches through the feed: loss
    items, every gradient after each grad step, the weights after each apply and the multi-scale sizes equal those
    of the same steps with the direct upload, bit for bit; so do a whole `train()` epoch's loss items, weights,
    BN statistics, EMA and optimizer moments."""
    data, root = data
    kw = dict(imgsz=64, multi_scale=True, nbs=4, workers=2, optimizer="AdamW", save=False, mosaic=0.5)
    runs = {}
    for how in ("feed", "direct"):
        with monkeypatch.context() as m:
            if how == "direct":
                m.setattr(ttrainer, "DeviceFeed", DirectUpload)
            tr = _narrow_trainer(data, root, f"steps_{how}", **kw)
            tr._setup_train()
            rec = []
            for ni, (staged, meta) in enumerate(tr.feed(tr.train_loader)):
                assert meta is None and staged["img"].dtype == torch.uint8
                tr.accumulate, lr_vec, momentum = tr._schedule(ni, 2, 0)
                items = tr._grad_step(staged["img"], {k: staged[k] for k in ttrainer.TARGET_KEYS})
                rec.append(("step", tuple(staged["img"].shape), items.clone(), [g.clone() for g in tr._grads]))
                if ni % 2:
                    tr._apply_step(lr_vec, momentum)
                    rec.append(("weights", [v.clone() for v in tr.model.state_dict().values()]))
            runs[how] = (rec, sorted(tr._step_shapes))
    (got, shapes), (want, want_shapes) = runs["feed"], runs["direct"]
    assert len(got) == len(want) == 4 and shapes == want_shapes and len({r[1] for r in got if r[0] == "step"}) > 1
    for g, w in zip(got, want):
        assert g[0] == w[0] and all(torch.equal(x, y) for x, y in zip(g[-1], w[-1]))
        if g[0] == "step":
            assert g[1] == w[1] and torch.equal(g[2], w[2])

    ends = {}
    for how in ("feed", "direct"):
        with monkeypatch.context() as m:
            if how == "direct":
                m.setattr(ttrainer, "DeviceFeed", DirectUpload)
            tr = _narrow_trainer(data, root, f"train_{how}", **kw)
            tr.train()
            ends[how] = tr
    a, b = ends["feed"], ends["direct"]
    assert a.last_feed.upload.batches == 3 and a._ring.in_use() == 0 and isinstance(b.last_feed, DirectUpload)
    np.testing.assert_array_equal(a.tlosses[0], b.tlosses[0])
    for x, y in ((a.model, b.model), (a.ema.ema, b.ema.ema)):
        assert all(torch.equal(u, v) for u, v in zip(x.state_dict().values(), y.state_dict().values()))
    assert all(torch.equal(u, v) for u, v in zip(a.optimizer.state_tensors(), b.optimizer.state_tensors()))


def test_val_through_the_feed_equals_the_direct_upload(data, monkeypatch):
    """Standalone rect val at 2 loader threads: the metrics and every image's matches, scores and classes through
    the feed equal those with the direct upload; the feed's buffers are idle after the call and reused by a
    second one."""
    data, root = data
    model = DetectionModel(NARROW, nc=3).init(0)
    with torch.no_grad():
        for seq in model.detect.cv3:
            seq[2].bias.fill_(-2.0)
    args = dict(data=str(data), imgsz=96, batch=2, conf=1e-7, rect=True, mode="val", plots=False, workers=2)
    runs = {}
    for how in ("feed", "direct"):
        with monkeypatch.context() as m:
            if how == "direct":
                m.setattr(tvalidator, "DeviceFeed", DirectUpload)
            v = tvalidator.DetectionValidator(save_dir=root / f"val_{how}", args=args, device="cpu")
            runs[how] = (v(model=model), {k: [np.asarray(x) for x in xs] for k, xs in v.stats.items()}, v)
    (got, gstats, gv), (want, wstats, _) = runs["feed"], runs["direct"]
    assert got == want and sum(len(c) for c in gstats["conf"]) > 0
    for k in wstats:
        assert len(gstats[k]) == len(wstats[k]) and all(np.array_equal(x, y) for x, y in zip(gstats[k], wstats[k]))
    allocations = gv._ring.allocations
    assert gv(model=model) == got and gv._ring.allocations == allocations and gv._ring.in_use() == 0


def _sources():
    """In-memory sources: one batch each, of 3 images, padded to the batch of 4."""
    rng = np.random.default_rng(8)
    same = [rng.integers(0, 256, (60, 80, 3), np.uint8) for _ in range(3)]
    mixed = [rng.integers(0, 256, s, np.uint8) for s in ((60, 80, 3), (50, 45, 3), (64, 64, 3))]
    tensor = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    return {"same-shape": same, "mixed-shape": mixed, "tensor": tensor}


@pytest.mark.parametrize("source", list(_sources()))
def test_predict_through_the_feed_equals_the_direct_upload(source, monkeypatch):
    """Predict at batch 4 (3 images, padded): every detection through the feed equals, bit for bit, the one with the
    direct upload, and each batch's array is the one the predictor built before the feed (frames stacked, or
    letterboxed on the host, then zero images up to the batch size)."""
    src = _sources()[source]
    model = YOLOLite("yolo11n.yaml", device="cpu")
    kw = dict(conf=1e-7, imgsz=64, batch=4, save=False, verbose=False)
    runs = {}
    for how in ("feed", "direct"):
        with monkeypatch.context() as m:
            if how == "direct":
                m.setattr(tpredictor, "DeviceFeed", DirectUpload)
            runs[how] = model.predict(src, **kw)
        if how == "feed":
            pred = model.predictor
            assert pred.last_feed.upload.batches == 1 and pred._ring.in_use() == 0
    assert len(runs["feed"]) == len(runs["direct"]) == len(src)
    for g, w in zip(runs["feed"], runs["direct"]):
        assert g.orig_shape == w.orig_shape and len(g.boxes.data) > 0
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)

    take = lambda shape, dtype: np.full(shape, 7, dtype)  # a used buffer: the padding must be written
    arrays, meta = pred._stage((["p"] * 3, src, [""] * 3), take, source == "tensor")
    old = {"same-shape": lambda: np.stack(src), "mixed-shape": lambda: tpredictor.preprocess_batch(src, imgsz=64),
           "tensor": lambda: np.asarray(src, np.float32)}[source]()
    old = np.concatenate([old, np.zeros((1, *old.shape[1:]), old.dtype)])
    assert meta[0] == {"same-shape": "uint8", "mixed-shape": "host", "tensor": "tensor"}[source]
    assert arrays["x"].dtype == old.dtype and np.array_equal(arrays["x"], old)
