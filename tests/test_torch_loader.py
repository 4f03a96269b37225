"""The port's host loader against the JAX package's, on the CPU: batches bit for bit at any number of threads.

The port plans each batch on one thread in load order (every augmentation
draw, the labels, the image buffer) and spreads the pixel work over its
pool (yololite_tpu_torch/data/dataset.py `DataLoader`). Its batches are
held to the JAX package's loader at workers 0, where one thread loads
everything in order: images, classes and batch indices equal, boxes within
1e-5 (as tests/test_torch_train.py holds augmented items), and the port's
batches at workers 1, 2 and 8 equal to its own at workers 0 in every bit.
The data is a small synthetic set under tmp_path at imgsz 128
(tests/test_torch_train.py `_write_dataset`), never coco8.

On data-parallel ranks each rank plans the global batch and builds its own
image rows: its rows must equal the one-process batch's slice, and its
labels and targets (the GT width M included) the global batch's.
"""

import copy
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from yololite_tpu.cfg import get_cfg as jax_get_cfg
from yololite_tpu.data import augment as jaug
from yololite_tpu.data.dataset import DataLoader as JaxDataLoader
from yololite_tpu.data.dataset import YOLODataset as JaxYOLODataset

from yololite_tpu_torch.cfg import get_cfg
from yololite_tpu_torch.data import augment as taug
from yololite_tpu_torch.data.dataset import DataLoader, ImageCache, YOLODataset
from yololite_tpu_torch.engine import trainer as ttrainer
from yololite_tpu_torch.engine.trainer import data_parallel_step
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_parallel import _assert_steps_equal
from tests.test_torch_train import NARROW, _overrides, _write_dataset

NAMES = {"names": {0: "a", 1: "b", 2: "c"}}
HYP = dict(imgsz=128, degrees=5.0, shear=2.0, perspective=0.0005, flipud=0.5, mixup=0.5, copy_paste=0.5)
BATCH = 4
BUFFER_BATCH = 1  # the dataset's batch_size sets its buffer: 8 of the 14 images, so loads evict and reload
KEYS = ("img", "cls", "bboxes", "batch_idx")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("loaderdata")
    return _write_dataset(root, n_train=14, n_val=6, seed=50), root


def _epochs(ds, loader, hyp, close):
    """Two epochs of batches, mosaic closed before the second, and the buffer after each epoch."""
    out = []
    for epoch in range(2):
        if epoch == 1:
            ds.close_mosaic(hyp=close(hyp))
        out.append(([{k: b[k].copy() for k in KEYS} for b in loader], list(ds.buffer)))
    return out


@pytest.fixture(scope="module")
def jax_train(data):
    _, root = data
    random.seed(3)
    np.random.seed(3)
    ds = JaxYOLODataset(str(root / "images" / "train"), hyp=jax_get_cfg(overrides=HYP), imgsz=128,
                        batch_size=BUFFER_BATCH, augment=True, data=NAMES)
    return _epochs(ds, JaxDataLoader(ds, batch_size=BATCH, shuffle=True, workers=0, seed=7),
                   jax_get_cfg(overrides=HYP), copy.copy)


def _port_train(root, workers, batch=BATCH, rank=0, world=1):
    ds = YOLODataset(str(root / "images" / "train"), hyp=get_cfg(overrides=HYP), imgsz=128,
                     batch_size=BUFFER_BATCH, augment=True, data=NAMES, seed=3)
    return ds, DataLoader(ds, batch_size=batch, shuffle=True, workers=workers, seed=7, rank=rank, world=world)


@pytest.fixture(scope="module")
def port_train_one_thread(data):
    ds, loader = _port_train(data[1], 0)
    return _epochs(ds, loader, get_cfg(overrides=HYP), copy.copy)


@pytest.mark.parametrize("workers", [0, 1, 2, 8])
def test_train_loader_matches_jax_at_any_workers(data, jax_train, port_train_one_thread, workers):
    """Mosaic, copy-paste, mixup, perspective and flips over 2 epochs and a close_mosaic: every batch equal to the JAX
    loader's at workers 0 and, bit for bit, to the port's at workers 0; the buffer equal after each epoch; the image
    cache holds nothing outside the buffer once an epoch is done."""
    ds, loader = _port_train(data[1], workers)
    got = []
    for epoch in range(2):
        if epoch == 1:
            ds.close_mosaic(hyp=get_cfg(overrides=HYP))
        batches = [{k: b[k].copy() for k in KEYS} for b in loader]
        got.append((batches, list(ds.buffer)))
        assert ds.ims.indices() <= set(ds.buffer) and not ds.ims.pinned()
    n_boxes = 0
    for (g, gbuf), (w, wbuf), (o, _) in zip(got, jax_train, port_train_one_thread):
        assert gbuf == wbuf and len(gbuf) == 7 and len(g) == len(w) == 4  # a load that fills 8 evicts one
        for gb, wb, ob in zip(g, w, o):
            assert gb["img"].shape[1:] == (128, 128, 3) and gb["img"].flags.c_contiguous
            np.testing.assert_array_equal(gb["img"], wb["img"])
            np.testing.assert_array_equal(gb["cls"], wb["cls"])
            np.testing.assert_array_equal(gb["batch_idx"], wb["batch_idx"])
            np.testing.assert_allclose(gb["bboxes"], wb["bboxes"], rtol=0, atol=1e-5)
            for k in KEYS:
                np.testing.assert_array_equal(gb[k], ob[k], err_msg=k)
            n_boxes += len(gb["cls"])
    assert n_boxes > 0


@pytest.mark.parametrize("n", [3, 9])
def test_mosaic_strip_and_spiral_match_jax(data, n):
    """The 3-tile strip and the 9-tile spiral, planned then applied, equal the JAX package's mosaics."""
    _, root = data
    images = str(root / "images" / "train")
    kw = dict(imgsz=128, batch_size=BUFFER_BATCH, augment=True, data=NAMES)
    random.seed(4)
    np.random.seed(4)
    jds = JaxYOLODataset(images, hyp=jax_get_cfg(overrides=HYP), **kw)
    tds = YOLODataset(images, hyp=get_cfg(overrides=HYP), seed=4, **kw)
    jds.transforms = jaug.Compose([jaug.Mosaic(jds, imgsz=128, p=1.0, n=n), jaug.Format()])
    tds.transforms = taug.Compose([taug.Mosaic(tds, tds.rng, imgsz=128, p=1.0, n=n), taug.Format(rng=tds.rng)])
    for i in [0, 5, 9, 5, 13]:
        g, w = tds[i], jds[i]
        assert g["img"].shape == w["img"].shape == (256, 256, 3)
        np.testing.assert_array_equal(g["img"], w["img"])
        np.testing.assert_array_equal(g["cls"], w["cls"])
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=0, atol=1e-5)
    assert tds.buffer == jds.buffer


def _val_batches(loader):
    return [{k: b[k] for k in KEYS} for b in loader]


def test_val_loader_matches_jax_at_8_workers(data):
    """Rect val: the loader at workers 8 equals workers 1 bit for bit, and both the JAX package's loader."""
    _, root = data
    kw = dict(imgsz=128, batch_size=BATCH, rect=True, data=NAMES)
    images = str(root / "images" / "val")
    jds = JaxYOLODataset(images, **kw)
    want = _val_batches(JaxDataLoader(jds, batch_size=BATCH, workers=0))
    got = {w: _val_batches(DataLoader(YOLODataset(images, **kw), batch_size=BATCH, workers=w)) for w in (1, 8)}
    assert len(want) == len(got[1]) == len(got[8]) == 2
    for w8, w1, wj in zip(got[8], got[1], want):
        for k in KEYS:
            np.testing.assert_array_equal(w8[k], w1[k], err_msg=k)
            np.testing.assert_array_equal(w8[k], wj[k], err_msg=k)


@pytest.fixture(scope="module")
def rank_trainer(data, tmp_path_factory):
    """A one-process trainer set up on the data (batch 8), for its targets and its rows."""
    path, _ = data
    tr = ttrainer.DetectionTrainer(overrides=_overrides(path, tmp_path_factory.mktemp("runs"), "ranks", batch=8),
                                   device="cpu")
    tr.set_model(DetectionModel(NARROW, nc=3).init(0))
    tr._setup_train()
    return tr


@pytest.mark.parametrize("world", [2, 4])
def test_rank_builds_its_rows_of_the_global_batch(data, rank_trainer, world):
    """Batch 8 over 14 images (8, then a tail of 6): each rank's image rows equal the one-process batch's slice (the
    tail whole where it does not divide), its labels and targets the global batch's, M included."""
    _, root = data
    one = [dict(b) for b in _port_train(root, 2, batch=8)[1]]
    for rank in range(world):
        got = list(_port_train(root, 2, batch=8, rank=rank, world=world)[1])
        assert len(got) == len(one) == 2
        for g, o in zip(got, one):
            n = len(o["img"])
            k = n // world if n % world == 0 else n
            lo = rank * k if n % world == 0 else 0
            assert g["img_rows"] == (lo, lo + k, n)
            np.testing.assert_array_equal(g["img"], o["img"][lo:lo + k])
            for key in ("cls", "bboxes", "batch_idx"):
                np.testing.assert_array_equal(g[key], o[key], err_msg=key)
            tg, to = rank_trainer._targets(g), rank_trainer._targets(o)
            assert tg.keys() == to.keys() and tg["gt_bboxes"].shape[:2] == to["gt_bboxes"].shape[:2]
            assert to["gt_bboxes"].shape[0] == n
            for key in to:
                assert torch.equal(tg[key], to[key]), key


def test_apply_raises_on_a_decode_that_contradicts_the_plan(data):
    """An image whose decoded size is not its label cache's (the plan's) raises, naming the file; no re-plan."""
    _, root = data
    ds = YOLODataset(str(root / "images" / "train"), hyp=get_cfg(overrides=HYP), imgsz=128, batch_size=BATCH,
                     augment=True, data=NAMES)
    i = next(j for j, lb in enumerate(ds.labels) if lb["shape"][0] != lb["shape"][1])
    ds.labels[i]["shape"] = tuple(ds.labels[i]["shape"][::-1])
    item = ds.plan(i)
    with pytest.raises(ValueError, match=ds.im_files[i].split("/")[-1]):
        ds.apply(item)
    assert not ds.ims.pinned()
    with pytest.raises(ValueError, match="label cache"):
        list(DataLoader(ds, batch_size=BATCH, workers=2))


def test_image_cache_keeps_pinned_images_and_loads_each_once():
    """An image leaves the cache only once it is neither pinned nor kept; concurrent gets load it once."""
    cache = ImageCache()
    loads = []

    def load():
        loads.append(1)
        time.sleep(0.01)
        return np.zeros((2, 2, 3), np.uint8)

    cache.keep(5)
    cache.pin(5)
    out = []
    threads = [threading.Thread(target=lambda: out.append(cache.get(5, load))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and len(out) == 8 and all(o is out[0] for o in out)
    cache.release(5)  # evicted from the buffer while an item still needs it
    assert 5 in cache and cache.indices() == {5}
    cache.unpin([5])
    assert 5 not in cache and not cache.pinned()
    cache.pin(6)
    with pytest.raises(OSError):
        cache.get(6, lambda: (_ for _ in ()).throw(OSError("unreadable")))
    assert 6 not in cache
    kept = ImageCache(keep_all=True)
    kept.pin(1)
    kept.get(1, load)
    kept.unpin([1])
    assert 1 in kept


def test_image_cache_under_contention():
    """24 threads (more than the cores) pin, read and unpin shuffled images while another keeps and releases them,
    with a short switch interval: every read is the image asked for, and at the end nothing is pinned and nothing
    outside the kept set is held."""
    cache = ImageCache()
    kept, kept_lock = set(), threading.Lock()
    errors = []

    def reader(seed):
        rng = random.Random(seed)
        for _ in range(300):
            i = rng.randrange(16)
            cache.pin(i)
            try:
                if int(cache.get(i, lambda i=i: np.full((2, 2), i))[0, 0]) != i:
                    errors.append(i)
            finally:
                cache.unpin([i])

    def keeper():
        rng = random.Random(99)
        for _ in range(2000):
            i = rng.randrange(16)
            with kept_lock:
                if i in kept:
                    kept.discard(i)
                    cache.release(i)
                else:
                    kept.add(i)
                    cache.keep(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(k,)) for k in range(24)] + [threading.Thread(target=keeper)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not cache.pinned() and cache.indices() <= kept


@pytest.mark.parametrize("seed", [0, 1])
def test_transforms_on_arrays_match_jax(data, seed):
    """Called on labels whose image is an ndarray, the transforms build it at once, as the JAX package's do:
    letterbox, HSV, both flips and the channel order."""
    import cv2

    _, root = data
    img = cv2.imread(str(sorted((root / "images" / "train").iterdir())[0]))
    boxes = np.array([[0.5, 0.5, 0.3, 0.4], [0.3, 0.6, 0.2, 0.2]], np.float32)

    def labels(instances_cls):
        return {"img": img.copy(), "cls": np.array([[0.0], [1.0]], np.float32),
                "instances": instances_cls(boxes.copy(), bbox_format="xywh", normalized=True)}

    from yololite_tpu.utils.instance import Instances as JaxInstances
    from yololite_tpu_torch.utils.instance import Instances

    random.seed(seed)
    np.random.seed(seed)
    want = jaug.Compose([jaug.LetterBox((160, 160)), jaug.RandomHSV(), jaug.RandomFlip(p=0.5, direction="vertical"),
                         jaug.RandomFlip(p=0.5), jaug.Format()])(labels(JaxInstances))
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    got = taug.Compose([taug.LetterBox((160, 160)), taug.RandomHSV(np_rng), taug.RandomFlip(rng, p=0.5,
                        direction="vertical"), taug.RandomFlip(rng, p=0.5), taug.Format(rng=rng)])(labels(Instances))
    assert isinstance(got["img"], np.ndarray) and got["img"].shape == (160, 160, 3)
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=0, atol=1e-5)


def test_two_gloo_ranks_step_on_their_own_loaders_like_one_process(data, tmp_path):
    """Each of 2 gloo ranks takes the first batch of its own train loader (workers 2: the global batch's labels, its
    4 image rows) and steps: the step equals the one-process step on its loader's batch (workers 0) under
    tests/test_torch_parallel.py's bounds."""
    path, root = data
    ov = _overrides(path, root, "dp_loader", batch=8, nbs=8, workers=0)
    model = DetectionModel(NARROW, nc=3).init(0)
    lr, mom = [0.01, 0.02, 0.03], 0.9
    one = data_parallel_step(0, 1, torch.device("cpu"), ov, model, 1, lr, mom)
    ranks = tmesh.launch(data_parallel_step, ["cpu", "cpu"], "gloo", init_file=tmp_path / "store",
                         args=({**ov, "workers": 2}, model, 1, lr, mom))
    _assert_steps_equal(one, ranks, 1e-4)
    fg = torch.cat([r["fg_mask"][0] for r in ranks])
    assert torch.equal(fg, one["fg_mask"][0]) and fg.any()
