"""A 2-rank data-parallel training run of the port against the JAX trainer's auto-sharded run, on the CPU.

The JAX trainer shards a batch of 8 over conftest's 8 virtual devices; the
port's facade, given device=['cpu', 'cpu'], spawns two gloo ranks of 4 rows
each. Both train the narrow yolo11 of tests/test_torch_train.py for 2 epochs
on 8 synthetic images under tmp_path (no coco8), mosaic on, and each epoch's
mean loss items must agree within rtol 1e-3, as the one-process curve test
there holds them.
"""

import random

import numpy as np
import pytest
import torch

from yololite_tpu.engine import trainer as jtrainer
from yololite_tpu.models.model import DetectionModel as JaxModel

from yololite_tpu_torch import YOLOLite

from tests.test_torch_train import NARROW, _overrides, _write_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_loss_curve_matches_jax_mesh(tmp_path):
    data = _write_dataset(tmp_path / "data", n_train=8, n_val=2, seed=40)
    kw = dict(epochs=2, imgsz=96, batch=8, nbs=16, close_mosaic=0, optimizer="SGD", multi_scale=False)
    # no checkpoints from the JAX trainer: its saver thread fetching the sharded tree while the loop dispatches the
    # next snapshot on the 8 virtual CPU devices can deadlock XLA's CPU client; its loss curve is what is compared
    jt = jtrainer.DetectionTrainer(overrides=_overrides(data, tmp_path, "jax_mesh", save=False, **kw))
    jm = JaxModel(NARROW, nc=3)
    jt.set_model(jm, *jm.init(0))
    random.seed(0)
    jt.train()
    assert jt.mesh is not None

    m = YOLOLite(NARROW, device="cpu")
    m.train(**{k: v for k, v in _overrides(data, tmp_path, "port_ranks", **kw).items() if k != "mode"},
            device=["cpu", "cpu"])
    tt = m.trainer
    assert tt.devices == [torch.device("cpu")] * 2 and len(tt.tlosses) == 2
    rows = [np.loadtxt(t.csv, delimiter=",", skiprows=1, ndmin=2) for t in (jt, tt)]
    assert rows[0].shape == rows[1].shape and rows[1].shape[0] == 2
    np.testing.assert_allclose(rows[1][:, 1:4], rows[0][:, 1:4], rtol=1e-3)
    np.testing.assert_allclose(np.stack(tt.tlosses), rows[1][:, 1:4], rtol=1e-6)
    np.testing.assert_allclose(rows[1][:, -3:], rows[0][:, -3:], rtol=1e-6)  # the lr columns
    assert tt.last.exists()  # rank 0 saved
