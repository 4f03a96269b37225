"""Detection trainer: train step replayed as CUDA graphs, gradient accumulation, EMA, warmup, resume (port of
yololite_tpu/engine/trainer.py).

Each iteration runs the forward in train mode (under bf16 autocast with amp;
the loss then reads the bf16 maps and does its math in fp32), the loss with
TAL assignment, and a backward that accumulates into `.grad`. When
`accumulate` iterations have gathered, the gradients are clipped to a global
norm of 10, the optimizer steps with this iteration's per-group lr and
momentum, the gradients are zeroed and the EMA of the weights and BN
statistics follows.

As the JAX package jits its grad, apply and fused steps, the one-process
trainer on the card replays them as CUDA graphs (engine/graphs.py, one cache
per trainer): a grad graph per (batch shape and dtype, GT bucket M, amp), one
apply graph (clip, optimizer, zeroing, EMA: one call of K10,
csrc/optim_apply.cu), and, when accumulate is 1 for the whole run (JAX's
rule: round(nbs / batch) <= 1), one fused graph per (shape, M, amp) instead
of both. A key's first sight runs eagerly, its second captures, later ones
replay. lr, momentum, the optimizer's step and the EMA's decay are device
scalars written (or advanced on the device) at each step, as the JAX
package traces them, so the warmup ramp replays the same graphs. So that a
graph can read them, every tensor that lives across steps is allocated
outside any capture: the gradients once, as zeros (the backward adds into
them in place, the apply zeroes them in place), the optimizer's state and
K10's table (engine/optim.py), the EMA and its decay scalars, the BN
statistics. Off the card, on ranks (whose gloo all_reduce cannot be
captured) and inside `graphs.eager()`, the same step functions run eagerly.
Each (batch shape, GT bucket) is recorded as the JAX trainer records its jit
variants; past 12, multi-scale coarsens its size grid from /32 to /64.

Each batch reaches the device through a feed (data/build.py `DeviceFeed`,
the counterpart of the JAX trainer's `device_put`): on its thread, in batch
order, multi-scale's resize, the padded targets and the step's variant; the
images arrive in page-locked buffers that the loader's threads wrote, and
the copies run on the card's copy stream while the step before runs.

Checkpoints are the JAX package's native .npz (models/checkpoint.py), so
either package resumes or predicts from the other's last.npz and best.npz.

Data parallelism (device="0,1", a device list, a torchrun launch, or None
with several cards visible and a batch that divides): one rank per device
(parallel/mesh.py `launch`), and each step is the one-device step on the
global batch, as the JAX package's step on a mesh is. Every rank plans the
whole global batch from the seeded dataset (data/dataset.py `DataLoader`:
the same draws, labels and targets, GT bucket M included, on every rank)
and builds only its equal slice of the image rows. The BNs take the global
batch's statistics (models/modules.py `CrossRankBatchNorm2d`), the loss
divides by the global target_scores_sum, and the gradients are summed over
the ranks before the clip, so the optimizer and the EMA stay identical on
every rank. A batch that does not divide runs whole on every rank with
local BN and a 1/world share of the gradient. Rank 0 alone validates,
writes results.csv and saves checkpoints; the others take its fitness and
stop flag by broadcast.
"""

from __future__ import annotations

import copy
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from yololite_tpu_torch.cfg import get_cfg, get_save_dir
from yololite_tpu_torch.data.build import DeviceFeed, PinnedRing
from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
from yololite_tpu_torch.data.utils import check_det_dataset
from yololite_tpu_torch.engine import graphs, optim
from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs
from yololite_tpu_torch.models import checkpoint as ckpt
from yololite_tpu_torch.models.model import DetectionModel
from yololite_tpu_torch.models.modules import cross_rank_bn, cross_rank_bn_
from yololite_tpu_torch.parallel import mesh as pmesh
from yololite_tpu_torch.utils import LOGGER, TQDM, colorstr, get_latest_run, select_device
from yololite_tpu_torch.utils.checks import check_imgsz
from yololite_tpu_torch.utils.ema import ModelEMA
from yololite_tpu_torch.utils.loss import E2EDetectLoss, build_targets, v8DetectionLoss

MAX_TRAIN_GRAPHS = 32  # graphs a trainer's cache holds: (shape, GT bucket) variants, bounded by multi-scale's /64 grid
TARGET_KEYS = ("gt_labels", "gt_bboxes", "mask_gt")


def one_cycle(y1=1.0, y2=0.01, steps=100):
    """Cosine ramp y1 -> y2 over `steps`."""
    return lambda x: max((1 - math.cos(x * math.pi / steps)) / 2, 0) * (y2 - y1) + y1


class EarlyStopping:
    """Stop when fitness has not improved for `patience` epochs (0 or None: never)."""

    def __init__(self, patience: int = 50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")
        self.possible_stop = False

    def __call__(self, epoch: int, fitness: Optional[float]) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        delta = epoch - self.best_epoch
        self.possible_stop = delta >= (self.patience - 1)
        stop = delta >= self.patience
        if stop:
            LOGGER.info(f"Stopping training early as no improvement observed in last {self.patience} epochs. "
                        f"Best results observed at epoch {self.best_epoch}.")
        return stop


class _AsyncSaver:
    """One writer thread for checkpoints, writes in order, at most one in flight.

    Each submit waits for the previous write to finish, so no epoch's save is
    dropped. A write's error is logged at the next submit and raised at flush.
    The function submitted must hold its own host copy of what it writes:
    torch changes parameters and optimizer state in place while the writer runs.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-saver")
        self._last = None
        self._error = None

    def _wait(self):
        if self._last is not None:
            err, self._last = self._last.exception(), None
            if err is not None:
                LOGGER.warning(f"checkpoint save failed: {err!r} (will re-raise at end of training)")
                self._error = self._error or err

    def submit(self, fn):
        self._wait()
        self._last = self._pool.submit(fn)

    def flush(self):
        """Block until the last write is done; re-raise the first write error."""
        self._wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class DetectionTrainer:
    """Trains a DetectionModel on a YOLO dataset on one device (cuda unless told otherwise), or as data-parallel
    ranks on several."""

    def __init__(self, overrides: Optional[Dict] = None, device=None):
        self.args = get_cfg(overrides=overrides)
        self._overrides = dict(overrides or {})
        self._resume_blob = None
        self.check_resume(overrides or {})
        self.batch_size = int(self.args.batch)
        self.rank, self.world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
        self.group = dist.group.WORLD if dist.is_initialized() else None  # set: this process is a data-parallel rank
        dev = self.args.device if device is None else device
        self.devices = [select_device(dev)] if self.group is not None else self._train_devices(dev)
        self.device = self.devices[0]
        self.mesh = None
        self.np_rng = np.random.RandomState(self.args.seed)  # multi-scale draws: the feed's thread, in batch order
        self._set_save_dir(get_save_dir(self.args))
        self.epochs = int(self.args.epochs or 100)
        self.start_epoch = 0
        self.epoch = 0
        self.data = check_det_dataset(self.args.data)
        self.model: Optional[DetectionModel] = None
        self.ema: Optional[ModelEMA] = None
        self.best_fitness = None
        self.fitness = None
        self.metrics = None
        self.stop_training = False
        self.loss_names = ["box_loss", "cls_loss", "dfl_loss"]
        self.max_gt = 0
        self.train_seconds = []  # per epoch: the batch loop alone, without val and saving
        self.tlosses = []  # per epoch: the mean loss items, as results.csv has them
        self.fg_mask = None  # the last step's assigner foreground mask (this rank's rows)
        self._grads_summed = False
        self._saver = _AsyncSaver()
        self._step_shapes = set()  # (batch shape, GT bucket) variants of the step, as the JAX trainer records them
        self._ms_quant = 32  # multi-scale size grid; 64 once more than 12 variants were seen
        self.graphs = graphs.GraphCache(MAX_TRAIN_GRAPHS)  # the train steps' CUDA graphs (one process on the card)
        self._ring = PinnedRing(self.device)  # the feed's host buffers, kept across the epochs
        self.last_feed: Optional[DeviceFeed] = None  # the last epoch's feed, with its counters

    def _set_save_dir(self, save_dir):
        self.save_dir = Path(save_dir)
        self.args.save_dir = str(self.save_dir)  # checkpoints carry it, so a resumed run reuses the directory
        self.wdir = self.save_dir / "weights"
        self.csv = self.save_dir / "results.csv"
        self.last, self.best = self.wdir / "last.npz", self.wdir / "best.npz"

    def _train_devices(self, dev):
        """The devices to train on: several from a list or a comma string (batch rules apply), every visible card
        for None when there are several and the batch divides, else one; under torchrun, this rank's card."""
        if pmesh.torchrun_env():
            return [select_device(f"cuda:{os.environ['LOCAL_RANK']}" if dev in (None, "") else dev)]
        if isinstance(dev, (list, tuple)) or (isinstance(dev, str) and "," in dev):
            return [select_device(d) for d in pmesh.select_device(dev, batch=self.batch_size)]
        if dev in (None, "") and torch.cuda.is_available():
            n = torch.cuda.device_count()
            if n > 1 and self.batch_size % n == 0:
                LOGGER.info(f"data-parallel over {n} cards")
                return [torch.device("cuda", i) for i in range(n)]
        return [select_device(dev)]

    # ---- model plumbing ----

    def set_model(self, model: DetectionModel):
        """Train a copy of `model` (the caller's stays as it is)."""
        self.model = copy.deepcopy(model)

    def get_model(self):
        if self.model is None:
            cfg = self.args.model or "yolo11n.yaml"
            if self._resume_blob is not None:  # the resumed checkpoint's own spec
                cfg = self._resume_blob[2].get("cfg", cfg)
            if str(cfg).endswith(".pt"):  # the checkpoint's weights, the class head by intersect transfer
                from yololite_tpu_torch.models.checkpoint import load_pt

                self.model, _ = load_pt(cfg, nc=self.data["nc"])
            else:
                self.model = DetectionModel(cfg, nc=self.data["nc"]).init(self.args.seed)
        if self.model.nc != self.data["nc"]:
            # a new head for the dataset's class count, from the model's own spec; the other rows keep their weights
            model2 = DetectionModel(dict(self.model.yaml), nc=self.data["nc"]).init(self.args.seed)
            head = f"model.{len(model2.model) - 1}."
            sd2 = model2.state_dict()
            sd2.update({k: v for k, v in self.model.state_dict().items() if not k.startswith(head)})
            model2.load_state_dict(sd2)
            self.model = model2
        self.model.names = self.data["names"]
        self.model.to(self.device)
        if self.group is not None:  # the BNs take the global batch's statistics; all start from rank 0's weights
            cross_rank_bn_(self.model)
            self.mesh = pmesh.make_mesh(devices=[self.device], group=self.group)
            pmesh.replicate_tree(self.mesh, self.model)

    # ---- setup ----

    def _setup_train(self):
        self.get_model()
        self.imgsz = check_imgsz(self.args.imgsz, stride=32, min_dim=1)
        self.args.imgsz = self.imgsz

        train_ds = build_yolo_dataset(copy.copy(self.args), self.data["train"], self.batch_size, self.data,
                                      mode="train")
        # any number of workers gives the same batches; a rank plans the global batch and builds its image rows
        self.train_loader = build_dataloader(train_ds, self.batch_size, self.args.workers, shuffle=True,
                                             seed=self.args.seed, rank=self.rank, world=self.world)
        if self.args.val and self.data.get("val") and self.rank == 0:
            from yololite_tpu_torch.engine.validator import DetectionValidator

            vargs = {k: v for k, v in vars(self.args).items() if not isinstance(v, Path)}
            vargs.update({"mode": "val", "rect": True, "conf": 0.001, "plots": False, "verbose": False,
                          "save_json": False})
            self.validator = DetectionValidator(save_dir=self.save_dir, args=vargs, device=self.device)
        else:
            self.validator = None

        # GT padding: the dataset's most instances per image, with headroom for mosaic
        max_inst = max((len(lb["cls"]) for lb in train_ds.labels), default=1)
        self.max_gt = min(max(16, int(4.4 * max_inst) + 8), 256)

        self.accumulate = max(round(self.args.nbs / self.batch_size), 1)
        self.weight_decay = self.args.weight_decay * self.batch_size * self.accumulate / self.args.nbs
        iterations = math.ceil(len(train_ds) / max(self.batch_size, self.args.nbs)) * self.epochs
        self.opt_name, self.lr0, self.momentum = self._resolve_optimizer(iterations)
        self._freeze()
        self.optimizer = optim.build_optimizer(self.opt_name, self.model, self.lr0, self.momentum, self.weight_decay)
        self._params = self.optimizer.params
        for p in self._params:  # allocated once, outside any capture: the backward adds in place, apply zeroes
            p.grad = torch.zeros_like(p)
        self._grads = [p.grad for p in self._params]
        self.ema = ModelEMA(self.model)
        # JAX's rule: a fused step (grad, clip, optimizer, EMA in one graph) when accumulate is 1 for the whole run
        self.fused = self.group is None and max(round(self.args.nbs / self.batch_size), 1) == 1

        if self.args.cos_lr:
            self.lf = one_cycle(1, self.args.lrf, self.epochs)
        else:
            self.lf = lambda x: max(1 - x / self.epochs, 0) * (1.0 - self.args.lrf) + self.args.lrf
        self.stopper = EarlyStopping(patience=self.args.patience)

        m = self.model
        loss_cls = E2EDetectLoss if getattr(m.detect, "end2end", False) else v8DetectionLoss
        self.loss_fn = loss_cls(m.nc, m.strides, m.reg_max, hyp=self.args)
        if self._resume_blob is not None:
            self.resume_training(self._resume_blob)
        self.optimizer.track(self.model, self.ema)  # K10's table, after the resume's in-place loads

    def _check_table(self):
        """Rebuild K10's table, and drop the train graphs that read the old one, if a tensor it tracks was
        replaced."""
        if self.optimizer.stale():
            self.optimizer.track(self.model, self.ema)
            self.graphs.clear()

    def _resolve_optimizer(self, iterations):
        """'auto' -> AdamW (lr fitted to nc, no bias warmup) for short runs, SGD(0.01, 0.9) past 10,000 iterations."""
        name = self.args.optimizer
        lr, momentum = self.args.lr0, self.args.momentum
        if name == "auto":
            nc = self.data["nc"]
            lr_fit = round(0.002 * 5 / (4 + nc), 6)
            name, lr, momentum = ("SGD", 0.01, 0.9) if iterations > 10000 else ("AdamW", lr_fit, 0.9)
            self.args.warmup_bias_lr = 0.0
            LOGGER.info(f"optimizer: auto -> {name}(lr={lr}, momentum={momentum})")
        canonical = {x.lower(): x for x in optim.OPTIMIZERS}.get(str(name).lower())
        if canonical is None:
            raise NotImplementedError(f"optimizer '{self.args.optimizer}' not supported; choose one of "
                                      f"{optim.OPTIMIZERS}")
        return canonical, lr, momentum

    def _freeze(self):
        """Freeze the first `freeze` rows (an int) or the listed rows: no gradient, no update, no decay."""
        freeze = self.args.freeze
        if isinstance(freeze, int):
            rows = set(range(freeze))
        elif isinstance(freeze, (list, tuple)):
            rows = {int(x) for x in freeze}
        else:
            rows = set()
        for name, p in self.model.named_parameters():
            p.requires_grad_(int(name.split(".")[1]) not in rows)

    # ---- one iteration ----

    def _forward(self, images: torch.Tensor):
        """uint8 NHWC batch on the device -> the Detect maps, NHWC, in train mode (bf16 under amp)."""
        x = images.float() * (1.0 / 255.0) if images.dtype == torch.uint8 else images
        if x.device.type == "cpu" or not self.args.amp:
            # with amp off the batch is NCHW-contiguous, so every map is NCHW: one layout wherever the fp32 step is
            # held to a float64 step, in one process and on ranks. torch's CPU BatchNorm takes channels-last
            # train-mode statistics with about 10x the error of its NCHW kernel. On the card the layout does not set
            # the step's precision: on three seeds every layout and the ranks lie 1.8e-4 to 2.2e-4 relative L2 from
            # the float64 step once SPPF's max-pools take the float64 step's picks; unforced, a near-tie there that
            # the last bits of row 8 flip can move row 8's BN gradients to 5.6e-3 (NVIDIA H100 80GB HBM3, 700 W;
            # tools/train_step_precision.py --force-picks)
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        # no cast cache: a capture's cached bf16 weights would live in the graph pool past the capture
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bool(self.args.amp), cache_enabled=False):
            return forward_nhwc(self.model, x)

    def _host_targets(self, batch) -> Dict[str, np.ndarray]:
        """The global batch's GTs padded to the next power of two of its most boxes per image (>= 16, <= max_gt); a
        rank's loader batch holds the global batch's labels and its own image rows (`img_rows`)."""
        n = batch["img_rows"][2] if "img_rows" in batch else batch["img"].shape[0]
        counts = np.bincount(np.asarray(batch["batch_idx"]).astype(int), minlength=n)
        need = max(16, int(counts.max(initial=16)))
        m_bucket = min(self.max_gt, 1 << (need - 1).bit_length())
        return build_targets(batch, n, batch["img"].shape[1:3], m_bucket)

    def _targets(self, batch) -> Dict[str, torch.Tensor]:
        """`_host_targets` on the device, for a step taken by hand (tests, measurements); the training loop's
        targets go through the feed with its images."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in self._host_targets(batch).items()}

    def _stage(self, batch, take):
        """A loader batch -> the arrays the step reads, on the feed's thread in batch order (`DeviceFeed`'s
        `prepare`): multi-scale's resize and draw, this process' image rows, the padded targets; the step's variant
        is recorded here, so that multi-scale's grid coarsens before the next batch's draw, as it did when each
        batch was prepared on the loop's thread."""
        batch = self.preprocess_batch(batch)
        targets = self._host_targets(batch)
        images = batch["img"] if "img_rows" in batch else batch["img"][self._rows(len(batch["img"]))]
        self._track_compiles(images.shape, targets["gt_bboxes"].shape[1])
        return {"img": images, **targets}, None

    def feed(self, batches) -> DeviceFeed:
        """The feed of host batches (the train loader, or any iterable of loader-like batches) to this trainer's
        device: yields ({"img": this process' uint8 NHWC rows, "gt_labels", "gt_bboxes", "mask_gt"}, None)."""
        return DeviceFeed(batches, self.device, self._stage, ring=self._ring)

    def _step_key(self, kind: str, images: Optional[torch.Tensor], targets: Optional[Dict]) -> tuple:
        """The graph key of a train step: its kind ("grad", "apply" or "fused"), the batch's device, and its shape and
        dtype, the GT bucket M and amp (grad and fused). lr and momentum are device scalars: no key holds them."""
        key = (kind, str(self.device))
        if images is not None:
            key += (tuple(images.shape), images.dtype, targets["gt_bboxes"].shape[1], bool(self.args.amp))
        return key

    def _grad_fn(self, images, gt_labels, gt_bboxes, mask_gt):
        """Forward, loss and backward of one process; the gradients add into the static `.grad` in place. Returns
        the detached loss items and the assigner's fg_mask."""
        targets = {"gt_labels": gt_labels, "gt_bboxes": gt_bboxes, "mask_gt": mask_gt}
        with fp32_convs(self.device):
            total, items, fg_mask = self.loss_fn.forward(self._forward(images), targets)
            total.backward()
        return items, fg_mask

    def _apply_fn(self):
        """Clip the gradients to norm 10, step the optimizer, zero the gradients in place, update the EMA at the
        decay written before (`ModelEMA.advance`): JAX's apply_step, one K10 call on the card. No host sync."""
        self.optimizer.apply(self.ema.d, self.ema.one_minus_d)

    def _fused_fn(self, images, gt_labels, gt_bboxes, mask_gt):
        out = self._grad_fn(images, gt_labels, gt_bboxes, mask_gt)
        self._apply_fn()
        return out

    def _step_scalars(self, lr_vec, momentum: float):
        """Write the apply's lr, momentum and EMA decay (device tensors, in place) before it runs or replays."""
        self.optimizer.set_lr_momentum(lr_vec, momentum)
        self.ema.advance()

    def _captured(self, captures: int):
        """After a capture on the card: no tensor that lives across steps may lie in the graph pool."""
        if self.graphs.captures == captures or self.device.type != "cuda":
            return
        lives = [*self.model.state_dict().values(), *self._grads, *self.optimizer.state_tensors(),
                 *self.ema.ema.state_dict().values(), self.ema.d, self.ema.one_minus_d]
        bad = graphs.in_pool(lives)
        if bad:
            raise RuntimeError(f"{len(bad)} tensors that live across train steps lie in the CUDA graph pool "
                               f"(first: {tuple(bad[0].shape)} {bad[0].dtype}): a later capture would overwrite them")

    def _graphed(self, fn, inputs, key):
        captures = self.graphs.captures
        out = self.graphs.step(fn, inputs, key, self.device)
        self._captured(captures)
        return out

    def _grad_step(self, images: torch.Tensor, targets: Dict[str, torch.Tensor]):
        """Forward, loss and backward on the global batch; gradients add into `.grad`. Returns the detached loss
        items of the global batch.

        In one process this is the grad graph of the batch's key (engine/graphs.py; eager at its first sight and
        off the card). On ranks, `images` are this rank's rows already (`_rows`, the loader's) and the targets the
        global batch's: a batch that divides takes its rows of the targets, and its BN statistics and loss
        normalization are global; one that does not runs whole here with a 1/world share of the loss.
        """
        if self.group is None:
            inputs = (images, targets["gt_labels"], targets["gt_bboxes"], targets["mask_gt"])
            items, self.fg_mask = self._graphed(self._grad_fn, inputs, self._step_key("grad", images, targets))
            return items
        n = targets["gt_bboxes"].shape[0]
        rows = self._rows(n)
        if images.shape[0] != rows.stop - rows.start:
            raise ValueError(f"rank {self.rank}: {images.shape[0]} image rows for rows {rows.start}-{rows.stop} of "
                             f"the global batch of {n}")
        group = None
        if n % self.world == 0:
            targets = {k: v[rows] for k, v in targets.items()}
            group = self.group
        with fp32_convs(self.device), cross_rank_bn(group):
            total, items, self.fg_mask = self.loss_fn.forward(self._forward(images), targets, group)
            (total if group is not None else total / self.world).backward()
        if group is not None:
            dist.all_reduce(items, group=group)
        return items

    def _rows(self, n: int) -> slice:
        """This process' rows of a global batch of n: its shard on ranks when n divides them, else all."""
        if self.group is None or n % self.world:
            return slice(0, n)
        return pmesh.batch_sharding(self.mesh, n)[0][1]

    def _sum_grads(self):
        """On ranks: sum the gradients gathered since the last step over the ranks (once per step), in place."""
        if self.group is None or self._grads_summed:
            return
        flat = torch.cat([g.reshape(-1) for g in self._grads])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for g in self._grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        self._grads_summed = True

    def _apply_step(self, lr_vec, momentum: float):
        """Clip the summed gradients to norm 10, step the optimizer, zero the gradients, update the EMA: the one
        apply graph in one process, eagerly on ranks."""
        self._sum_grads()
        self._step_scalars(lr_vec, momentum)
        if self.group is None:
            self._graphed(self._apply_fn, (), self._step_key("apply", None, None))
        else:
            self._apply_fn()
        self._grads_summed = False

    def _fused_step(self, images: torch.Tensor, targets: Dict[str, torch.Tensor], lr_vec, momentum: float):
        """`_grad_step` then `_apply_step` as one graph (one process, accumulate 1 for the whole run)."""
        self._step_scalars(lr_vec, momentum)
        inputs = (images, targets["gt_labels"], targets["gt_bboxes"], targets["mask_gt"])
        items, self.fg_mask = self._graphed(self._fused_fn, inputs, self._step_key("fused", images, targets))
        return items

    def _schedule(self, ni: int, nw: int, epoch: int):
        """Iteration ni's accumulate, per-group lr vector and momentum: the warmup ramp up to nw, then the epoch's."""
        if ni <= nw:  # warmup: accumulate, lr and momentum ramp in
            xi = [0, nw]
            accumulate = max(1, int(np.interp(ni, xi, [1, self.args.nbs / self.batch_size]).round()))
            lr_vec = np.array([
                np.interp(ni, xi, [self.args.warmup_bias_lr, self.lr0 * self.lf(epoch)]),  # biases
                np.interp(ni, xi, [0.0, self.lr0 * self.lf(epoch)]),  # weights
                np.interp(ni, xi, [0.0, self.lr0 * self.lf(epoch)]),  # bn
            ], np.float32)
            return accumulate, lr_vec, float(np.interp(ni, xi, [self.args.warmup_momentum, self.momentum]))
        lr = self.lr0 * self.lf(epoch)
        return self.accumulate, np.array([lr, lr, lr], np.float32), self.momentum

    def _train_batch(self, staged: Dict[str, torch.Tensor], apply: bool, lr_vec, momentum: float):
        """One iteration on a batch from the feed (`feed`): the grad step, and the apply step if `apply` (one fused
        step where the run is fused). Returns the loss items on the device."""
        images, targets = staged["img"], {k: staged[k] for k in TARGET_KEYS}
        if self.fused:
            return self._fused_step(images, targets, lr_vec, momentum)
        items = self._grad_step(images, targets)
        if apply:
            self._apply_step(lr_vec, momentum)
        return items

    # ---- main loop ----

    def train(self):
        if self.group is None and (len(self.devices) > 1 or pmesh.torchrun_env()):
            return self._train_ranks()
        self._setup_train()
        nb = len(self.train_loader)
        nw = max(round(self.args.warmup_epochs * nb), 100) if self.args.warmup_epochs > 0 else -1
        LOGGER.info(f"Image sizes {self.imgsz} train, {self.imgsz} val\n"
                    f"Using {self.args.workers} dataloader workers on {self.device}\n"
                    f"Logging results to {colorstr('bold', self.save_dir)}\n"
                    f"Starting training for {self.epochs} epochs...")
        self.wdir.mkdir(parents=True, exist_ok=True)
        train_time_start = time.time()
        try:
            self._train_epochs(nb, nw, train_time_start)
        finally:
            # drain the checkpoint writer even when the loop raises, but never let a
            # saver error replace the exception in flight
            try:
                self._saver.flush()
            except Exception as save_err:
                if sys.exc_info()[0] is None:
                    raise
                LOGGER.warning(f"checkpoint saver error during shutdown: {save_err!r}")
        LOGGER.info(f"\n{self.epochs - self.start_epoch} epochs completed in "
                    f"{(time.time() - train_time_start) / 3600:.3f} hours.")
        if self.rank == 0:
            self.final_eval()
        return self.metrics

    def _train_ranks(self):
        """Train as one rank per device (spawned, or this process under torchrun); keep rank 0's outcome."""
        overrides = {k: v for k, v in self._overrides.items() if k != "device"}
        model = copy.deepcopy(self.model).cpu() if self.model is not None else None
        out = pmesh.launch(_train_rank, self.devices, args=(overrides, str(self.save_dir), model))[0]
        if out is None:  # this process is a torchrun rank other than 0
            return None
        for k, v in out.items():
            setattr(self, k, v)
        return self.metrics

    def _share_epoch_end(self):
        """Ranks: everyone takes rank 0's fitness (NaN: none) and stop flag."""
        flag = torch.tensor([np.nan if self.fitness is None else float(self.fitness), float(self.stop_training)],
                            dtype=torch.float64, device=self.device)
        dist.broadcast(flag, src=0, group=self.group)
        fitness, stop = flag.tolist()
        if self.rank != 0:
            self.fitness = None if math.isnan(fitness) else fitness
            if self.fitness is not None and (self.best_fitness is None or self.fitness > self.best_fitness):
                self.best_fitness = self.fitness
            self.stop_training = bool(stop)

    def _train_epochs(self, nb, nw, train_time_start):
        last_opt_step = -1
        epoch = self.start_epoch
        while epoch < self.epochs:
            self.epoch = epoch
            self._check_table()
            if epoch == (self.epochs - self.args.close_mosaic) and self.args.close_mosaic:
                LOGGER.info("Closing dataloader mosaic")
                self.train_loader.dataset.close_mosaic(hyp=copy.copy(self.args))
            self.model.train()
            tloss = None
            t0 = time.perf_counter()
            feed = self.last_feed = self.feed(self.train_loader)
            pbar = TQDM(enumerate(feed), total=nb, desc=f"epoch {epoch + 1}/{self.epochs}")
            try:
                for i, (staged, _) in pbar:
                    ni = i + nb * epoch
                    self.accumulate, lr_vec, momentum = self._schedule(ni, nw, epoch)
                    apply = self.fused or ni - last_opt_step >= self.accumulate
                    items = self._train_batch(staged, apply, lr_vec, momentum)
                    if apply:
                        last_opt_step = ni
                    # the running mean stays on the device: reading it here would sync every step
                    tloss = items if tloss is None else (tloss * i + items) / (i + 1)
                    if i % max(nb // 4, 1) == 0:
                        t = tloss.tolist()
                        pbar.set_description(f"epoch {epoch + 1}/{self.epochs} box {t[0]:.3f} cls {t[1]:.3f} "
                                             f"dfl {t[2]:.3f}")
            finally:
                feed.close()
            tloss = tloss.cpu().numpy() if tloss is not None else None  # waits for the epoch's last step
            self.train_seconds.append(time.perf_counter() - t0)
            self.tlosses.append(tloss)
            self.lr = {f"lr/pg{j}": float(lr_vec[j]) for j in range(3)}

            final_epoch = epoch + 1 >= self.epochs
            self.fitness = None
            if self.validator is not None and (self.args.val or final_epoch):
                self.metrics = self.validate()
            self.stop_training = self.stopper(epoch, self.fitness)
            if self.args.time:
                self.stop_training |= (time.time() - train_time_start) > self.args.time * 3600
            if self.group is not None:
                self._share_epoch_end()
            if self.rank == 0:
                self.save_metrics(epoch, tloss)
                g = self.graphs
                LOGGER.info(f"train-step variants so far: {len(self._step_shapes)} (batch-shape x GT-bucket keys); "
                            f"graphs {len(g)} held, {g.captures} captured, {g.replays} of {g.calls} steps on the "
                            f"card replayed")
                if self.args.save:
                    self.save_model(epoch)
            if self.stop_training:
                break
            epoch += 1

    # ---- hooks ----

    def preprocess_batch(self, batch):
        """Multi-scale: resize the batch on the host to a random size in [0.5, 1.5] x imgsz, on the `_ms_quant` grid
        (/32, coarsened to /64 once the step has more than 12 variants: each size is a graph of its own)."""
        if self.args.multi_scale:
            import cv2

            q = self._ms_quant
            imgsz = self.imgsz if isinstance(self.imgsz, int) else self.imgsz[0]
            sz = max((self.np_rng.randint(int(imgsz * 0.5), int(imgsz * 1.5 + 32)) // q) * q, q)
            if sz != batch["img"].shape[1]:
                batch["img"] = np.stack([cv2.resize(im, (sz, sz), interpolation=cv2.INTER_LINEAR)
                                         for im in batch["img"]])
        return batch

    def _track_compiles(self, images_shape, m_bucket):
        """Record the step's (batch shape, GT bucket) variant; coarsen multi-scale to /64 past 12 variants (the JAX
        trainer's rule for its jit cache, here the bound on the train graphs)."""
        self._step_shapes.add((*images_shape, m_bucket))
        n = len(self._step_shapes)
        if self.args.multi_scale and n > 12 and self._ms_quant < 64:
            self._ms_quant = 64
            LOGGER.warning(f"multi-scale training compiled {n} step variants; coarsening the size grid from /32 to "
                           f"/64 to bound the train graphs")

    def validate(self):
        v = self.validator
        v.args.plots = False
        stats = v(trainer=self)
        fitness = stats.get("fitness", -np.inf)
        self.fitness = fitness
        if self.best_fitness is None or fitness > self.best_fitness:
            self.best_fitness = fitness
        return stats

    # ---- persistence ----

    def _train_meta(self, epoch):
        return {
            "epoch": epoch,
            "best_fitness": float(self.best_fitness) if self.best_fitness is not None else None,
            "ema_updates": self.ema.updates,
            "cfg": dict(self.model.yaml),  # the whole spec, so a custom architecture reloads as itself
            "nc": self.model.nc,
            "names": self.model.names,
            "args": {k: v for k, v in vars(self.args).items() if not isinstance(v, Path)},
            "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }

    def _named_trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters() if p.requires_grad}

    def save_model(self, epoch):
        """Save last (and best, and periodic) checkpoints: EMA weights plus what resume needs.

        Everything is copied to the host here; the writer thread only writes.
        """
        meta = self._train_meta(epoch)
        ema_params, ema_state = ckpt.jax_trees(self.ema.ema)
        raw_params, raw_state = ckpt.jax_trees(self.model)
        named = dict(self.model.named_parameters())
        mu, nu = optim.moments(self.opt_name, self.optimizer, named)
        state = {"model_state": ema_state, "raw_params": raw_params, "raw_state": raw_state,
                 "opt": {"mu": ckpt.tree_of(self.model, mu), "nu": ckpt.tree_of(self.model, nu)}}
        is_best = self.best_fitness is not None and self.fitness is not None and self.best_fitness == self.fitness
        periodic = self.args.save_period > 0 and epoch % self.args.save_period == 0

        def _write():
            ckpt.save_native(self.last, ema_params, state, meta)
            if is_best:
                ckpt.save_native(self.best, ema_params, state, meta)
            if periodic:
                ckpt.save_native(self.wdir / f"epoch{epoch}.npz", ema_params, state, meta)

        self._saver.submit(_write)

    def save_metrics(self, epoch, tloss):
        """Append one row to results.csv; the columns are fixed at the first write (a resume adopts the file's)."""
        metrics = dict(self.metrics or {})
        if not hasattr(self, "_csv_keys"):
            if self.csv.exists():
                self._csv_keys = self.csv.read_text(encoding="utf-8").splitlines()[0].split(",")
            else:
                metric_keys = list(metrics.keys()) or (
                    list(self.validator.metrics.keys) + ["fitness"] if self.validator is not None else [])
                self._csv_keys = ["epoch", *self.loss_names, *metric_keys, "lr/pg0", "lr/pg1", "lr/pg2"]
        row = dict(zip(self.loss_names, [float(x) for x in (tloss if tloss is not None else [0, 0, 0])]))
        row["epoch"] = epoch + 1
        row.update({k: float(v) for k, v in metrics.items()})
        row.update({f"lr/pg{j}": self.lr.get(f"lr/pg{j}", 0.0) for j in range(3)})
        header = "" if self.csv.exists() else ",".join(self._csv_keys) + "\n"
        with open(self.csv, "a", encoding="utf-8") as f:
            f.write(header + ",".join(f"{row.get(k, 0.0)}" for k in self._csv_keys) + "\n")

    def final_eval(self):
        """Validate the best checkpoint's EMA weights, standalone (fused), with plots as args say."""
        if self.best.exists() and self.validator is not None:
            params, state, _ = ckpt.load_native(self.best)
            ckpt.load_jax_trees(self.ema.ema, params, state["model_state"])
            LOGGER.info(f"\nValidating {self.best}...")
            self.validator.args.plots = self.args.plots
            self.metrics = self.validator(model=self.ema.ema)

    # ---- resume ----

    def check_resume(self, overrides):
        """With resume, take the args of the checkpoint (imgsz, batch, device, close_mosaic may be overridden)."""
        resume = self.args.resume
        if not resume:
            return
        last = Path(resume) if isinstance(resume, (str, Path)) and Path(str(resume)).exists() else None
        if last is None or last.suffix != ".npz":
            last = get_latest_run()
            if not last:
                raise FileNotFoundError("resume requested but no last.npz found")
        params, state, meta = ckpt.load_native(last)
        args = meta.get("args", {})
        args["resume"] = True
        for k in ("imgsz", "batch", "device", "close_mosaic"):
            if k in overrides:
                args[k] = overrides[k]
        self.args = get_cfg(overrides=dict(args))
        if args.get("save_dir"):  # get_cfg drops keys outside the schema; reuse the run directory
            self.args.save_dir = args["save_dir"]
        self._resume_blob = (params, state, meta)

    def resume_training(self, blob):
        """Restore the EMA, the raw weights and BN statistics, the optimizer's moments and the epoch."""
        params, state, meta = blob
        self.ema.updates = int(meta.get("ema_updates", 0))
        ckpt.load_jax_trees(self.ema.ema, params, state["model_state"])
        ckpt.load_jax_trees(self.model, state["raw_params"], state["raw_state"])
        named = self._named_trainable()
        mu = ckpt.tensors_of(self.model, state["opt"]["mu"], named)
        nu = ckpt.tensors_of(self.model, state["opt"]["nu"], named)
        optim.load_moments(self.opt_name, self.optimizer, named, mu, nu, self.ema.updates, self.momentum)
        self.best_fitness = meta.get("best_fitness")
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        if self.start_epoch >= self.epochs - self.args.close_mosaic:
            self.train_loader.dataset.close_mosaic(hyp=copy.copy(self.args))
        LOGGER.info(f"Resuming training from epoch {self.start_epoch}")
        self._resume_blob = None


def _train_rank(rank: int, world: int, device: torch.device, overrides: Dict, save_dir: str, model):
    """One rank of a data-parallel run (spawned by `DetectionTrainer._train_ranks`): rank 0 returns its outcome."""
    if rank != 0:
        LOGGER.setLevel("WARNING")
    tr = DetectionTrainer(overrides=overrides, device=device)
    tr._set_save_dir(save_dir)
    if model is not None:
        tr.set_model(model)
    tr.train()
    if rank != 0:
        return None
    from yololite_tpu_torch.ops.kernels import COUNTED, select_decode

    return {"metrics": tr.metrics, "fitness": tr.fitness, "best_fitness": tr.best_fitness, "epoch": tr.epoch,
            "train_seconds": tr.train_seconds, "tlosses": tr.tlosses, "start_epoch": tr.start_epoch,
            # this process' kernel launches (its EMA vals' and final val's NMS), which the caller's counters do not see,
            # and K3's by route
            "rank_kernel_launches": {w.__name__: w.launches for w in COUNTED},
            "rank_select_routes": select_decode.by_route.as_dict(),
            # how its batches reached its device: through the feed, from page-locked buffers on a card
            "rank_feed": {"batches": tr.last_feed.upload.batches if tr.last_feed else 0, "pinned": tr._ring.pinned,
                          "pinned_bytes": tr._ring.bytes}}


def data_parallel_step(rank: int, world: int, device, overrides: Dict, model: DetectionModel, batches,
                       lr_vec, momentum: float, timed_steps: int = 0) -> Dict:
    """One optimizer step of a trainer (on `world` ranks, or alone for world 1) on given global batches.

    Each batch is a one-process loader batch dict (uint8 NHWC "img" with its
    ragged labels); each rank takes its rows of the images, as its loader
    builds them (`DetectionTrainer._rows`), and the global batch's targets.
    An int `batches` takes that many batches of the trainer's own loader
    instead (on ranks, each builds its own rows). The step accumulates
    them, sums the gradients over the ranks,
    clips, steps and updates the EMA, as the training loop does. Returns,
    on the host, each batch's loss items and this rank's fg_mask rows, the
    summed gradients, and the weights and buffers before and after, with the
    EMA's after. Used to hold the ranks' step to the one-process step. With
    timed_steps, one untimed and that many more whole steps on the same
    batches follow, and the timed ones' mean wall time and that of their
    gradient sums are returned (seconds; the card is synchronized around
    each; in one process on the card the untimed step captures the graphs
    that the timed ones replay).
    """
    tr = DetectionTrainer(overrides=overrides, device=device)
    tr.set_model(model)
    tr._setup_train()
    host = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    lr_vec = np.asarray(lr_vec, np.float32)
    sync = torch.cuda.synchronize if tr.device.type == "cuda" else (lambda: None)
    before = host(tr.model.state_dict())
    items, fg = [], []
    if isinstance(batches, int):
        it = iter(tr.train_loader)
        batches = [next(it) for _ in range(batches)]
        it.close()

    def grad_steps():  # this rank's image rows (its own loader built only those) and the global targets, fed
        for staged, _ in tr.feed(batches):
            yield tr._grad_step(staged["img"], {k: staged[k] for k in TARGET_KEYS})

    for step_items in grad_steps():
        items.append(step_items.cpu())
        fg.append(tr.fg_mask.cpu())
    tr._sum_grads()
    grads = host({n: p.grad for n, p in tr.model.named_parameters() if p.grad is not None})
    tr._apply_step(lr_vec, float(momentum))
    out = {"items": items, "fg_mask": fg, "grads": grads, "before": before, "after": host(tr.model.state_dict()),
           "ema": host(tr.ema.ema.state_dict())}
    step_s, sum_s = [], []
    for rep in range(timed_steps + 1 if timed_steps else 0):  # the first untimed: in one process it captures
        sync()
        t0 = time.perf_counter()
        for _ in grad_steps():
            pass
        sync()
        t1 = time.perf_counter()
        tr._sum_grads()
        sync()
        t2 = time.perf_counter()
        tr._apply_step(lr_vec, float(momentum))
        sync()
        if rep:
            sum_s.append(t2 - t1)
            step_s.append(time.perf_counter() - t0)
    if timed_steps:
        out.update(step_s=float(np.mean(step_s)), sum_grads_s=float(np.mean(sum_s)))
    return out
