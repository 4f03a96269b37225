"""Detection validator: device inference + host mAP accounting (port of yololite_tpu/engine/validator.py).

Per batch, the collated uint8 NHWC batch goes to the device as it is,
through a feed (data/build.py `DeviceFeed`: the loader's threads write the
batch into a page-locked buffer, and its copy runs on the card's copy
stream while the batch before is inferred), and is cast and divided by 255
on the device. The fused (and, with half, bf16) net runs,
and the Detect maps go through the multi-label select-first NMS at
K = 8192, scored in fp32 (`ops.nms.nms_from_feats`: on the card K3 reads
the maps where they lie, bf16 ones upcast as read, then the
blocked_nms_finalize kernel K4, one launch each per batch, no host sync).
Val replays the whole step (cast, forward, NMS) as a CUDA graph for each
batch shape seen before: a shape's first batch runs eagerly, its second
captures it (engine/graphs.py). Standalone val keeps its graphs for the
validator's life; a trainer's val keeps one cache across the epochs, on a
net whose weights move in place (the EMA module itself in fp32; in half
precision one bf16 copy, into which each epoch copies the EMA's weights), so
a bucket shape seen once an epoch replays from the third epoch. The padded
(B, max_det, 6) result comes to the host. There, per-image TP matching
(greedy IoU-sorted unique matching at 10 IoU thresholds) and the metrics run
in numpy.

Rect batching gives each batch its own shape: one graph per bucket shape
that holds two batches or more, the tail batch (not padded) among them. Standalone val runs a fused copy of
the model, built once per validator. A trainer's val (`trainer=`) runs the
trainer's EMA model as it stands at that call: unfused, in eval mode, with
the EMA's BN statistics.

Given several devices, standalone val holds one replica of the fused net per
device and splits each batch that divides over them (parallel/mesh.py); each
shard runs its forward and NMS on its own device, and the detections are
gathered in order on the first device. A batch that does not divide runs
whole there. A trainer's val runs on the trainer's device (rank 0's, when it has ranks).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from yololite_tpu_torch.cfg import get_cfg, get_save_dir
from yololite_tpu_torch.data.build import DeviceFeed, PinnedRing
from yololite_tpu_torch.data.dataset import build_dataloader, build_yolo_dataset
from yololite_tpu_torch.data.utils import check_det_dataset
from yololite_tpu_torch.engine.graphs import GraphCache
from yololite_tpu_torch.engine.predictor import forward_nhwc, fp32_convs, inference_net, run_sharded
from yololite_tpu_torch.ops.boxes import box_iou_np, scale_boxes_np, xywh2xyxy
from yololite_tpu_torch.ops.decode import postprocess_end2end
from yololite_tpu_torch.ops.nms import nms_from_feats
from yololite_tpu_torch.parallel.mesh import make_mesh, replicate_tree, resolve_devices
from yololite_tpu_torch.utils import LOGGER, TQDM
from yololite_tpu_torch.utils.checks import check_imgsz
from yololite_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics
from yololite_tpu_torch.utils.profile import Profile

VAL_MAX_CAND = 8192  # the multi-label candidate pool of the JAX validator


class DetectionValidator:
    """Runs evaluation over a dataset split and computes mAP metrics."""

    def __init__(self, dataloader=None, save_dir: Optional[Path] = None, args=None, device=None):
        self.args = get_cfg(overrides=args)
        self.devices = resolve_devices(self.args.device if device is None else device)
        self.device = self.devices[0]
        self.mesh = make_mesh(devices=self.devices) if len(self.devices) > 1 else None
        self.dataloader = dataloader
        self.save_dir = save_dir or get_save_dir(self.args)
        self.args.conf = self.args.conf or 0.001
        self.args.task = "detect"
        self.metrics = DetMetrics(save_dir=self.save_dir, plot=self.args.plots)
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.niou = self.iouv.size
        self.seen = 0
        self.stats: Dict[str, list] = {}
        self.jdict: List = []
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self._infer = None
        self.ema_graphs = GraphCache()  # a trainer's val: its graphs, kept across the epochs
        self._ema_half = None  # (the trainer's EMA module, its bf16 copy) for a half-precision trainer val
        self._ring = PinnedRing(self.device)  # the feed's host buffers, kept across calls
        self.last_feed: Optional[DeviceFeed] = None  # the last call's feed, with its counters

    # ---- setup ----

    def _build_infer(self, net, model, half: bool, graphs: Optional[GraphCache] = None):
        """uint8 (B, H, W, 3) RGB batch on the device -> (B, max_det, 6) detections there.

        `net` is the eval-mode module to run (bf16 with half); `model` gives
        the head's layout. The NMS scores and decodes in fp32 whatever the
        maps' dtype (half=False), with no fp32 copy of the maps. With
        `graphs`, each replica's step on the card replays a CUDA graph of that
        cache once its batch shape repeats (`infer.graphs`); without, it runs
        eagerly.
        """
        nc, strides, reg_max = model.nc, model.strides, model.reg_max
        conf, iou, max_det = float(self.args.conf), float(self.args.iou), int(self.args.max_det)
        end2end = bool(getattr(model.detect, "end2end", False))
        agnostic = bool(self.args.single_cls)
        dtype = torch.bfloat16 if half else torch.float32

        def infer_one(images: torch.Tensor, net) -> torch.Tensor:
            x = images
            if x.dtype == torch.uint8:  # as XLA lowers the JAX validator's x / 255: the same bits
                x = x.float() * (1.0 / 255.0)
            feats = forward_nhwc(net, x.to(dtype))
            if end2end:  # one2one top-k select; no NMS
                o2o = [f.float() for f in feats["one2one"]]
                return postprocess_end2end(o2o, strides, nc, reg_max, max_det=min(max_det, model.detect.max_det),
                                           conf_thres=conf)
            return nms_from_feats(feats, strides, nc, reg_max, conf_thres=conf,
                                  iou_thres=iou, max_det=max_det, max_cand=VAL_MAX_CAND, multi_label=True,
                                  agnostic=agnostic)

        mesh = self.mesh
        replicas = replicate_tree(mesh, net)
        key = (half, end2end, agnostic, conf, iou, max_det)
        step = infer_one if graphs is None else lambda x, net: graphs(lambda xs: infer_one(xs, net), x, net, key)

        @torch.inference_mode()
        def infer(images: torch.Tensor) -> torch.Tensor:
            with fp32_convs(images.device):
                return run_sharded(mesh, replicas, images, step)

        infer.graphs = graphs
        return infer

    # ---- main entry ----

    def __call__(self, trainer=None, model=None):
        """Validate `model` (a DetectionModel), or a trainer's EMA model, on the dataset split of self.args."""
        half = bool(self.args.half)
        if trainer is not None:
            model = trainer.model
            ema = trainer.ema.ema  # eval mode, unfused, with the EMA's BN statistics
            self.args.batch = trainer.args.batch
            self.data = trainer.data
            self.args.plots &= trainer.stop_training or (trainer.epoch == trainer.epochs - 1)
            infer = self._build_infer(self._ema_net(ema, half), model, half, self.ema_graphs)
        else:
            self.data = check_det_dataset(self.args.data)
        self.names = self.data.get("names", model.names)
        self.nc = len(self.names)
        # COCO detection: map class indices to 1-based category ids
        val_path = str(self.data.get(self.args.split, ""))
        self.is_coco = "coco" in val_path and val_path.endswith(("val2017.txt", "test-dev2017.txt"))
        self.class_map = list(range(1, 91)) if self.is_coco else list(range(self.nc))
        model.names = self.names
        self.metrics.names = self.names
        self.confusion_matrix = ConfusionMatrix(nc=self.nc, conf=self.args.conf)

        self.imgsz = check_imgsz(self.args.imgsz, stride=32, min_dim=2)
        if self.dataloader is None:
            dataset = build_yolo_dataset(self.args, self.data[self.args.split], self.args.batch, self.data,
                                         mode="val", stride=32)
            self.dataloader = build_dataloader(dataset, self.args.batch, self.args.workers, shuffle=False)
        if trainer is None:
            if self._infer is None:  # standalone: a fused copy (Conv+BN folded), built once
                self._infer = self._build_infer(inference_net(model, self.device, half), model, half, GraphCache())
            infer = self._infer

        self.seen = 0
        self.stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": [], "target_img": []}
        profilers = (Profile(), Profile(), Profile())
        feed = self.last_feed = DeviceFeed(self.dataloader, self.device, ring=self._ring)
        try:
            for staged, batch in TQDM(feed, total=len(self.dataloader), desc="val"):
                with profilers[1]:
                    dets = infer(staged["img"]).cpu().numpy()
                with profilers[2]:
                    self.update_metrics(dets, batch)
        finally:
            feed.close()
        profilers[0].t = feed.wait_s  # this thread's time getting each batch onto the device

        stats = self.get_stats()
        self.speed = {
            k: profilers[i].t / max(self.seen, 1) * 1e3
            for i, k in enumerate(("preprocess", "inference", "postprocess"))
        }
        self.print_results()
        if self.args.plots:
            try:
                self.confusion_matrix.plot(save_dir=self.save_dir, names=self.names)
            except Exception as e:  # plotting must never break evaluation (matplotlib may be absent)
                LOGGER.warning(f"confusion matrix not plotted: {e}")
        if self.args.save_json and self.jdict:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            with open(self.save_dir / "predictions.json", "w") as f:
                json.dump(self.jdict, f)
            stats = self.eval_json(stats)
        self.metrics.speed = self.speed
        return stats

    @torch.no_grad()
    def _ema_net(self, ema, half: bool):
        """The net a trainer's val runs: the EMA module itself, or with half its one bf16 copy (unfused, eval mode),
        into which the EMA's weights and BN statistics are copied in place, so that a graph captured on it reads
        them."""
        if not half:
            return ema
        if self._ema_half is None or self._ema_half[0] is not ema:
            self._ema_half = (ema, inference_net(ema, self.device, half, fuse=False))
            return self._ema_half[1]
        net = self._ema_half[1]
        for dst, src in zip(net.state_dict().values(), ema.state_dict().values()):
            dst.copy_(src)  # fp32 -> bf16 rounds as .to(bfloat16) does
        return net

    def eval_json(self, stats: Dict) -> Dict:
        """Re-score the exported predictions with COCO semantics (the vendored numpy COCOeval).

        Uses the dataset's annotations/instances_val2017.json for COCO;
        otherwise a COCO ground truth is built from the dataset's own labels.
        """
        from yololite_tpu_torch.utils.cocoeval import COCOEval, gt_from_yolo_labels

        try:
            ds = self.dataloader.dataset
            anno_json = Path(self.data.get("path", ".")) / "annotations" / "instances_val2017.json"
            if self.is_coco and anno_json.is_file():
                with open(anno_json) as f:
                    gt = json.load(f)
            else:
                gt = gt_from_yolo_labels(ds.labels, ds.im_files, self.class_map)
            img_ids = [int(Path(x).stem) if Path(x).stem.isnumeric() else Path(x).stem for x in ds.im_files]
            coco_stats = COCOEval(gt, self.jdict, img_ids=img_ids).summarize()
            LOGGER.info(f"COCO eval (vendored): mAP50-95={coco_stats[0]:.4f} mAP50={coco_stats[1]:.4f} "
                        f"mAP75={coco_stats[2]:.4f}")
            stats[self.metrics.keys[-1]], stats[self.metrics.keys[-2]] = coco_stats[0], coco_stats[1]
        except Exception as e:  # the mAP of the validator stands when COCO scoring cannot run
            LOGGER.warning(f"COCO eval could not run: {e}")
        return stats

    # ---- per-batch metric update ----

    @staticmethod
    def _ratio_pad(rp):
        """The dataset's exact ((ratio, ratio), (padw, padh)), or None when it has none."""
        return rp if isinstance(rp, (tuple, list)) and len(rp) == 2 and isinstance(rp[0], (tuple, list)) else None

    def _prepare_batch(self, si: int, batch) -> Dict:
        """Ground truth for image si, rescaled to original-image pixels."""
        idx = batch["batch_idx"] == si
        cls = batch["cls"][idx].reshape(-1)
        bbox = batch["bboxes"][idx]
        ori_shape = batch["ori_shape"][si]
        imgsz = batch["img"].shape[1:3]
        ratio_pad = batch["ratio_pad"][si]
        if len(cls):
            bbox = xywh2xyxy(bbox) * np.array([imgsz[1], imgsz[0], imgsz[1], imgsz[0]], np.float32)
            # the dataset's exact (ratio, pad): recomputing the pad rounds differently by up to 0.5 px
            # and flips high-IoU matches
            bbox = scale_boxes_np(imgsz, bbox, ori_shape, ratio_pad=self._ratio_pad(ratio_pad))
        return {"cls": cls, "bbox": bbox, "ori_shape": ori_shape, "imgsz": imgsz, "ratio_pad": ratio_pad}

    def _prepare_pred(self, det: np.ndarray, pbatch: Dict) -> np.ndarray:
        det = det[det[:, 4] > 0].copy()
        if len(det):
            det[:, :4] = scale_boxes_np(pbatch["imgsz"], det[:, :4], pbatch["ori_shape"],
                                        ratio_pad=self._ratio_pad(pbatch.get("ratio_pad")))
        if self.args.single_cls:
            det[:, 5] = 0
        return det

    def update_metrics(self, dets: np.ndarray, batch):
        for si, det in enumerate(dets):
            self.seen += 1
            pbatch = self._prepare_batch(si, batch)
            cls, bbox = pbatch["cls"], pbatch["bbox"]
            predn = self._prepare_pred(det, pbatch)
            npr = len(predn)
            stat = {
                "conf": predn[:, 4] if npr else np.zeros(0),
                "pred_cls": predn[:, 5] if npr else np.zeros(0),
                "tp": np.zeros((npr, self.niou), bool),
                "target_cls": cls,
                "target_img": np.unique(cls),
            }
            if npr and len(cls):
                stat["tp"] = self._process_batch(predn, bbox, cls)
            if self.args.plots:
                self.confusion_matrix.process_batch(predn, bbox, cls)
            for k in self.stats:
                self.stats[k].append(stat[k])
            if self.args.save_json:
                self.pred_to_json(predn, batch["im_file"][si])

    def _process_batch(self, detections: np.ndarray, gt_bboxes: np.ndarray, gt_cls: np.ndarray) -> np.ndarray:
        iou = box_iou_np(gt_bboxes, detections[:, :4])
        return self.match_predictions(detections[:, 5], gt_cls, iou)

    def match_predictions(self, pred_classes, true_classes, iou) -> np.ndarray:
        """Greedy IoU-sorted unique matching at each of the 10 IoU thresholds."""
        correct = np.zeros((pred_classes.shape[0], self.iouv.shape[0]), bool)
        correct_class = true_classes[:, None] == pred_classes[None, :]
        iou = iou * correct_class
        for i, threshold in enumerate(self.iouv):
            matches = np.array(np.nonzero(iou >= threshold)).T  # (n, 2): [label, detection]
            if matches.shape[0]:
                if matches.shape[0] > 1:
                    matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                    matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                    matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
                correct[matches[:, 1].astype(int), i] = True
        return correct

    # ---- reporting ----

    def get_stats(self) -> Dict:
        stats = {k: np.concatenate(v, 0) if v else np.zeros(0) for k, v in self.stats.items()}
        self.nt_per_class = np.bincount(stats["target_cls"].astype(int), minlength=self.nc) if stats[
            "target_cls"].size else np.zeros(self.nc, int)
        self.nt_per_image = np.bincount(stats["target_img"].astype(int), minlength=self.nc) if stats[
            "target_img"].size else np.zeros(self.nc, int)
        if stats["tp"].size or stats["conf"].size:
            self.metrics.process(stats["tp"], stats["conf"], stats["pred_cls"], stats["target_cls"])
        return self.metrics.results_dict

    def print_results(self):
        pf = "%22s" + "%11i" * 2 + "%11.3g" * 4
        LOGGER.info(("%22s" + "%11s" * 6) % ("Class", "Images", "Instances", "P", "R", "mAP50", "mAP50-95"))
        LOGGER.info(pf % ("all", self.seen, self.nt_per_class.sum(), *self.metrics.mean_results()))
        if self.nt_per_class.sum() == 0:
            LOGGER.warning(f"no labels found in {self.args.split} set, can not compute metrics")
        if self.args.verbose and self.nc > 1 and len(self.metrics.box.ap_class_index):
            for i, c in enumerate(self.metrics.ap_class_index):
                LOGGER.info(pf % (self.names[c], self.nt_per_image[c], self.nt_per_class[c],
                                  *self.metrics.class_result(i)))

    def pred_to_json(self, predn: np.ndarray, filename):
        """Append COCO-format detection dicts (ltwh boxes, category ids through class_map)."""
        stem = Path(filename).stem
        image_id = int(stem) if stem.isnumeric() else stem
        box = predn[:, :4].copy()
        box[:, 2:] -= box[:, :2]  # xyxy -> ltwh
        for p, b in zip(predn.tolist(), box.tolist()):
            self.jdict.append({
                "image_id": image_id,
                "category_id": self.class_map[int(p[5])],
                "bbox": [round(x, 3) for x in b],
                "score": round(p[4], 5),
            })
