"""Streaming detection predictor (port of yololite_tpu/engine/predictor.py).

The source is read (files decoded) on a `Prefetcher` thread, as in the JAX
package. Per batch, on a feed's thread behind it (data/build.py
`DeviceFeed`, the counterpart of the JAX package's `device_put`), the frames
of a same-shape batch are stacked and zero-padded to the batch size
straight into a page-locked buffer (BGR uint8); other batches are
letterboxed on the host with cv2 first. The buffer is copied on the card's
copy stream while the batch before is inferred. A uint8 batch is letterboxed on the device
(`ops.kernels.device_letterbox`, K2 on the card, which reverses the channels
as it reads them and writes the layout the net's first conv reads). Then
forward + select-first decode (K3) + exact greedy NMS run on the device and
return a padded (B, max_det, 6) tensor, which is copied to the host,
rescaled and wrapped in Results. Tail batches are padded to the batch size
so every batch has the same shape.

Given several devices (a list, or a comma string such as '0,1'), the
predictor holds one replica of the fused net per device: each batch that
divides is split over them (parallel/mesh.py), each shard runs on its own
device, K1 runs once per shard, and the outputs are gathered in order on the
first device. A batch that does not divide runs whole on the first device.

Images stay in the JAX package's NHWC layout up to the model, which takes
NCHW; the Detect maps go back to NHWC for the decode and NMS ops.

On the card `infer` and `infer_uint8` replay a CUDA graph of the whole step
(letterbox, forward, NMS) for an input shape seen before: the first call of
a shape runs eagerly, the second captures it (engine/graphs.py), one graph
per replica over a mesh, a bounded number per predictor; the cache is
cleared whenever the net is replaced (set-up, int8 quantization).

An EnsembleModel (a multi-member .pt) decodes every member and runs one NMS
over the concatenated candidates. int8=True quantizes the net on the first
real batch (models/quant.py; a tensor source calibrates on itself) and then
runs its quantized convs through K8; an ensemble warns and stays float.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from yololite_tpu_torch.cfg import get_cfg, get_save_dir
from yololite_tpu_torch.data.build import DeviceFeed, PinnedRing, Prefetcher, load_inference_source
from yololite_tpu_torch.data.loaders import VID_FORMATS
from yololite_tpu_torch.engine.graphs import GraphCache
from yololite_tpu_torch.engine.results import Results
from yololite_tpu_torch.ops.boxes import convert_batch2numpy, scale_boxes_np
from yololite_tpu_torch.ops.decode import decode_detections, postprocess_end2end
from yololite_tpu_torch.ops.kernels import device_letterbox
from yololite_tpu_torch.ops.letterbox import preprocess_batch, scale_img
from yololite_tpu_torch.ops.nms import nms_from_feats, non_max_suppression
from yololite_tpu_torch.parallel.mesh import make_mesh, replicate_tree, resolve_devices, shard_batch
from yololite_tpu_torch.utils import LOGGER, colorstr
from yololite_tpu_torch.utils.checks import check_imgsz
from yololite_tpu_torch.utils.profile import Profile


@contextlib.contextmanager
def fp32_convs(device: torch.device):
    """cuDNN convolutions in full fp32 (TF32 off) for the block, restored on exit.

    cuDNN runs fp32 convolutions in TF32 by default, which keeps about three
    decimal digits; the fp32 predict path is held to the JAX package instead.
    fp32 matmuls already default to full precision.
    """
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        yield


def inference_net(model, device: torch.device, half: bool, fuse: bool = True):
    """A copy of `model` on `device` in eval mode, with Conv+BN folded (fuse) and cast to bf16 (half)."""
    net = copy.deepcopy(model).to(device).eval()
    if fuse:
        net.fuse()
    return net.to(torch.bfloat16 if half else torch.float32)


def on_device(device: torch.device):
    """The block's launches go to `device` (the current CUDA device); a no-op off the card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_sharded(mesh, replicas: list, x: torch.Tensor, fn):
    """fn(shard, replica) on each shard of x over the mesh, gathered in order on the first device.

    Without a mesh, or for a batch that does not divide, x runs whole on the
    first replica. The shards' launches do not wait for each other.
    """
    shards = shard_batch(mesh, x)
    outs = []
    for xs, net in zip(shards, replicas):
        with on_device(xs.device):
            outs.append(fn(xs, net))
    if len(outs) == 1:
        return outs[0]
    first = outs[0].device
    return torch.cat([o.to(first, non_blocking=True) for o in outs])


def forward_nhwc(net, x: torch.Tensor):
    """NHWC images -> NHWC per-level Detect maps (or the end2end dict of them); the net runs NCHW."""
    out = net(x.permute(0, 3, 1, 2))
    nhwc = lambda fs: [f.permute(0, 2, 3, 1) for f in fs]
    return {k: nhwc(v) for k, v in out.items()} if isinstance(out, dict) else nhwc(out)


class DetectionPredictor:
    """Holds the inference model on its device and the streaming loop state."""

    def __init__(self, cfg=None, overrides: Optional[Dict] = None, device=None):
        self.args = get_cfg(cfg or {}, None) if isinstance(cfg, dict) and not overrides else get_cfg(overrides=overrides)
        if self.args.conf is None:
            self.args.conf = 0.25
        self.devices = resolve_devices(self.args.device if device is None else device)
        self.device = self.devices[0]
        self.mesh = make_mesh(devices=self.devices) if len(self.devices) > 1 else None
        self.save_dir = get_save_dir(self.args)
        self.model = None  # the caller's DetectionModel (names, strides)
        self.net = None  # its fused inference copy on self.device
        self.replicas = []  # self.net and, over a mesh, one copy on each further device
        self.dataset = None
        self.seen = 0
        self._lock = threading.Lock()
        self.done_warmup = False
        self._graphs = GraphCache()  # the captured steps of self.net's replicas
        self._ring = PinnedRing(self.device)  # the feed's host buffers, kept across calls
        self.last_feed: Optional[DeviceFeed] = None  # the last call's feed, with its counters

    # ---- setup ----

    def setup_model(self, model, half: Optional[bool] = None, fuse: bool = True):
        """Bind a DetectionModel or EnsembleModel: a fused (and, with half, bf16) copy on the device, plus the NMS settings."""
        from yololite_tpu_torch.models.model import EnsembleModel

        self.model = model
        self.is_ensemble = isinstance(model, EnsembleModel)
        self.half = bool(self.args.half if half is None else half)
        self.dtype = torch.bfloat16 if self.half else torch.float32
        self.net = inference_net(model, self.device, self.half, fuse)
        self.replicas = replicate_tree(self.mesh, self.net)
        self._graphs.clear()
        self._quantized = False

        self.conf, self.iou = float(self.args.conf), float(self.args.iou)
        self.max_det = int(self.args.max_det)
        self.agnostic = bool(self.args.agnostic_nms)
        self.augment = bool(self.args.augment)
        self.class_mask = None
        if self.args.classes is not None:
            cm = np.zeros(model.nc, bool)
            cm[np.asarray(self.args.classes, int)] = True
            self.class_mask = torch.from_numpy(cm).to(self.device)
        # NMS-free end2end heads: inference decodes the one2one maps and takes a plain top-k
        self.end2end = not self.is_ensemble and bool(getattr(model.detect, "end2end", False))
        # top-K candidate pool: 256 at the 0.25 default, 512 when conf is lowered (more
        # candidates survive the gate), and never below the user's max_det
        self.pred_max_cand = max(256 if self.conf >= 0.25 else 512, self.max_det)
        # what changes a captured step besides its input and module (engine/graphs.py)
        classes = None if self.args.classes is None else tuple(np.atleast_1d(np.asarray(self.args.classes, int)))
        self._graph_key = (self.half, self.augment, self.end2end, self.is_ensemble, self.conf, self.iou,
                           self.max_det, self.agnostic, self.pred_max_cand, classes)

    def _forward(self, x: torch.Tensor):
        return forward_nhwc(self.net, x)

    def _forward_decode(self, x: torch.Tensor, net):
        if self.is_ensemble:  # members' decoded outputs concatenate along the anchors
            return net.decode_concat(x, half=self.half)
        feats = forward_nhwc(net, x)
        if isinstance(feats, dict):
            feats = feats["one2many"]
        boxes, scores = decode_detections(feats, self.model.strides, self.model.nc, self.model.reg_max, xywh=False)
        return boxes.float(), scores

    def _forward_tta(self, x: torch.Tensor, net):
        """Test-time augmentation: scales 1, 0.83 (flipped) and 0.67, merged before NMS.

        Each view is resized by scale_img (padded to the /32 grid with the 0.447
        fill) and its boxes unscaled by the plain ratio.
        """
        w = x.shape[2]
        outs = []
        for s, flip in ((1.0, False), (0.83, True), (0.67, False)):
            xi = scale_img(x.flip(2) if flip else x, s, gs=32)
            boxes, scores = self._forward_decode(xi, net)
            boxes = boxes / s
            if flip:  # un-flip x coords (xyxy)
                boxes = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0], boxes[..., 3]], -1)
            outs.append((boxes, scores))
        return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)

    def _class_mask(self, device: torch.device):
        return None if self.class_mask is None else self.class_mask.to(device)

    def _single_label(self, x: torch.Tensor, net) -> torch.Tensor:
        """Non-TTA predict graph: select-first NMS over the raw maps (an ensemble: decode-all concat, then NMS)."""
        m = self.model
        if self.is_ensemble:
            boxes, scores = net.decode_concat(x, half=self.half)
            return non_max_suppression(boxes, scores, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                                       max_cand=512, multi_label=False, agnostic=self.agnostic,
                                       class_mask=self._class_mask(x.device))
        feats = forward_nhwc(net, x)
        if self.end2end:
            return postprocess_end2end(feats["one2one"], m.strides, m.nc, m.reg_max,
                                       max_det=min(self.max_det, m.detect.max_det), conf_thres=self.conf)
        return nms_from_feats(
            feats, m.strides, m.nc, m.reg_max, conf_thres=self.conf, iou_thres=self.iou,
            max_det=self.max_det, max_cand=self.pred_max_cand, agnostic=self.agnostic,
            class_mask=self._class_mask(x.device), half=self.half,
        )

    def _detect(self, x: torch.Tensor, net) -> torch.Tensor:
        if not self.augment or self.end2end:  # end2end: the one2one top-k is the whole tail
            return self._single_label(x, net)
        boxes, scores = self._forward_tta(x, net)
        return non_max_suppression(
            boxes, scores, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
            max_cand=512, multi_label=False, agnostic=self.agnostic, class_mask=self._class_mask(x.device),
        )

    @torch.inference_mode()
    def infer(self, images: torch.Tensor) -> torch.Tensor:
        """Letterboxed NHWC float batch on the device -> (B, max_det, 6) detections on the device (a graph replay
        once the shape repeats)."""
        key = ("float", self._quantized, *self._graph_key)
        with fp32_convs(self.device):
            return run_sharded(self.mesh, self.replicas, images, lambda x, net: self._graphs(
                lambda xs: self._detect(xs.to(self.dtype), net), x, net, key))

    def letterbox_channels_last(self, device: torch.device) -> bool:
        """The layout K2 writes the net's input in, which cuDNN keeps through the net: NCHW-contiguous for the fp32
        net on the card, channels-last for the bf16 and int8 nets (K8 reads channels-last) and on the CPU: on an
        H100 the fp32 forward runs faster on NCHW and the bf16 one on channels-last (chip_smoke.py phase 3 times
        both; PERF.md, PR 12)."""
        return self._quantized or self.half or device.type != "cuda"

    @torch.inference_mode()
    def infer_uint8(self, raw: torch.Tensor, imgsz: int, bgr: bool = False) -> torch.Tensor:
        """(B, H0, W0, 3) uint8 RGB batch (BGR with bgr) on the device -> device letterbox -> (B, max_det, 6),
        letterbox, forward and NMS in one graph replay once the frame size repeats."""
        key = ("uint8-bgr" if bgr else "uint8", int(imgsz), self._quantized, *self._graph_key)

        def step(xs, net):
            x = device_letterbox(xs, imgsz=imgsz, out_dtype=self.dtype, bgr=bgr,
                                 channels_last=self.letterbox_channels_last(xs.device))
            return self._detect(x, net)

        with fp32_convs(self.device):
            return run_sharded(self.mesh, self.replicas, raw,
                               lambda x, net: self._graphs(lambda xs: step(xs, net), x, net, key))

    def setup_source(self, source):
        self.imgsz = check_imgsz(self.args.imgsz, stride=32, min_dim=2)
        self.dataset = load_inference_source(
            source, batch=self.args.batch, vid_stride=self.args.vid_stride, buffer=self.args.stream_buffer
        )

    def _maybe_quantize(self, calib):
        """int8 serving: on the first real batch, quantize the net with `calib()` (that batch as NHWC floats in
        [0, 1]) for the activation scale; an ensemble warns once and stays float."""
        if not bool(self.args.int8) or self._quantized:
            return
        if self.is_ensemble:
            self._quantized = True
            LOGGER.warning("int8 serving is not supported for ensembles; running bf16/fp32")
            return
        from yololite_tpu_torch.models.quant import quantize_model

        self.net, self.scales = quantize_model(self.net, [calib()], self.device)  # raises on a zoo model
        self.replicas = replicate_tree(self.mesh, self.net)
        self._graphs.clear()  # the warm-up's graphs ran the float net
        self._quantized = True
        LOGGER.info("int8 serving: weights quantized (per-channel), activations calibrated on the first batch")

    def warmup(self, batch: int):
        self.infer(torch.zeros((batch, self.imgsz[0], self.imgsz[1], 3), device=self.device))
        self.done_warmup = True

    # ---- inference ----

    def __call__(self, source=None, stream: bool = False, **kwargs):
        if stream:
            return self.stream_inference(source)
        return list(self.stream_inference(source))

    @staticmethod
    def _padded(take, images, batch_size: int) -> np.ndarray:
        """The images (arrays of one shape and dtype) stacked into `take`'s buffer, zero images after them up to
        batch_size."""
        n = len(images)
        out = take((max(n, batch_size), *images[0].shape), images[0].dtype)
        for j, im in enumerate(images):
            out[j] = im
        out[n:] = 0
        return out

    def _stage(self, item, take, is_tensor: bool):
        """A loader batch -> the array to send and what the host keeps (`DeviceFeed`'s prepare, on its thread):
        a pre-normalized float tensor source as it is, a same-shape batch of frames as uint8 BGR for the device's
        letterbox, mixed shapes letterboxed here; each padded to the batch size."""
        paths, im0s, infos = item
        batch_size = int(self.args.batch)
        if is_tensor:
            im = np.asarray(im0s, np.float32)
            return ({"x": self._padded(take, im, batch_size)},
                    ("tensor", paths, convert_batch2numpy(im), infos, im0s, im.shape[1:3]))  # BGR uint8 for Results
        if len({im.shape for im in im0s}) == 1:
            return {"x": self._padded(take, im0s, batch_size)}, ("uint8", paths, im0s, infos, im0s,
                                                                  (self.imgsz[0], self.imgsz[1]))
        im = preprocess_batch(im0s, imgsz=self.imgsz[0])
        return {"x": self._padded(take, im, batch_size)}, ("host", paths, im0s, infos, im0s, im.shape[1:3])

    def stream_inference(self, source):
        """Generator yielding per-image Results; the host side is prefetched on a thread."""
        if self.args.verbose:
            LOGGER.info("")
        self.setup_source(source)
        if self.args.save or self.args.save_txt:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        if not self.done_warmup:
            self.warmup(batch=self.args.batch)

        profilers = (Profile(), Profile(), Profile())
        with self._lock:
            is_tensor = getattr(getattr(self.dataset, "source_type", None), "tensor", False)
            # the source read on a thread of its own: read on the feed's thread, each batch's decode and stage in
            # turn, a folder of JPEG frames predicted slower (tools/feed_probe.py)
            feed = self.last_feed = DeviceFeed(Prefetcher(self.dataset, depth=2), self.device,
                                               lambda item, take: self._stage(item, take, is_tensor), ring=self._ring)
            batches = iter(feed)
            try:
                while True:
                    with profilers[0]:  # this thread's time getting the batch onto the device
                        staged = next(batches, None)
                    if staged is None:
                        break
                    x, (kind, paths, im0s, infos, raw0s, input_hw) = staged[0]["x"], staged[1]
                    n = len(raw0s)
                    # a tensor source calibrates on itself, frames on their host letterbox
                    self._maybe_quantize(lambda: np.asarray(raw0s, np.float32) if is_tensor
                                         else preprocess_batch(raw0s, imgsz=self.imgsz[0]))
                    with profilers[1]:
                        if kind == "uint8":  # letterboxed on the card from the BGR frames
                            dets = self.infer_uint8(x, self.imgsz[0], bgr=True).cpu().numpy()
                        else:
                            dets = self.infer(x).cpu().numpy()
                    with profilers[2]:
                        results = self.postprocess(dets[:n], input_hw, im0s, paths)

                    if self.args.visualize and not is_tensor:
                        self._visualize_features(preprocess_batch(im0s[:1], imgsz=self.imgsz[0]))

                    for i, result in enumerate(results):
                        self.seen += 1
                        result.speed = {
                            "preprocess": profilers[0].dt * 1e3 / n,
                            "inference": profilers[1].dt * 1e3 / n,
                            "postprocess": profilers[2].dt * 1e3 / n,
                        }
                        if self.args.verbose:
                            LOGGER.info(f"{infos[i]}{result.verbose()}{profilers[1].dt * 1e3 / n:.1f}ms")
                        if not is_tensor:
                            self._save(result, paths[i])
                        yield result
            finally:
                batches.close()

        for vw in getattr(self, "_vid_writers", {}).values():
            vw.release()
        self._vid_writers = {}

        if self.args.verbose and self.seen:
            t = tuple(p.t / self.seen * 1e3 for p in profilers)
            LOGGER.info(
                f"Speed: {t[0]:.1f}ms preprocess, {t[1]:.1f}ms inference, {t[2]:.1f}ms postprocess "
                f"per image at shape (1, {self.imgsz[0]}, {self.imgsz[1]}, 3)"
            )
        if self.args.save or self.args.save_txt:
            LOGGER.info(f"Results saved to {colorstr('bold', self.save_dir)}")

    def _save(self, result: Results, path: str):
        """Write the annotated image or video frame, labels and crops the args ask for."""
        is_video = Path(path).suffix.lower().lstrip(".") in VID_FORMATS or getattr(self.dataset, "mode", "image") == "stream"
        if self.args.save and is_video:
            self._write_video_frame(path, result.plot())
        elif self.args.save:
            result.save(str(self.save_dir / Path(path).name))
        if self.args.save_txt:
            result.save_txt(str(self.save_dir / "labels" / (Path(path).stem + ".txt")), save_conf=self.args.save_conf)
        if self.args.save_crop:
            result.save_crop(self.save_dir / "crops", Path(path).name)

    def _write_video_frame(self, path, frame):
        """Append an annotated frame to a per-source mp4 writer."""
        import cv2

        if not hasattr(self, "_vid_writers"):
            self._vid_writers = {}
        if path not in self._vid_writers:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            out = str(self.save_dir / (Path(path).stem + ".mp4"))
            fps = 30
            cap = getattr(self.dataset, "cap", None)
            if cap is not None:
                fps = int(cap.get(cv2.CAP_PROP_FPS)) or 30
            h, w = frame.shape[:2]
            self._vid_writers[path] = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        self._vid_writers[path].write(frame)

    @torch.inference_mode()
    def _visualize_features(self, im: np.ndarray):
        """Save feature maps of the backbone tap layers."""
        from yololite_tpu_torch.utils.plotting import feature_visualization

        capture = sorted(self.model.save)[:6]
        features: Dict[int, torch.Tensor] = {}
        x = torch.from_numpy(im).to(self.device, self.dtype).permute(0, 3, 1, 2)
        with fp32_convs(self.device):
            self.net(x, capture=capture, features=features)
        for idx, feat in features.items():
            fmap = feat.float().permute(0, 2, 3, 1).cpu().numpy()
            feature_visualization(fmap, self.model.model[idx].name, idx, save_dir=self.save_dir)

    def postprocess(self, dets: np.ndarray, input_hw, orig_imgs: List[np.ndarray], paths) -> List[Results]:
        """Strip padding rows, rescale to original frames, wrap in Results."""
        results = []
        for det, im0, path in zip(dets, orig_imgs, paths):
            det = det[det[:, 4] > 0]
            if len(det):
                det = det.copy()
                det[:, :4] = scale_boxes_np(input_hw, det[:, :4], im0.shape[:2])
            results.append(Results(im0, path, self.model.names, det.astype(np.float32)))
        return results
