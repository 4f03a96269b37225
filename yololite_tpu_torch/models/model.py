"""Graph builder: YOLO architecture spec -> torch DetectionModel.

Port of yololite_tpu/models/model.py with its whole block registry: the
YOLO11 blocks (models/modules.py) and the extended zoo (models/zoo.py,
models/transformer.py). Each row of the spec becomes one entry of
`self.model` (so weight names are `model.{i}....` as upstream) carrying its
wiring as attributes `i` (row index), `f` (input rows) and `name` (spec name).
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from yololite_tpu_torch.cfg.dicts import YOLO11_YAML
from yololite_tpu_torch.models import modules as M
from yololite_tpu_torch.models import transformer as T
from yololite_tpu_torch.models import zoo as Z
from yololite_tpu_torch.utils import LOGGER, ROOT, yaml_load

# spec name -> (module class, kind). Kinds drive arg rewriting:
#   'ch'       : args = [c1, c2_scaled, *rest]
#   'repeat'   : additionally insert repeat count n after c2
#   'plain'    : args used as-is
#   'plainch'  : module(c1, *args), output channels c1
#   'hg'       : HGStem / HGBlock (c1, cm, c2, ...), HGBlock's repeats after k
#   'resnet'   : the yaml args are the whole (c1, c2, s, is_first, n) signature
#   'cblinear' : (c1, list of split channels); the row's channels are that list
#   'cbfuse'   : (idx); channels and stride of the last input
#   'aifi'     : (c1, *args)
#   'imgpool'  : (*args, input channels); the row outputs the 512-wide text embedding
#   'detect'   : Detect(nc, input channels, end2end)
YOLO11_REGISTRY: Dict[str, Tuple[type, str]] = {
    "Conv": (M.Conv, "ch"),
    "DWConv": (M.DWConv, "ch"),
    "Bottleneck": (M.Bottleneck, "ch"),
    "SPPF": (M.SPPF, "ch"),
    "C2f": (M.C2f, "repeat"),
    "C3": (M.C3, "repeat"),
    "C3k2": (M.C3k2, "repeat"),
    "C2PSA": (M.C2PSA, "repeat"),
    "Concat": (M.Concat, "plain"),
    "nn.Upsample": (M.Upsample, "plain"),
    "Upsample": (M.Upsample, "plain"),
    "Detect": (M.Detect, "detect"),
}
REGISTRY: Dict[str, Tuple[type, str]] = {
    **YOLO11_REGISTRY,
    # the extended zoo
    "Focus": (Z.Focus, "ch"),
    "GhostConv": (Z.GhostConv, "ch"),
    "GhostBottleneck": (Z.GhostBottleneck, "ch"),
    "ConvTranspose": (Z.ConvTranspose, "ch"),
    "RepConv": (Z.RepConv, "ch"),
    "LightConv": (Z.LightConv, "ch"),
    "SPP": (Z.SPP, "ch"),
    "SPPELAN": (Z.SPPELAN, "ch"),
    "RepNCSPELAN4": (Z.RepNCSPELAN4, "ch"),
    "ELAN1": (Z.ELAN1, "ch"),
    "AConv": (Z.AConv, "ch"),
    "ADown": (Z.ADown, "ch"),
    "SCDown": (Z.SCDown, "ch"),
    "PSA": (Z.PSA, "ch"),
    "C1": (Z.C1, "repeat"),
    "C2": (Z.C2, "repeat"),
    "C3x": (Z.C3x, "repeat"),
    "C3Ghost": (Z.C3Ghost, "repeat"),
    "C3TR": (T.C3TR, "repeat"),
    "RepC3": (Z.RepC3, "repeat"),
    "RepCSP": (Z.RepCSP, "repeat"),
    "BottleneckCSP": (Z.BottleneckCSP, "repeat"),
    "C2fCIB": (Z.C2fCIB, "repeat"),
    "C2fPSA": (Z.C2fPSA, "repeat"),
    "C3f": (Z.C3f, "repeat"),
    "CIB": (Z.CIB, "ch"),
    "RepVGGDW": (Z.RepVGGDW, "plainch"),
    "CBAM": (Z.CBAM, "plainch"),
    "ChannelAttention": (Z.ChannelAttention, "plainch"),
    "HGStem": (Z.HGStem, "hg"),
    "HGBlock": (Z.HGBlock, "hg"),
    "ResNetLayer": (Z.ResNetLayer, "resnet"),
    "CBLinear": (Z.CBLinear, "cblinear"),
    "CBFuse": (Z.CBFuse, "cbfuse"),
    "AIFI": (T.AIFI, "aifi"),
    "TransformerBlock": (T.TransformerBlock, "ch"),
    "Proto": (Z.Proto, "ch"),
    "Conv2": (Z.Conv2, "ch"),
    "DWConvTranspose2d": (Z.DWConvTranspose2d, "ch"),
    "MaxSigmoidAttnBlock": (Z.MaxSigmoidAttnBlock, "ch"),
    "C2fAttn": (Z.C2fAttn, "repeat"),
    "ImagePoolingAttn": (Z.ImagePoolingAttn, "imgpool"),
    "ContrastiveHead": (Z.ContrastiveHead, "plain"),
    "BNContrastiveHead": (Z.BNContrastiveHead, "plainch"),
}


def make_divisible(x, divisor=8):
    """Round channel count up to the nearest multiple of divisor."""
    return math.ceil(x / divisor) * divisor


def guess_model_scale(model_path) -> str:
    """Extract the scale letter from a name like yolo11n.yaml / yolo11s.pt."""
    m = re.search(r"yolo[v]?\d+([nslmx])", Path(str(model_path)).stem)
    return m.group(1) if m else ""


def yaml_model_load(path) -> Dict:
    """Load an architecture yaml, resolving the scale from the filename.

    The packaged cfg/yolo11.yaml is taken from its dict copy, so no yaml
    parser is needed for it; any other file is parsed with PyYAML.
    """
    path = Path(str(path))
    stem = path.stem
    scale = guess_model_scale(stem)
    unified = re.sub(r"(\d+)([nslmx])(.+)?$", r"\1\3", stem)  # yolo11n -> yolo11
    packaged = ROOT / "cfg" / "yolo11.yaml"
    candidates = [path, ROOT / "cfg" / path.name, ROOT / "cfg" / f"{unified}{path.suffix or '.yaml'}"]
    for p in candidates:
        if p.exists():
            if p.resolve() == packaged.resolve():
                d = copy.deepcopy(YOLO11_YAML)
                d["yaml_file"] = str(p)
            else:
                d = yaml_load(p, append_filename=True)
            d["scale"] = scale or d.get("scale") or tuple(d.get("scales", {"n": 0}).keys())[0]
            return d
    raise FileNotFoundError(f"Model yaml '{path}' not found (searched {candidates})")


def _check_stride(sp, layer_idx: int) -> int:
    """Validate a Detect input's cumulative downscale: positive integer power of two."""
    s = int(sp)
    if s != sp or s <= 0 or (s & (s - 1)) != 0:
        raise ValueError(f"invalid Detect stride {sp!r} inferred for layer {layer_idx}; "
                         "a module in the chain is missing a `downsample` declaration")
    return s


def parse_spec(d: Dict, ch_in: int = 3, verbose: bool = False) -> Tuple[List[nn.Module], List[int], int, List[int]]:
    """Resolve a model dict into modules, save-list, nc and Detect strides.

    Applies the compound scaling of the JAX package: depth gain on repeats,
    width gain + max_channels clamp on output channels, c3k=True for m/l/x
    C3k2 blocks. Each module gets `i`, `f` and `name` attributes.
    """
    nc = d.get("nc", 80)
    scales = d.get("scales")
    depth, width, max_channels = 1.0, 1.0, float("inf")
    scale = d.get("scale")
    if scales:
        if not scale:
            scale = tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    ch = [ch_in]
    spatial = [1]  # cumulative downscale per produced layer (input=1)
    layers: List[nn.Module] = []
    save: List[int] = []
    detect_strides: List[int] = []

    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        args = list(args)
        for j, a in enumerate(args):
            if a == "nc":
                args[j] = nc
        cls, kind = REGISTRY[name]
        n_scaled = max(round(n * depth), 1) if n > 1 else n

        prev = f if isinstance(f, int) else f[0]
        if kind in ("ch", "repeat"):
            c1, c2 = ch[prev], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            margs = [c1, c2, *args[1:]]
            if kind == "repeat":
                margs.insert(2, n_scaled)
                n_scaled = 1
            if name == "C2fAttn" and len(margs) > 4:  # embed channels and head count scale with the width
                margs[3] = make_divisible(min(margs[3], max_channels // 2) * width, 8)
                margs[4] = int(max(round(min(margs[4], max_channels // 2 // 32)) * width, 1) if margs[4] > 1
                               else margs[4])
            if name == "C3k2" and scale in "mlx":
                if len(margs) > 3:  # c3k flag is margs[3] ([c1, c2, n, c3k, ...])
                    margs[3] = True
                else:
                    margs.append(True)
            mod = cls(*margs)
            sp = None  # resolved below from mod.downsample (after any Sequential wrap)
        elif kind == "plain":
            mod = cls(*args)
            if name == "Concat":
                c2 = sum(ch[x] for x in f)
                sp = spatial[f[0]]
            else:  # Upsample, ContrastiveHead
                c2 = ch[prev]
                sp = spatial[prev] * getattr(mod, "downsample", 1)
            margs = args
        elif kind == "detect":
            in_ch = [ch[x] for x in f]
            e2e = bool(args[1]) if len(args) > 1 else False  # optional NMS-free one2one branch pair
            mod = cls(nc, in_ch, end2end=e2e)
            mod.stride = [_check_stride(spatial[x], x) for x in f]
            detect_strides = mod.stride
            c2 = 0
            sp = 0
            margs = [nc, in_ch]
        elif kind == "imgpool":
            margs = [*args, [ch[x] for x in f]]
            mod = cls(*margs)
            c2 = 512  # the text embedding (ct, 512 by default; specs pass only ec)
            sp = spatial[f[0] if isinstance(f, (list, tuple)) else f]
        elif kind == "plainch":
            c2 = ch[prev]
            margs = [c2, *args]
            mod = cls(*margs)
            sp = None
        elif kind == "hg":
            c1, cm, c2 = ch[prev], args[0], args[1]
            margs = [c1, cm, c2, *args[2:]]
            if name == "HGBlock":
                margs.insert(4, n_scaled)  # repeats after k
                n_scaled = 1
            mod = cls(*margs)
            sp = None
        elif kind == "resnet":
            margs = list(args)
            is_first = margs[3] if len(margs) > 3 else False
            c2 = margs[1] if is_first else margs[1] * 4
            mod = cls(*margs)
            sp = spatial[prev] * (4 if is_first else (margs[2] if len(margs) > 2 else 1))
        elif kind == "cblinear":
            c2 = args[0]  # the list of split channel counts
            margs = [ch[prev], *args]
            mod = cls(*margs)
            sp = spatial[prev]
        elif kind == "cbfuse":
            c2 = ch[f[-1]]
            margs = args
            mod = cls(*margs)
            sp = spatial[f[-1]]
        else:  # aifi
            c2 = ch[prev]
            margs = [c2, *args]
            mod = cls(*margs)
            sp = spatial[prev]

        if n_scaled > 1:
            mod = nn.Sequential(*[cls(*margs) for _ in range(n_scaled)])
            mod.downsample = math.prod(getattr(m, "downsample", 1) for m in mod)
        if sp is None:
            sp = spatial[prev] * getattr(mod, "downsample", 1)

        mod.i, mod.f, mod.name = i, f, name
        layers.append(mod)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch = []
            spatial = []
        ch.append(c2)
        spatial.append(sp)
        if verbose:
            LOGGER.info(f"{i:>3} {str(f):>18} {n_scaled:>3}  {name:<12} {margs}")

    return layers, sorted(set(save)), nc, detect_strides


class DetectionModel(nn.Module):
    """YOLO detection model: `model(x)` with x (B, 3, H, W) returns the list of
    per-level Detect maps (B, 4*reg_max + nc, H/s, W/s), or the end2end dict.

    Box decoding lives in yololite_tpu_torch.ops, as in the JAX package.
    """

    def __init__(self, cfg: Union[str, Path, Dict] = "yolo11n.yaml", ch: int = 3, nc: Optional[int] = None,
                 verbose: bool = False):
        super().__init__()
        self.yaml = yaml_model_load(cfg) if isinstance(cfg, (str, Path)) else copy.deepcopy(dict(cfg))
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        layers, self.save, self.nc, self.strides = parse_spec(self.yaml, ch, verbose=verbose)
        self.model = nn.Sequential(*layers)
        self.reg_max = self.detect.reg_max
        self.no = self.detect.no
        self.names = {i: f"class{i}" for i in range(self.nc)}

    @property
    def detect(self) -> M.Detect:
        return self.model[-1]

    def init(self, seed: int = 0) -> "DetectionModel":
        """Draw fresh weights from np.random.default_rng(seed), in the JAX package's order.

        Gives the same weights as yololite_tpu's `DetectionModel.init(seed)`
        (BN at weight 1, bias 0, mean 0, var 1), then the Detect bias priors.
        """
        rng = np.random.default_rng(seed)
        for m in self.model:
            M.init_weights_(m, rng)
        self.detect.bias_init()
        return self

    def fuse(self) -> "DetectionModel":
        """Fold every Conv+BN pair in place (inference)."""
        M.fuse_(self)
        return self

    def forward(self, x: torch.Tensor, capture: Sequence[int] = (), features: Optional[Dict] = None):
        """Run the graph. Rows listed in `capture` put their outputs into `features`."""
        saved: Dict[int, torch.Tensor] = {}
        y = x
        for m in self.model:
            if isinstance(m.f, int):
                inp = y if m.f == -1 else saved[m.f]
            else:
                inp = [y if j == -1 else saved[j] for j in m.f]
            y = m(inp)
            if m.i in self.save:
                saved[m.i] = y
            if m.i in capture and features is not None and isinstance(y, torch.Tensor):
                features[m.i] = y
        return y

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def gflops(self, imgsz: int = 640) -> float:
        """GFLOPs of one forward at imgsz (2 x the conv and matmul MACs), counted on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = copy.deepcopy(self).to("meta")
        x = torch.empty(1, 3, imgsz, imgsz, device="meta")
        with FlopCounterMode(display=False) as counter:
            meta(x)
        return counter.get_total_flops() / 1e9


def count_params(tree) -> int:
    """Number of parameters of a module, or of elements of a dict (or list) of tensors."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    values = tree.values() if isinstance(tree, dict) else tree
    return sum(count_params(v) if isinstance(v, (dict, list, tuple)) else int(v.numel()) for v in values)


def guess_model_task(model) -> str:
    """The task of a model or spec: the package is detection-only."""
    return "detect"


class EnsembleModel(nn.Module):
    """Multi-model NMS ensemble (port of yololite_tpu/models/model.py:411 EnsembleModel).

    Members run on the same input; their decoded (boxes, scores) concatenate
    along the anchor axis before one NMS. The JAX package keys the members'
    weight trees "m0", "m1", ...; here they are `members.0`, `members.1`, ...
    """

    def __init__(self, members: Sequence[DetectionModel]):
        super().__init__()
        if not members:
            raise ValueError("EnsembleModel needs at least one member")
        ncs = {m.nc for m in members}
        if len(ncs) != 1:
            raise ValueError(f"ensemble members disagree on class count: {sorted(ncs)}")
        self.members = nn.ModuleList(members)
        last = self.members[-1]
        self.nc, self.reg_max, self.strides, self.names = last.nc, last.reg_max, last.strides, last.names
        self.args: Dict = {}

    def fuse(self) -> "EnsembleModel":
        for m in self.members:
            m.fuse()
        return self

    def decode_concat(self, x: torch.Tensor, half: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x NHWC -> (boxes (B, sum_A, 4) fp32 xyxy, scores (B, sum_A, nc)), members in order."""
        from yololite_tpu_torch.ops.decode import decode_detections

        all_boxes, all_scores = [], []
        for m in self.members:
            feats = [f.permute(0, 2, 3, 1) for f in m(x.permute(0, 3, 1, 2))]
            if not half:
                feats = [f.float() for f in feats]
            boxes, scores = decode_detections(feats, m.strides, m.nc, m.reg_max, xywh=False)
            all_boxes.append(boxes.float())
            all_scores.append(scores)
        return torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
