"""Config system: default.yaml + typed override merging (port of yololite_tpu/cfg/__init__.py).

Defaults < checkpoint args < user overrides, with per-key type validation and
fuzzy-match error messages. The defaults come from the dict copy of
default.yaml (cfg/dicts.py), so building a config reads no yaml.
"""

from __future__ import annotations

import copy
import difflib
from pathlib import Path
from typing import Dict, Union

from yololite_tpu_torch.cfg.dicts import DEFAULT_YAML
from yololite_tpu_torch.utils import IterableSimpleNamespace, LOGGER, colorstr, increment_path, yaml_load

# Typed key classes (validated in check_cfg)
CFG_FLOAT_KEYS = frozenset(
    {"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "workspace", "batch"}
)
CFG_FRACTION_KEYS = frozenset(
    {
        "dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr",
        "label_smoothing", "hsv_h", "hsv_s", "hsv_v", "translate", "scale", "perspective",
        "flipud", "fliplr", "bgr", "mosaic", "mixup", "copy_paste", "conf", "iou", "fraction",
    }
)
CFG_INT_KEYS = frozenset(
    {
        "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "max_det",
        "vid_stride", "line_width", "nbs", "save_period",
    }
)
CFG_BOOL_KEYS = frozenset(
    {
        "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
        "amp", "profile", "multi_scale", "val", "save_json", "save_hybrid",
        "half", "dnn", "plots", "show", "save_frames", "save_txt", "save_conf", "save_crop",
        "stream_buffer", "visualize", "augment", "agnostic_nms", "show_labels", "show_conf",
        "show_boxes", "keras", "optimize", "int8", "dynamic", "simplify", "nms",
    }
)

DEFAULT_CFG_DICT: Dict = copy.deepcopy(DEFAULT_YAML)
for _k, _v in DEFAULT_CFG_DICT.items():
    if isinstance(_v, str) and _v.lower() == "none":
        DEFAULT_CFG_DICT[_k] = None
DEFAULT_CFG = IterableSimpleNamespace(**DEFAULT_CFG_DICT)


def cfg2dict(cfg: Union[str, Path, Dict, IterableSimpleNamespace]) -> Dict:
    """Normalize a config source (path / namespace / dict) to a plain dict."""
    if isinstance(cfg, (str, Path)):
        return yaml_load(cfg)
    if isinstance(cfg, IterableSimpleNamespace):
        return vars(cfg)
    return dict(cfg)


def check_dict_alignment(base: Dict, custom: Dict, e=None):
    """Raise with fuzzy-matched suggestions when custom keys are not in base."""
    custom = _strip_deprecations(custom)
    base_keys, custom_keys = set(base), set(custom)
    mismatched = [k for k in custom_keys if k not in base_keys]
    if mismatched:
        string = ""
        for x in mismatched:
            matches = difflib.get_close_matches(x, base_keys)
            matches = [f"{m}={base[m]}" if base.get(m) is not None else m for m in matches]
            match_str = f"Similar arguments: {matches}. " if matches else ""
            string += f"'{colorstr('red', 'bold', x)}' is not a valid argument. {match_str}\n"
        raise SyntaxError(string) from e


def _strip_deprecations(custom: Dict) -> Dict:
    """Translate deprecated keys to their replacements."""
    deprecated = {"boxes": "show_boxes", "hide_labels": "show_labels", "hide_conf": "show_conf",
                  "line_thickness": "line_width"}
    out = {}
    for k, v in custom.items():
        if k in deprecated:
            new = deprecated[k]
            if k in ("hide_labels", "hide_conf"):
                v = not (v == "True" or v is True)
            LOGGER.warning(f"'{k}' is deprecated, use '{new}' instead.")
            k = new
        out[k] = v
    return out


def check_cfg(cfg: Dict, hard: bool = True):
    """Validate and coerce config value types in place."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS and not isinstance(v, (int, float)):
            if hard:
                raise TypeError(f"'{k}={v}' must be an int or float (got {type(v).__name__})")
            cfg[k] = float(v)
        elif k in CFG_FRACTION_KEYS:
            if not isinstance(v, (int, float)):
                if hard:
                    raise TypeError(f"'{k}={v}' must be an int or float (got {type(v).__name__})")
                v = cfg[k] = float(v)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"'{k}={v}' is out of the valid range 0.0-1.0.")
        elif k in CFG_INT_KEYS and not isinstance(v, int):
            if hard:
                raise TypeError(f"'{k}={v}' must be an int (got {type(v).__name__})")
            cfg[k] = int(v)
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            if hard:
                raise TypeError(f"'{k}={v}' must be a bool (got {type(v).__name__})")
            cfg[k] = bool(v)


def get_cfg(cfg=DEFAULT_CFG_DICT, overrides: Dict = None) -> IterableSimpleNamespace:
    """Merge defaults with overrides into a validated config namespace."""
    cfg = cfg2dict(cfg)
    if overrides:
        overrides = _strip_deprecations(cfg2dict(overrides))
        if "save_dir" not in cfg:
            overrides.pop("save_dir", None)
        check_dict_alignment(cfg, overrides)
        cfg = {**cfg, **overrides}
    for k in ("project", "name"):
        if k in cfg and isinstance(cfg[k], (int, float)):
            cfg[k] = str(cfg[k])
    if cfg.get("name") == "model" and cfg.get("model"):
        cfg["name"] = str(cfg["model"]).split(".")[0]
    check_cfg(cfg)
    return IterableSimpleNamespace(**cfg)


def get_save_dir(args, name=None) -> Path:
    """Resolve the run output directory (project/name, incremented)."""
    if getattr(args, "save_dir", None):
        return Path(args.save_dir)
    project = args.project or Path("runs") / args.task
    name = name or args.name or f"{args.mode}"
    return increment_path(Path(project) / name, exist_ok=args.exist_ok)
