"""Foundation utilities: logging, YAML IO, namespaces, device selection.

Port of yololite_tpu/utils/__init__.py. PyYAML is imported only where a user
yaml is read, so the predict path runs without it: the packaged
yaml files are also carried as dicts (cfg/dicts.py).
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from types import SimpleNamespace

__all__ = (
    "LOGGER",
    "set_logging",
    "TQDM",
    "ROOT",
    "DEFAULT_CFG_PATH",
    "colorstr",
    "yaml_load",
    "yaml_save",
    "yaml_print",
    "IterableSimpleNamespace",
    "increment_path",
    "get_latest_run",
    "select_device",
)

ROOT = Path(__file__).resolve().parents[1]  # yololite_tpu_torch/ package root
DEFAULT_CFG_PATH = ROOT / "cfg" / "default.yaml"
VERBOSE = str(os.getenv("YOLO_VERBOSE", True)).lower() == "true"


def set_logging(name: str = "yololite_tpu_torch", verbose: bool = True) -> logging.Logger:
    """Configure and return the named stdout logger: message-only, INFO when verbose else ERROR."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO if verbose else logging.ERROR)
    logger.propagate = False
    return logger


LOGGER = set_logging(verbose=VERBOSE)


class TQDM:
    """Minimal tqdm-compatible progress bar: counts items, logs only on set_description."""

    def __init__(self, iterable=None, total=None, desc="", disable=False, **kwargs):
        self.iterable = iterable
        self.total = total if total is not None else (len(iterable) if hasattr(iterable, "__len__") else None)
        self.desc = desc
        self.n = 0
        self.disable = disable or not VERBOSE

    def __iter__(self):
        for item in self.iterable:
            yield item
            self.update(1)
        self.close()

    def update(self, n=1):
        self.n += n

    def set_description(self, desc):
        self.desc = desc
        if not self.disable:
            total = f"/{self.total}" if self.total else ""
            LOGGER.info(f"{desc} [{self.n}{total}]")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def colorstr(*input):
    """Colorize a string for terminal output, e.g. colorstr('blue', 'bold', 'hello')."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
        "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m", "bright_green": "\033[92m",
        "bright_yellow": "\033[93m", "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


class IterableSimpleNamespace(SimpleNamespace):
    """SimpleNamespace that supports iteration over (key, value) pairs and dict(...)."""

    def __iter__(self):
        return iter(vars(self).items())

    def __str__(self):
        return "\n".join(f"{k}={v}" for k, v in vars(self).items())

    def get(self, key, default=None):
        return getattr(self, key, default)


def yaml_load(file, append_filename=False):
    """Load a YAML file into a dict (optionally recording the source path)."""
    import yaml

    path = Path(file)
    with open(path, errors="ignore", encoding="utf-8") as f:
        data = yaml.safe_load(f.read()) or {}
    if append_filename:
        data["yaml_file"] = str(path)
    return data


def yaml_print(yaml_file):
    """Log a YAML file or dict, pretty-printed."""
    import yaml

    data = yaml_load(yaml_file) if isinstance(yaml_file, (str, Path)) else yaml_file
    dump = yaml.safe_dump(data, sort_keys=False, allow_unicode=True, width=120)
    LOGGER.info(f"Printing '{colorstr('bold', 'black', yaml_file)}'\n\n{dump}")


def yaml_save(file, data):
    """Save a dict to a YAML file (Path values as strings), creating parent dirs as needed."""
    import yaml

    path = Path(file)
    path.parent.mkdir(parents=True, exist_ok=True)
    clean = {k: (str(v) if isinstance(v, Path) else v) for k, v in data.items()}
    with open(path, "w", errors="ignore", encoding="utf-8") as f:
        yaml.safe_dump(clean, f, sort_keys=False, allow_unicode=True)


def increment_path(path, exist_ok=False, sep="", mkdir=False):
    """Return an incremented path, e.g. runs/exp -> runs/exp2, runs/exp3, ..."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def get_latest_run(search_dir="runs/detect"):
    """The most recent 'last.npz' under search_dir by creation time (train10 after train9), or ""."""
    runs = list(Path(search_dir).glob("*/weights/last.npz"))
    return max(runs, key=lambda p: p.stat().st_ctime) if runs else ""


def select_device(device=None):
    """Resolve a device argument to a torch.device. None means 'cuda'.

    A CUDA device that is not there raises: the port never drops to the CPU
    on its own. Pass device='cpu' to run on the CPU.
    """
    import torch

    dev = torch.device("cuda" if device in (None, "") else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device or 'cuda')!r} needs a CUDA card and none is visible; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device={dev} out of range: {torch.cuda.device_count()} card(s) visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda', 'cuda:N' or 'cpu'")
    return dev
