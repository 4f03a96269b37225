"""Argument and environment checks (port of yololite_tpu/utils/checks.py)."""

from __future__ import annotations

import math
from typing import List, Union

from yololite_tpu_torch.utils import LOGGER


def check_imgsz(imgsz: Union[int, List[int]], stride: int = 32, min_dim: int = 1, max_dim: int = 2, floor: int = 0):
    """Round image size up to a multiple of the max stride."""
    stride = int(stride)
    if isinstance(imgsz, int):
        imgsz = [imgsz]
    elif isinstance(imgsz, (list, tuple)):
        imgsz = list(imgsz)
    else:
        raise TypeError(f"imgsz={imgsz} must be int or list")
    if len(imgsz) > max_dim:
        raise ValueError(f"imgsz={imgsz} has too many dimensions (max {max_dim})")
    sz = [max(math.ceil(x / stride) * stride, floor) for x in imgsz]
    if sz != list(imgsz):
        LOGGER.warning(f"imgsz={imgsz} must be multiple of max stride {stride}, updating to {sz}")
    sz = [sz[0], sz[0]] if min_dim == 2 and len(sz) == 1 else sz[0] if min_dim == 1 and len(sz) == 1 else sz
    return sz


def check_version(current: str, required: str) -> bool:
    """True if current version >= required (simple dotted compare)."""

    def parse(v):
        return tuple(int("".join(c for c in x if c.isdigit()) or 0) for x in v.split("."))

    return parse(current) >= parse(required)


def is_ascii(s) -> bool:
    """True if the string is pure ASCII."""
    return all(ord(c) < 128 for c in str(s))


def check_imshow(warn: bool = False) -> bool:
    """True if the environment supports cv2 image display."""
    import os
    import platform

    import cv2
    import numpy as np

    try:
        if platform.system() == "Linux":
            assert "DISPLAY" in os.environ, "The DISPLAY environment variable isn't set."
        cv2.imshow("test", np.zeros((8, 8, 3), np.uint8))
        cv2.waitKey(1)
        cv2.destroyAllWindows()
        cv2.waitKey(1)
        return True
    except Exception as e:
        if warn:
            LOGGER.warning(f"Environment does not support cv2.imshow() or PIL Image.show()\n{e}")
        return False


def print_args(args: dict = None, show_file: bool = True, show_func: bool = False):
    """Log the calling function's arguments as 'file: k=v, ...'."""
    import inspect
    from pathlib import Path

    from yololite_tpu_torch.utils import colorstr

    frame = inspect.currentframe().f_back
    file, _, func, _, _ = inspect.getframeinfo(frame)
    if args is None:  # collect the caller's own locals that are parameters
        argnames, _, _, frm = inspect.getargvalues(frame)
        args = {k: v for k, v in frm.items() if k in argnames}
    try:
        file = Path(file).resolve().relative_to(Path(__file__).resolve().parents[2]).with_suffix("")
    except ValueError:
        file = Path(file).stem
    s = (f"{file}: " if show_file else "") + (f"{func}: " if show_func else "")
    LOGGER.info(colorstr(s) + ", ".join(f"{k}={v}" for k, v in args.items()))


def parse_version(version: str = "0.0.0") -> tuple:
    """Version string -> (major, minor, patch) ints, junk-tolerant."""
    import re

    try:
        return tuple(map(int, re.findall(r"\d+", version)[:3]))
    except Exception as e:
        LOGGER.warning(f"parse_version({version!r}) failed, returning (0, 0, 0): {e}")
        return 0, 0, 0


def parse_requirements(file_path=None, package: str = ""):
    """Parse a requirements.txt (or an installed package's requirement list) into
    [SimpleNamespace(name, specifier), ...].

    Comment lines and inline comments are stripped. Nothing is installed: the
    list is for reporting the environment.
    """
    import re
    from importlib import metadata
    from pathlib import Path
    from types import SimpleNamespace

    if package:
        requires = [x for x in (metadata.distribution(package).requires or []) if "extra == " not in x]
    else:
        requires = Path(file_path).read_text().splitlines()

    requirements = []
    for line in requires:
        line = line.strip()
        if line and not line.startswith("#"):
            line = line.split("#")[0].strip()
            match = re.match(r"([a-zA-Z0-9-_]+)\s*([<>!=~]+.*)?", line)
            if match:
                requirements.append(SimpleNamespace(name=match[1], specifier=match[2].strip() if match[2] else ""))
    return requirements
