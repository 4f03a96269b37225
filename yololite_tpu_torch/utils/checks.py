"""Argument checks (port of yololite_tpu/utils/checks.py, the part predict needs)."""

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


def is_ascii(s) -> bool:
    """True if the string is pure ASCII."""
    return all(ord(c) < 128 for c in str(s))
