"""Unicode-safe image IO (port of yololite_tpu/utils/patches.py).

Bytes go through numpy (`np.fromfile` / `ndarray.tofile`) and cv2 only sees an
in-memory buffer. cv2 is imported inside each function, so importing this
module does not need OpenCV.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def imread(filename, flags: int = None):
    """Read an image as BGR, or None on unreadable/undecodable input (cv2.imread's contract)."""
    import cv2

    try:
        buf = np.fromfile(str(filename), np.uint8)
    except (OSError, FileNotFoundError):
        return None
    if buf.size == 0:
        return None
    return cv2.imdecode(buf, cv2.IMREAD_COLOR if flags is None else flags)


def imwrite(filename, img: np.ndarray, params=None) -> bool:
    """Write an image via imencode + tofile; returns success like cv2.imwrite."""
    import cv2

    try:
        ok, buf = cv2.imencode(Path(str(filename)).suffix, img, params or [])
        if not ok:
            return False
        buf.tofile(str(filename))
        return True
    except (cv2.error, OSError):
        return False


def imshow(winname: str, mat: np.ndarray) -> None:
    """cv2.imshow with a unicode-escaped window title."""
    import cv2

    cv2.imshow(winname.encode("unicode_escape").decode(), mat)
