"""Dataset utilities: yaml validation, label file verification, cache IO.

Port of yololite_tpu/data/utils.py. The label cache has the same format
(`np.save` of a dict of numpy arrays, strings and tuples), so either package
reads the other's file; unpickling it imports numpy only. A dataset yaml is
resolved only at the path given.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from yololite_tpu_torch.data.loaders import IMG_FORMATS
from yololite_tpu_torch.utils import LOGGER, yaml_load


def img2label_paths(img_paths: List[str]) -> List[str]:
    """/images/ -> /labels/ and suffix -> .txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def get_hash(paths: List[str]) -> str:
    """Size+name hash of a list of files (cache invalidation key)."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.sha256(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def exif_size(img) -> Tuple[int, int]:
    """EXIF-orientation-corrected PIL size (w, h)."""
    s = img.size  # (width, height)
    if img.format == "JPEG":  # orientation tag is JPEG-only
        try:
            exif = img.getexif()
            if exif:
                rotation = exif.get(274, None)  # 274 = EXIF orientation
                if rotation in {6, 8}:  # 270 / 90 degrees
                    s = s[1], s[0]
        except Exception:  # a malformed EXIF block leaves the plain size
            pass
    return s


def verify_image_label(im_file: str, lb_file: str, num_cls: int) -> Tuple:
    """Validate one image/label pair, never raising.

    Returns (im_file, cls (n,1), bboxes (n,4), shape, nm, nf, ne, nc, msg) where
    nm/nf/ne/nc are 0/1 missing/found/empty/corrupt flags. On any failure the
    first four fields are None and nc=1, so the caller skips the file and goes
    on: one truncated JPEG or garbage label file must not abort the cache build.
    """
    nm = nf = ne = 0
    msg = ""
    try:
        from PIL import Image, ImageOps

        with Image.open(im_file) as im:  # verify catches undecodable headers without a full decode
            im.verify()
            fmt = (im.format or "").lower()
            w, h = exif_size(im)
        shape = (h, w)
        if shape[0] < 10 or shape[1] < 10:
            raise ValueError(f"image size {shape} <10 pixels")
        if fmt not in IMG_FORMATS:
            raise ValueError(f"invalid image format {fmt}")
        if fmt in {"jpg", "jpeg"}:  # truncated-JPEG detection
            with open(im_file, "rb") as f:
                f.seek(-2, 2)
                truncated = f.read() != b"\xff\xd9"
            if truncated:
                try:
                    ImageOps.exif_transpose(Image.open(im_file)).save(im_file, "JPEG", subsampling=0, quality=100)
                    msg = f"{im_file}: corrupt JPEG restored and saved"
                except Exception as e:
                    raise ValueError(f"corrupt JPEG (restore failed: {e})") from e

        if os.path.isfile(lb_file):
            nf = 1
            with open(lb_file, encoding="utf-8") as f:
                lb = [x.split() for x in f.read().strip().splitlines() if len(x)]
            lb = np.array(lb, dtype=np.float32) if lb else np.zeros((0, 5), np.float32)
            nl = len(lb)
            if nl:
                if lb.ndim != 2 or lb.shape[1] != 5:
                    raise ValueError(f"labels require 5 columns: {lb_file}")
                if lb.min() < 0:
                    raise ValueError(f"negative label values in {lb_file}")
                if lb[:, 1:].max() > 1:
                    raise ValueError(f"non-normalized coordinates in {lb_file}")
                if int(lb[:, 0].max()) >= num_cls:
                    raise ValueError(f"class {int(lb[:, 0].max())} exceeds nc={num_cls} in {lb_file}")
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < nl:
                    lb = lb[np.sort(idx)]
                    msg = f"removed {nl - len(idx)} duplicate labels: {lb_file}"
            else:
                ne = 1
        else:
            nm = 1
            lb = np.zeros((0, 5), np.float32)
        return im_file, lb[:, 0:1], lb[:, 1:5], shape, nm, nf, ne, 0, msg
    except Exception as e:  # per-file boundary: report and skip, keep scanning
        return None, None, None, None, nm, nf, ne, 1, f"{im_file}: ignoring corrupt image/label: {e}"


def check_det_dataset(dataset: str) -> Dict:
    """Resolve and validate a detection dataset yaml -> dict with absolute paths.

    Paths in the yaml resolve relative to its `path` key, or to the yaml's own
    directory; `names` may be a list or a dict, or `nc` alone.
    """
    yaml_path = Path(dataset)
    if not yaml_path.exists():
        raise FileNotFoundError(f"dataset yaml '{dataset}' not found")
    data = yaml_load(yaml_path, append_filename=True)

    if "val" not in data and "validation" not in data:
        raise SyntaxError("dataset yaml missing 'val' key")
    if "names" not in data and "nc" not in data:
        raise SyntaxError("dataset yaml must define 'names' or 'nc'")
    if isinstance(data.get("names"), (list, tuple)):
        data["names"] = dict(enumerate(data["names"]))
    if "names" not in data:
        data["names"] = {i: f"class_{i}" for i in range(data["nc"])}
    data["nc"] = len(data["names"])

    root = Path(data.get("path") or Path(data["yaml_file"]).parent)
    if not root.is_absolute():
        root = (Path(data["yaml_file"]).parent / root).resolve()
    data["path"] = root
    for k in ("train", "val", "test"):
        if data.get(k):
            data[k] = str(root / data[k]) if not Path(data[k]).is_absolute() else data[k]
    for k in ("train", "val"):
        if data.get(k) and not Path(data[k]).exists():
            raise FileNotFoundError(f"dataset '{k}' path does not exist: {data[k]}")
    return data


def find_dataset_yaml(path: Path) -> Path:
    """Locate the single dataset yaml under `path`: root level first, then recursive;
    same-stem files preferred on ambiguity."""
    path = Path(path)
    files = list(path.glob("*.yaml")) or list(path.rglob("*.yaml"))
    if not files:
        raise FileNotFoundError(f"No YAML file found in '{path.resolve()}'")
    if len(files) > 1:
        same_stem = [f for f in files if f.stem == path.stem]
        files = same_stem or files
    if len(files) != 1:
        raise ValueError(f"Expected 1 YAML file in '{path.resolve()}', found {len(files)}: {files}")
    return files[0]


def load_dataset_cache_file(path) -> Dict:
    """Load a dataset label cache."""
    import gc

    gc.disable()  # pickle loads measurably faster without the collector
    try:
        return np.load(str(path), allow_pickle=True).item()
    finally:
        gc.enable()


def save_dataset_cache_file(prefix: str, path, x: Dict) -> None:
    """Write a dataset label cache if the directory allows it."""
    path = Path(path)
    if os.access(str(path.parent), os.W_OK):
        np.save(str(path), x)
        if path.suffix != ".npy":  # np.save appends .npy; restore the requested name
            path.with_suffix(path.suffix + ".npy").rename(path)
        LOGGER.info(f"{prefix}New cache created: {path}")
    else:
        LOGGER.warning(f"{prefix}Cache directory {path.parent} is not writeable, cache not saved.")
