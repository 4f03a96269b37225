"""Plotting for predict results: palette, box annotator, crops, feature maps.

The part of yololite_tpu/utils/plotting.py that Results and the predictor use.
cv2, PIL and matplotlib are imported only when something is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


class Colors:
    """Ultralytics-style fixed palette, indexed by class id."""

    def __init__(self):
        hexs = (
            "042AFF", "0BDBEB", "F3F3F3", "00DFB7", "111F68", "FF6FDD", "FF444F",
            "CCED00", "00F344", "BD00FF", "00B4FF", "DD00BA", "00FFFF", "26C000",
            "01FFB3", "7D24FF", "7B0068", "FF1B6C", "FC6D2F", "A2FF0B",
        )
        self.palette = [self.hex2rgb(f"#{c}") for c in hexs]
        self.n = len(self.palette)

    @staticmethod
    def hex2rgb(h):
        return tuple(int(h[1 + i : 1 + i + 2], 16) for i in (0, 2, 4))

    def __call__(self, i, bgr=False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


# Label backgrounds treated as "dark"/"light" when auto-picking the label text color.
_DARK_BGS = {
    (235, 219, 11), (243, 243, 243), (183, 223, 0), (221, 111, 255), (0, 237, 204),
    (68, 243, 0), (255, 255, 0), (179, 255, 1), (11, 255, 162),
}
_LIGHT_BGS = {
    (255, 42, 4), (79, 68, 255), (255, 0, 189), (255, 180, 0), (186, 0, 221),
    (0, 192, 38), (255, 36, 125), (104, 0, 123), (108, 27, 255), (47, 109, 252),
    (104, 31, 17),
}


class Annotator:
    """Box/label drawing on a BGR uint8 image (cv2 by default, PIL for non-ASCII labels)."""

    def __init__(self, im, line_width: Optional[int] = None, font_size: Optional[float] = None,
                 font: str = "Arial.ttf", pil: bool = False, example: str = "abc"):
        from yololite_tpu_torch.utils.checks import is_ascii

        self.pil = pil or not is_ascii(example)
        if self.pil:
            from PIL import Image, ImageDraw, ImageFont

            self.im = im if isinstance(im, Image.Image) else Image.fromarray(im)
            self.draw = ImageDraw.Draw(self.im)
            self.font = ImageFont.load_default()
            self.lw = line_width or max(round(sum(self.im.size) / 2 * 0.003), 2)
        else:
            import cv2

            self.cv2 = cv2
            self.im = np.ascontiguousarray(im)
            self.lw = line_width or max(round(sum(im.shape[:2]) / 2 * 0.003), 2)
        self.tf = max(self.lw - 1, 1)  # font thickness
        self.fs = font_size or self.tf * 0.4  # font scale (getTextSize/putText)

    def _text_wh(self, text: str):
        """(width, height) of `text` in the PIL font."""
        box = self.font.getbbox(text)
        return box[2] - box[0], box[3] - box[1]

    def get_txt_color(self, color=(128, 128, 128), txt_color=(255, 255, 255)):
        """Pick a readable text color for the given label background."""
        if color in _DARK_BGS:
            return 104, 31, 17
        if color in _LIGHT_BGS:
            return 255, 255, 255
        return txt_color

    def box_label(self, box, label=None, color=(128, 128, 128), txt_color=(255, 255, 255)):
        """Draw an xyxy box with an optional filled label."""
        txt_color = self.get_txt_color(color, txt_color)
        if self.pil:
            p1 = (box[0], box[1])
            self.draw.rectangle(tuple(box), width=self.lw, outline=color)
            if label:
                w, h = self._text_wh(label)
                outside = p1[1] >= h
                if p1[0] > self.im.size[0] - w:  # keep the label on-image
                    p1 = (self.im.size[0] - w, p1[1])
                ytop = p1[1] - h if outside else p1[1]
                self.draw.rectangle((p1[0], ytop, p1[0] + w + 1, ytop + h + 1), fill=color)
                self.draw.text((p1[0], ytop), label, fill=txt_color, font=self.font)
            return
        cv2 = self.cv2
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        cv2.rectangle(self.im, p1, p2, color, thickness=self.lw, lineType=cv2.LINE_AA)
        if label:
            w, h = cv2.getTextSize(label, 0, fontScale=self.fs, thickness=self.tf)[0]
            h += 3
            outside = p1[1] >= h
            if p1[0] > self.im.shape[1] - w:  # clamp so the label stays on-image
                p1 = (self.im.shape[1] - w, p1[1])
            p2t = (p1[0] + w, p1[1] - h if outside else p1[1] + h)
            cv2.rectangle(self.im, p1, p2t, color, -1, cv2.LINE_AA)
            cv2.putText(
                self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h - 1),
                0, self.fs, txt_color, thickness=self.tf, lineType=cv2.LINE_AA,
            )

    def result(self) -> np.ndarray:
        return np.asarray(self.im)

    def show(self, title=None):
        """Display the annotated image (BGR -> RGB) via PIL."""
        from PIL import Image

        Image.fromarray(np.asarray(self.im)[..., ::-1]).show(title=title)

    def save(self, filename="image.jpg"):
        from yololite_tpu_torch.utils.patches import imwrite

        imwrite(str(filename), np.asarray(self.im))


def feature_visualization(x, module_type: str, stage: int, n: int = 32, save_dir=Path("runs/detect/exp")):
    """Save a grid of the first n channel maps of an NHWC feature array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(x)
    if x.ndim != 4:
        return
    _, h, w, c = x.shape
    if h <= 1 or w <= 1:
        return
    n = min(n, c)
    fig, axes = plt.subplots(int(np.ceil(n / 8)), 8, figsize=(12, 2 * int(np.ceil(n / 8))), squeeze=False)
    for i in range(n):
        ax = axes[i // 8][i % 8]
        ax.imshow(x[0, :, :, i])
        ax.axis("off")
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    f = Path(save_dir) / f"stage{stage}_{module_type.split('.')[-1]}_features.png"
    fig.savefig(f, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return f


def save_one_box(xyxy, im, file=Path("im.jpg"), gain=1.02, pad=10, square=False, BGR=False, save=True):
    """Crop a box from `im` (gain/pad/square/clip as upstream) and optionally save it (RGB, quality 95).

    xyxy: (4,) or (1,4) box; im: HWC uint8 (BGR, cv2 convention). Returns the crop.
    """
    from yololite_tpu_torch.ops.boxes import clip_boxes_np, xywh2xyxy, xyxy2xywh
    from yololite_tpu_torch.utils import increment_path

    b = xyxy2xywh(np.asarray(xyxy, np.float32).reshape(-1, 4))
    if square:
        b[:, 2:] = b[:, 2:].max(1, keepdims=True)  # rectangle to square
    b[:, 2:] = b[:, 2:] * gain + pad  # box wh * gain + pad
    out = xywh2xyxy(b).astype(np.int64).astype(np.float32)
    out = clip_boxes_np(out, im.shape).astype(int)
    crop = im[out[0, 1] : out[0, 3], out[0, 0] : out[0, 2], :: (1 if BGR else -1)]
    if save:
        from PIL import Image

        file = Path(file)
        file.parent.mkdir(parents=True, exist_ok=True)
        f = str(increment_path(file).with_suffix(".jpg"))
        Image.fromarray(crop[..., ::-1]).save(f, quality=95, subsampling=0)  # save RGB
    return crop
