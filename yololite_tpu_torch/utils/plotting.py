"""Plotting utilities: color palette, box annotator, batch mosaics, result curves (port of
yololite_tpu/utils/plotting.py).

Host-side numpy with cv2, PIL and matplotlib, each imported only when
something is drawn, so the predict path runs without them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

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
    """Box/label drawing on a BGR uint8 image (cv2 default, PIL for non-ASCII).

    Draws with cv2 unless `pil=True`, the `example` label text is not ASCII,
    or the input is a PIL Image: then it draws in a PIL context with the
    default bitmap font. Detection only: no pose-keypoint skeleton.
    """

    def __init__(self, im, line_width: Optional[int] = None, font_size: Optional[float] = None,
                 font: str = "Arial.ttf", pil: bool = False, example: str = "abc"):
        from yololite_tpu_torch.utils.checks import is_ascii

        try:
            from PIL import Image

            input_is_pil = isinstance(im, Image.Image)
        except ImportError:  # pragma: no cover
            input_is_pil = False
        self.pil = pil or not is_ascii(example) or input_is_pil
        if self.pil:
            from PIL import Image, ImageDraw, ImageFont

            self.im = im if input_is_pil else Image.fromarray(im)
            self.draw = ImageDraw.Draw(self.im)
            self.font = ImageFont.load_default()
            self.lw = line_width or max(round(sum(self.im.size) / 2 * 0.003), 2)
        else:
            self.im = np.ascontiguousarray(im)
            self.lw = line_width or max(round(sum(im.shape[:2]) / 2 * 0.003), 2)
        self.tf = max(self.lw - 1, 1)  # font thickness
        self.fs = font_size or self.tf * 0.4  # font scale (getTextSize/putText)

    @property
    def cv2(self):
        """OpenCV, imported at the first draw that needs it."""
        import cv2

        return cv2

    def _text_wh(self, text: str):
        """(width, height) of `text` in the PIL font (getbbox; PIL>=9.2 safe)."""
        box = self.font.getbbox(text)
        return box[2] - box[0], box[3] - box[1]

    def get_txt_color(self, color=(128, 128, 128), txt_color=(255, 255, 255)):
        """Pick a readable text color for the given label background."""
        if color in _DARK_BGS:
            return 104, 31, 17
        if color in _LIGHT_BGS:
            return 255, 255, 255
        return txt_color

    def box_label(self, box, label=None, color=(128, 128, 128), txt_color=(255, 255, 255), rotated=False):
        """Draw a (possibly rotated) box with an optional filled label."""
        cv2 = self.cv2
        txt_color = self.get_txt_color(color, txt_color)
        if self.pil:  # non-ASCII-safe branch
            if rotated:
                p1 = tuple(box[0])
                self.draw.polygon([tuple(b) for b in box], width=self.lw, outline=color)
            else:
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
        if rotated:
            pts = np.asarray(box, dtype=int)
            p1 = (int(pts[0][0]), int(pts[0][1]))
            cv2.polylines(self.im, [pts], True, color, self.lw)
        else:
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

    def circle_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255), margin=2):
        """Label on a filled circle centered in the box."""
        cv2 = self.cv2
        if len(label) > 3:
            label = label[:3]  # circle fits at most 3 characters
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        (tw, th), _ = cv2.getTextSize(str(label), cv2.FONT_HERSHEY_SIMPLEX, self.fs, self.tf)
        radius = int(((tw**2 + th**2) ** 0.5) / 2) + margin
        cv2.circle(self.im, (cx, cy), radius, color, -1)
        cv2.putText(self.im, str(label), (cx - tw // 2, cy + th // 2), cv2.FONT_HERSHEY_SIMPLEX,
                    self.fs, self.get_txt_color(color, txt_color), self.tf, lineType=cv2.LINE_AA)

    def text_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255), margin=5):
        """Label on a filled rectangle centered in the box."""
        cv2 = self.cv2
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, self.fs, self.tf)
        tx, ty = cx - tw // 2, cy + th // 2
        cv2.rectangle(self.im, (tx - margin, ty - th - margin), (tx + tw + margin, ty + margin), color, -1)
        cv2.putText(self.im, label, (tx, ty), cv2.FONT_HERSHEY_SIMPLEX, self.fs,
                    self.get_txt_color(color, txt_color), self.tf, lineType=cv2.LINE_AA)

    def text(self, xy, text, txt_color=(255, 255, 255), box_style=False):
        """Free text at xy, optionally on a filled background."""
        cv2 = self.cv2
        xy = (int(xy[0]), int(xy[1]))
        if self.pil:
            if box_style:
                w, h = self._text_wh(text)
                self.draw.rectangle((xy[0], xy[1], xy[0] + w + 1, xy[1] + h + 1), fill=txt_color)
                txt_color = (255, 255, 255)  # background color becomes the fill; text goes white
            if "\n" in text:
                _, h = self._text_wh(text)
                for j, line in enumerate(text.split("\n")):
                    self.draw.text((xy[0], xy[1] + j * h), line, fill=txt_color, font=self.font)
            else:
                self.draw.text(xy, text, fill=txt_color, font=self.font)
            return
        if box_style:
            w, h = cv2.getTextSize(text, 0, fontScale=self.fs, thickness=self.tf)[0]
            h += 3
            outside = xy[1] >= h
            cv2.rectangle(self.im, xy, (xy[0] + w, xy[1] - h if outside else xy[1] + h), txt_color, -1, cv2.LINE_AA)
            txt_color = (255, 255, 255)
        cv2.putText(self.im, text, xy, 0, self.fs, txt_color, thickness=self.tf, lineType=cv2.LINE_AA)

    def rectangle(self, xy, fill=None, outline=None, width=1):
        """Plain rectangle; xy = (x1, y1, x2, y2)."""
        if self.pil:
            self.draw.rectangle(tuple(xy), fill, outline, width)
            return
        p1, p2 = (int(xy[0]), int(xy[1])), (int(xy[2]), int(xy[3]))
        if fill is not None:
            self.cv2.rectangle(self.im, p1, p2, fill, -1)
        if outline is not None:
            self.cv2.rectangle(self.im, p1, p2, outline, width)

    def fromarray(self, im):
        """Replace the working image."""
        if self.pil:
            from PIL import Image, ImageDraw

            self.im = im if isinstance(im, Image.Image) else Image.fromarray(im)
            self.draw = ImageDraw.Draw(self.im)
        else:
            self.im = np.ascontiguousarray(im)

    def result(self) -> np.ndarray:
        return np.asarray(self.im)

    def show(self, title=None):
        """Display the annotated image (BGR -> RGB) via PIL."""
        from PIL import Image

        Image.fromarray(np.asarray(self.im)[..., ::-1]).show(title=title)

    def save(self, filename="image.jpg"):
        from yololite_tpu_torch.utils.patches import imwrite

        imwrite(str(filename), np.asarray(self.im))

    @staticmethod
    def get_bbox_dimension(bbox):
        """(width, height, area) of an xyxy box."""
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        return w, h, w * h

    def draw_region(self, reg_pts, color=(0, 255, 0), thickness=5):
        """Closed polygon region with corner dots."""
        pts = np.asarray(reg_pts, dtype=np.int32)
        self.cv2.polylines(self.im, [pts], isClosed=True, color=color, thickness=thickness)
        for x, y in pts:
            self.cv2.circle(self.im, (int(x), int(y)), thickness * 2, color, -1)

    def draw_centroid_and_tracks(self, track, color=(255, 0, 255), track_thickness=2):
        """Polyline trail + centroid dot for a track."""
        pts = np.hstack(track).astype(np.int32).reshape(-1, 1, 2)
        self.cv2.polylines(self.im, [pts], isClosed=False, color=color, thickness=track_thickness)
        self.cv2.circle(self.im, (int(track[-1][0]), int(track[-1][1])), track_thickness * 2, color, -1)

    def visioneye(self, box, center_point, color=(235, 219, 11), pin_color=(255, 0, 255)):
        """Eye-to-object mapping line."""
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        self.cv2.circle(self.im, center_point, self.tf * 2, pin_color, -1)
        self.cv2.circle(self.im, (cx, cy), self.tf * 2, color, -1)
        self.cv2.line(self.im, center_point, (cx, cy), color, self.tf)

    # ---- solutions helpers (queue/parking/workout/distance apps; cv2-only) ----

    def _boxed_text(self, im, text, center, txt_color, bg_color, margin):
        """Text centered at `center` on a filled margin rectangle."""
        (tw, th), _ = self.cv2.getTextSize(text, 0, self.fs, self.tf)
        tx, ty = int(center[0]) - tw // 2, int(center[1]) + th // 2
        self.cv2.rectangle(im, (tx - margin, ty - th - margin), (tx + tw + margin, ty + margin), bg_color, -1)
        self.cv2.putText(im, text, (tx, ty), 0, self.fs, txt_color, self.tf, lineType=self.cv2.LINE_AA)

    def queue_counts_display(self, label, points=None, region_color=(255, 255, 255), txt_color=(0, 0, 0)):
        """Queue-count label centered on a region polygon."""
        cx = sum(p[0] for p in points) // len(points)
        cy = sum(p[1] for p in points) // len(points)
        self._boxed_text(self.im, label, (cx, cy), txt_color, region_color, margin=10)

    def display_objects_labels(self, im0, text, txt_color, bg_color, x_center, y_center, margin):
        """Parking-app style label at a box center."""
        self._boxed_text(im0, text, (x_center, y_center), txt_color, bg_color, margin)

    def display_analytics(self, im0, text, txt_color, bg_color, margin):
        """Right-aligned stacked stats labels."""
        hgap = int(im0.shape[1] * 0.02)
        vgap = int(im0.shape[0] * 0.01)
        y_off = 0
        for label, value in text.items():
            txt = f"{label}: {value}"
            (tw, th), _ = self.cv2.getTextSize(txt, 0, self.fs, self.tf)
            tw, th = max(tw, 5), max(th, 5)
            tx = im0.shape[1] - tw - margin * 2 - hgap
            ty = y_off + th + margin * 2 + vgap
            self.cv2.rectangle(im0, (tx - margin * 2, ty - th - margin * 2),
                               (tx + tw + margin * 2, ty + margin * 2), bg_color, -1)
            self.cv2.putText(im0, txt, (tx, ty), 0, self.fs, txt_color, self.tf, lineType=self.cv2.LINE_AA)
            y_off = ty + margin * 2

    @staticmethod
    def estimate_pose_angle(a, b, c):
        """Angle at point b formed by keypoints a-b-c, in [0, 180] degrees
       ."""
        a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
        rad = np.arctan2(c[1] - b[1], c[0] - b[0]) - np.arctan2(a[1] - b[1], a[0] - b[0])
        deg = abs(float(rad) * 180.0 / np.pi)
        return 360.0 - deg if deg > 180.0 else deg

    def plot_workout_information(self, display_text, position, color=(104, 31, 17), txt_color=(255, 255, 255)):
        """Text with filled background at `position`; returns the text height
       ."""
        (tw, th), _ = self.cv2.getTextSize(display_text, 0, self.fs, self.tf)
        self.cv2.rectangle(self.im, (position[0], position[1] - th - 5),
                           (position[0] + tw + 10, position[1] + 10 + self.tf), color, -1)
        self.cv2.putText(self.im, display_text, position, 0, self.fs, txt_color, self.tf)
        return th

    def plot_angle_and_count_and_stage(self, angle_text, count_text, stage_text, center_kpt,
                                       color=(104, 31, 17), txt_color=(255, 255, 255)):
        """Stacked workout-monitor labels under a keypoint."""
        angle_text, count_text, stage_text = f" {angle_text:.2f}", f"Steps : {count_text}", f" {stage_text}"
        x, y = int(center_kpt[0]), int(center_kpt[1])
        ah = self.plot_workout_information(angle_text, (x, y), color, txt_color)
        ch = self.plot_workout_information(count_text, (x, y + ah + 20), color, txt_color)
        self.plot_workout_information(stage_text, (x, y + ah + ch + 40), color, txt_color)

    def plot_distance_and_line(self, pixels_distance, centroids,
                               line_color=(104, 31, 17), centroid_color=(255, 0, 255)):
        """Distance readout + centroid-connecting line."""
        text = f"Pixels Distance: {pixels_distance:.2f}"
        (tw, th), _ = self.cv2.getTextSize(text, 0, self.fs, self.tf)
        self.cv2.rectangle(self.im, (15, 25), (15 + tw + 20, 25 + th + 20), line_color, -1)
        self.cv2.putText(self.im, text, (25, 25 + th + 10), 0, self.fs, (255, 255, 255),
                         self.tf, self.cv2.LINE_AA)
        self.cv2.line(self.im, tuple(centroids[0]), tuple(centroids[1]), line_color, 3)
        self.cv2.circle(self.im, tuple(centroids[0]), 6, centroid_color, -1)
        self.cv2.circle(self.im, tuple(centroids[1]), 6, centroid_color, -1)


def plot_images(images: np.ndarray, batch_idx, cls, bboxes, paths=None, fname="batch.jpg", names=None,
                max_subplots=16, conf=None):
    """Save a grid mosaic of images with their (normalized-or-pixel) xywh boxes.

    images: (B, H, W, 3) float [0,1] or uint8 NHWC.
    """
    import cv2

    bs = min(len(images), max_subplots)
    ns = int(np.ceil(bs**0.5))
    h, w = images.shape[1:3]
    if images.dtype != np.uint8:
        images = (images * 255).astype(np.uint8)
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        r, c = i // ns, i % ns
        mosaic[r * h : (r + 1) * h, c * w : (c + 1) * w] = images[i][..., ::-1]  # RGB->BGR
    ann = Annotator(mosaic, line_width=2)
    for i in range(bs):
        r, c = i // ns, i % ns
        ox, oy = c * w, r * h
        sel = np.asarray(batch_idx) == i
        for b, k in zip(np.asarray(bboxes)[sel], np.asarray(cls)[sel]):
            cx, cy, bw, bh = b[:4]
            if max(b[:4]) <= 1.1:  # normalized
                cx, cy, bw, bh = cx * w, cy * h, bw * w, bh * h
            box = (ox + cx - bw / 2, oy + cy - bh / 2, ox + cx + bw / 2, oy + cy + bh / 2)
            name = (names or {}).get(int(k), str(int(k)))
            ann.box_label(box, name, color=colors(int(k), True))
    Path(fname).parent.mkdir(parents=True, exist_ok=True)
    from yololite_tpu_torch.utils.patches import imwrite

    imwrite(str(fname), ann.result())


def plot_results(csv_file="results.csv", dir_=""):
    """Plot training curves from results.csv (loss/metric columns over epochs)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    csv_file = Path(csv_file)
    import csv as _csv

    with open(csv_file) as f:
        rows = list(_csv.reader(f))
    header = [h.strip() for h in rows[0]]
    data = np.array([[float(v) for v in r] for r in rows[1:]], dtype=np.float64)
    n = len(header) - 1
    ncols = min(n, 5)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, name in enumerate(header[1:]):
        ax = axes[i // ncols][i % ncols]
        ax.plot(data[:, 0], data[:, i + 1], marker=".")
        ax.set_title(name, fontsize=9)
    fig.tight_layout()
    out = csv_file.with_name("results.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def feature_visualization(x, module_type: str, stage: int, n: int = 32, save_dir=Path("runs/detect/exp")):
    """Save a grid of the first n channel maps of a feature tensor (NHWC)."""
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


def plot_labels(boxes: np.ndarray, cls: np.ndarray, names: Dict[int, str], save_dir=Path(".")):
    """Histogram of classes + box w/h scatter, saved as labels.jpg."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    if len(cls):
        axes[0].hist(cls, bins=max(int(cls.max()) + 1, 1))
    axes[0].set_title("classes")
    if len(boxes):
        axes[1].scatter(boxes[:, 2], boxes[:, 3], s=2, alpha=0.4)
    axes[1].set_title("wh")
    fig.tight_layout()
    fig.savefig(save_dir / "labels.jpg", dpi=150)
    plt.close(fig)


def save_one_box(xyxy, im, file=Path("im.jpg"), gain=1.02, pad=10, square=False, BGR=False, save=True):
    """Crop a box from `im` (widened by gain and pad, optionally square, clipped to the image)
    and optionally save it (RGB, quality 95).

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


def plt_color_scatter(v, f, bins=20, cmap="viridis", alpha=0.8, edgecolors="none"):
    """Scatter plot colored by 2D-histogram density."""
    import matplotlib.pyplot as plt

    v = np.asarray(v, float)
    f = np.asarray(f, float)
    hist, xedges, yedges = np.histogram2d(v, f, bins=bins)
    colors = [
        hist[
            min(np.digitize(v[i], xedges, right=True) - 1, hist.shape[0] - 1),
            min(np.digitize(f[i], yedges, right=True) - 1, hist.shape[1] - 1),
        ]
        for i in range(len(v))
    ]
    plt.scatter(v, f, c=colors, cmap=cmap, alpha=alpha, edgecolors=edgecolors)


def plot_tune_results(csv_file="tune_results.csv"):
    """Scatter+fitness plots for hyperparameter tuning CSVs."""
    import math as _math

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from yololite_tpu_torch.utils import LOGGER

    def _save_one_file(file):
        plt.savefig(file, dpi=200)
        plt.close()
        LOGGER.info(f"Saved {file}")

    csv_file = Path(csv_file)
    import csv as _csv

    with open(csv_file) as fh:
        reader = _csv.reader(fh)
        header = [h.strip() for h in next(reader)]
        data = np.array([[float(v) for v in row] for row in reader])
    keys = header[1:]
    fitness = data[:, 0]
    j = int(np.argmax(fitness))
    n = _math.ceil(len(keys) ** 0.5)
    plt.figure(figsize=(10, 10), tight_layout=True)
    for i, k in enumerate(keys):
        v = data[:, i + 1]
        mu = v[j]
        plt.subplot(n, n, i + 1)
        plt_color_scatter(v, fitness, cmap="viridis", alpha=0.8, edgecolors="none")
        plt.plot(mu, fitness.max(), "k+", markersize=15)
        plt.title(f"{k} = {mu:.3g}", fontdict={"size": 9})
        plt.tick_params(axis="both", labelsize=8)
        if i % n != 0:
            plt.yticks([])
    _save_one_file(csv_file.with_name("tune_scatter_plots.png"))

    x = range(1, len(fitness) + 1)
    try:
        from scipy.ndimage import gaussian_filter1d

        smoothed = gaussian_filter1d(fitness, sigma=3)
    except ImportError:  # pragma: no cover
        k = np.ones(5) / 5
        smoothed = np.convolve(fitness, k, mode="same")
    plt.figure(figsize=(10, 6), tight_layout=True)
    plt.plot(x, fitness, marker="o", linestyle="none", label="fitness")
    plt.plot(x, smoothed, ":", label="smoothed", linewidth=2)
    plt.title("Fitness vs Iteration")
    plt.xlabel("Iteration")
    plt.ylabel("Fitness")
    plt.grid(True)
    plt.legend()
    _save_one_file(csv_file.with_name("tune_fitness.png"))


def output_to_rotated_target(output, max_det=300):
    """(B, N, 7) padded OBB detections [xywh, conf, cls, angle] ->
    (batch_ids, class_ids, xywh+angle boxes, confs) for plotting
   ."""
    targets = []
    for i, o in enumerate(np.asarray(output)):
        o = o[:max_det]
        box, conf, cls, angle = o[:, :4], o[:, 4:5], o[:, 5:6], o[:, 6:7]
        j = np.full((len(o), 1), i, dtype=np.float32)
        targets.append(np.concatenate((j, cls, box, angle, conf), 1))
    t = np.concatenate(targets, 0) if targets else np.zeros((0, 8), np.float32)
    return t[:, 0], t[:, 1], t[:, 2:-1], t[:, -1]


def output_to_target(output, max_det=300):
    """(B, max_det, 6) padded detections -> (batch_id, class_id, xywh boxes, conf)
    for plot_images."""
    from yololite_tpu_torch.ops.boxes import xyxy2xywh

    targets = []
    for i, o in enumerate(np.asarray(output)):
        o = o[:max_det]
        o = o[o[:, 4] > 0]  # conf==0 marks padded slots
        box, conf, cls = o[:, :4], o[:, 4:5], o[:, 5:6]
        j = np.full((len(o), 1), i, dtype=np.float32)
        targets.append(np.concatenate((j, cls, xyxy2xywh(box), conf), 1))
    t = np.concatenate(targets, 0) if targets else np.zeros((0, 7), np.float32)
    return t[:, 0], t[:, 1], t[:, 2:-1], t[:, -1]
