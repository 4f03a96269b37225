"""Detection metrics: COCO-style 101-point AP, PR/F1 curves, confusion matrix.

Port of yololite_tpu/utils/metrics.py: host-side numpy with the same
operations in the same order, so the numbers are the same bits: smooth(),
compute_ap 101-point interpolation, ap_per_class's max-F1 operating point,
fitness = 0.1*mAP50 + 0.9*mAP50-95. Plots need matplotlib and are skipped
without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from yololite_tpu_torch.ops.boxes import box_iou_np
from yololite_tpu_torch.utils import LOGGER
from yololite_tpu_torch.utils.misc import SimpleClass


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing over fraction f of the curve."""
    nf = round(len(y) * f * 2) // 2 + 1
    nf += 1 - nf % 2  # must be odd so the valid convolution preserves length
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP from recall/precision curves."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # (D, T) bool, T iou thresholds
    conf: np.ndarray,  # (D,)
    pred_cls: np.ndarray,  # (D,)
    target_cls: np.ndarray,  # (L,)
    plot: bool = False,
    save_dir: Path = Path(),
    names: Dict[int, str] = {},
    eps: float = 1e-16,
    prefix: str = "",
):
    """Per-class AP + max-F1 operating-point P/R."""
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x, prec_values = np.linspace(0, 1, 1000), []
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values.append(np.interp(x, mrec, mpre))

    prec_values = np.array(prec_values) if prec_values else np.zeros((0, 1000))
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)

    if plot and nc:
        try:
            _plot_curves(x, p_curve, r_curve, f1_curve, prec_values, ap, save_dir, prefix)
        except Exception as e:  # plotting must never break evaluation (matplotlib may be absent)
            LOGGER.warning(f"PR/F1 curves not plotted: {e}")

    i = smooth(f1_curve.mean(0), 0.1).argmax() if nc else 0
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return (
        tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int),
        p_curve, r_curve, f1_curve, x, prec_values,
    )


def _plot_curves(x, p_curve, r_curve, f1_curve, prec_values, ap, save_dir, prefix):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    for name, ys, ylabel in (
        ("PR_curve", prec_values, "Precision"),
        ("F1_curve", f1_curve, "F1"),
        ("P_curve", p_curve, "Precision"),
        ("R_curve", r_curve, "Recall"),
    ):
        fig, ax = plt.subplots(figsize=(6, 5))
        xs = np.linspace(0, 1, ys.shape[1]) if ys.size else x
        for row in ys:
            ax.plot(xs, row, linewidth=1, alpha=0.6)
        ax.set_xlabel("Recall" if name == "PR_curve" else "Confidence")
        ax.set_ylabel(ylabel)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        fig.savefig(save_dir / f"{prefix}{name}.png", dpi=200)
        plt.close(fig)


class Metric(SimpleClass):
    """Holder for per-class P/R/F1/AP arrays with summary properties."""

    def __init__(self):
        self.p = []
        self.r = []
        self.f1 = []
        self.all_ap = []
        self.ap_class_index = []
        self.nc = 0

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return self.all_ap[:, 5].mean() if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i):
        return self.p[i], self.r[i], self.ap50[i], self.ap[i]

    @property
    def maps(self):
        maps = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[c] = self.ap[i]
        return maps

    def fitness(self):
        w = [0.0, 0.0, 0.1, 0.9]
        return (np.array(self.mean_results()) * w).sum()

    def update(self, results):
        (self.p, self.r, self.f1, self.all_ap, self.ap_class_index,
         self.p_curve, self.r_curve, self.f1_curve, self.px, self.prec_values) = results


class DetMetrics(SimpleClass):
    """Detection metrics facade used by the validator."""

    def __init__(self, save_dir=Path("."), plot=False, names={}):
        self.save_dir = save_dir
        self.plot = plot
        self.names = names
        self.box = Metric()
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self.task = "detect"

    def process(self, tp, conf, pred_cls, target_cls):
        results = ap_per_class(
            tp, conf, pred_cls, target_cls, plot=self.plot, save_dir=self.save_dir, names=self.names
        )[2:]
        self.box.nc = len(self.names)
        self.box.update(results)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]

    def mean_results(self):
        return self.box.mean_results()

    def class_result(self, i):
        return self.box.class_result(i)

    @property
    def maps(self):
        return self.box.maps

    @property
    def fitness(self):
        return self.box.fitness()

    @property
    def ap_class_index(self):
        return self.box.ap_class_index

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"], self.mean_results() + [self.fitness]))


class ConfusionMatrix:
    """Confusion matrix over detections at a single conf/IoU."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = 0.25 if conf in (None, 0.001) else conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections, gt_bboxes, gt_cls):
        """detections: (N,6) [xyxy, conf, cls]; gt_bboxes: (M,4) xyxy; gt_cls: (M,)."""
        if gt_cls.shape[0] == 0:
            if detections is not None and len(detections):
                detections = detections[detections[:, 4] > self.conf]
                for dc in detections[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # missed
            return

        detections = detections[detections[:, 4] > self.conf]
        gt_classes = gt_cls.astype(int)
        detection_classes = detections[:, 5].astype(int)
        iou = box_iou_np(gt_bboxes, detections[:, :4])
        x = np.argwhere(iou > self.iou_thres)
        if x.shape[0]:
            ious = iou[x[:, 0], x[:, 1]]
            matches = np.concatenate([x, ious[:, None]], 1)
            if x.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[detection_classes[m1[j]], gc] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(detection_classes):
            if not any(m1 == i):
                self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]

    def plot(self, save_dir=Path("."), names=(), normalize=True):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        array = self.matrix / ((self.matrix.sum(0).reshape(1, -1) + 1e-9) if normalize else 1)
        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(array, cmap="Blues")
        fig.colorbar(im)
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        fig.savefig(Path(save_dir) / f"confusion_matrix{'_normalized' if normalize else ''}.png", dpi=200)
        plt.close(fig)

    def print(self):
        for row in self.matrix:
            print(" ".join(f"{int(v)}" for v in row))


def _curve_figure(px, per_class, bold, labels, xlabel, ylabel, title, save_dir, on_plot):
    """Shared renderer for the PR / metric-confidence curve family."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if labels:  # per-class legend, up to 20 classes
        for curve, text in zip(per_class, labels):
            ax.plot(px, curve, linewidth=1, label=text)
    else:
        for curve in per_class:
            ax.plot(px, curve, linewidth=1, color="grey")
    y, text = bold
    ax.plot(px, y, linewidth=3, color="blue", label=text)
    ax.set(xlabel=xlabel, ylabel=ylabel, xlim=(0, 1), ylim=(0, 1), title=title)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)
    if on_plot:
        on_plot(save_dir)


def plot_pr_curve(px, py, ap, save_dir=Path("pr_curve.png"), names=None, on_plot=None):
    """Precision-recall curves, per-class legend under 21 classes."""
    names = names or {}
    curves = list(np.stack(py, axis=1).T)
    labels = [f"{names[i]} {ap[i, 0]:.3f}" for i in range(len(curves))] if 0 < len(names) < 21 else None
    mean = np.mean(curves, axis=0)
    _curve_figure(px, curves, (mean, f"all classes {ap[:, 0].mean():.3f} mAP@0.5"), labels,
                  "Recall", "Precision", "Precision-Recall Curve", save_dir, on_plot)


def plot_mc_curve(px, py, save_dir=Path("mc_curve.png"), names=None, xlabel="Confidence",
                  ylabel="Metric", on_plot=None):
    """Metric-confidence curves (F1/P/R vs conf)."""
    names = names or {}
    py = np.asarray(py)
    labels = [str(names[i]) for i in range(len(py))] if 0 < len(names) < 21 else None
    y = smooth(py.mean(0), 0.05)
    _curve_figure(px, list(py), (y, f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}"), labels,
                  xlabel, ylabel, f"{ylabel}-Confidence Curve", save_dir, on_plot)
