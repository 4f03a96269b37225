"""Pure-numpy COCO bbox evaluation (pycocotools-COCOeval semantics; port of yololite_tpu/utils/cocoeval.py).

Reimplements the COCOeval "bbox" algorithm from its published semantics, so
no pycocotools is needed: per-(image, category) greedy matching at 10 IoU
thresholds with crowd/ignore handling, 101-point interpolated precision,
area-range and maxDets breakdowns.

Inputs use standard COCO dict formats:
  gt:   {"images": [{"id", "width", "height"}], "annotations": [{"id", "image_id",
         "category_id", "bbox" (ltwh), "area", "iscrowd"}], "categories": [{"id"}]}
  dets: [{"image_id", "category_id", "bbox" (ltwh), "score"}]
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0**2),
    ("medium", 32.0**2, 96.0**2),
    ("large", 96.0**2, 1e10),
)
MAX_DETS = (1, 10, 100)


def iou_ltwh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU of ltwh boxes, (D,4) x (G,4) -> (D,G); crowd gt uses det-area union."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0:1], dt[:, 1:2]
    dx2, dy2 = dx1 + dt[:, 2:3], dy1 + dt[:, 3:4]
    gx1, gy1 = gt[None, :, 0], gt[None, :, 1]
    gx2, gy2 = gx1 + gt[None, :, 2], gy1 + gt[None, :, 3]
    iw = np.clip(np.minimum(dx2, gx2) - np.maximum(dx1, gx1), 0, None)
    ih = np.clip(np.minimum(dy2, gy2) - np.maximum(dy1, gy1), 0, None)
    inter = iw * ih
    darea = (dt[:, 2] * dt[:, 3])[:, None]
    garea = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), darea, darea + garea - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEval:
    """Numpy reimplementation of pycocotools.cocoeval.COCOeval for bbox."""

    def __init__(self, gt: Dict, dets: Sequence[Dict], img_ids: Optional[Sequence] = None):
        self.img_ids = list(img_ids) if img_ids is not None else [im["id"] for im in gt["images"]]
        cats = gt.get("categories")
        self.cat_ids = sorted(c["id"] for c in cats) if cats else sorted(
            {a["category_id"] for a in gt["annotations"]} | {d["category_id"] for d in dets}
        )
        self._gts: Dict = defaultdict(list)
        self._dts: Dict = defaultdict(list)
        imgset = set(self.img_ids)
        for a in gt["annotations"]:
            if a["image_id"] in imgset:
                self._gts[(a["image_id"], a["category_id"])].append(a)
        for d in dets:
            if d["image_id"] in imgset:
                self._dts[(d["image_id"], d["category_id"])].append(d)
        self.eval: Dict = {}

    # ---- per-(image, category) ----

    def _evaluate_img(self, img_id, cat_id, area_lo, area_hi, max_det):
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if not gts and not dts:
            return None
        gt_ignore0 = np.array(
            [bool(g.get("ignore")) or bool(g.get("iscrowd")) or not (area_lo <= g["area"] <= area_hi) for g in gts],
            bool,
        )
        # non-ignored gt first (stable), like pycocotools' kind='mergesort' argsort
        gorder = np.argsort(gt_ignore0, kind="stable")
        gts = [gts[i] for i in gorder]
        gt_ig = gt_ignore0[gorder]
        iscrowd = np.array([bool(g.get("iscrowd")) for g in gts], bool)

        dscores = np.array([d["score"] for d in dts])
        dorder = np.argsort(-dscores, kind="stable")[:max_det]
        dts = [dts[i] for i in dorder]

        ious = iou_ltwh(
            np.array([d["bbox"] for d in dts], float).reshape(-1, 4),
            np.array([g["bbox"] for g in gts], float).reshape(-1, 4),
            iscrowd,
        )

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dtm = np.zeros((T, D), np.int64)  # matched gt index + 1 (0 = unmatched)
        gtm = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best = min(thr, 1 - 1e-10)
                m = -1
                for g in range(G):
                    if gtm[t, g] > 0 and not iscrowd[g]:
                        continue
                    if m > -1 and not gt_ig[m] and gt_ig[g]:
                        break  # gts sorted ignored-last: no better match possible
                    if ious[d, g] < best:
                        continue
                    best = ious[d, g]
                    m = g
                if m == -1:
                    continue
                dtm[t, d] = m + 1
                gtm[t, m] = d + 1
                dt_ig[t, d] = gt_ig[m]
        # unmatched dets outside the area range are ignored, not false positives
        d_out = np.array([not (area_lo <= d["bbox"][2] * d["bbox"][3] <= area_hi) for d in dts], bool)
        dt_ig |= (dtm == 0) & d_out[None, :]
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_matched": dtm > 0,
            "dt_ignore": dt_ig,
            "num_gt": int((~gt_ig).sum()),
        }

    # ---- accumulate + summarize ----

    def evaluate(self) -> Dict:
        T, R, K, A, M = len(IOU_THRS), len(REC_THRS), len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            for a, (_, lo, hi) in enumerate(AREA_RNG):
                per_img = [self._evaluate_img(i, cat, lo, hi, max(MAX_DETS)) for i in self.img_ids]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate([e["dt_scores"][:max_det] for e in per_img])
                    order = np.argsort(-scores, kind="stable")
                    matched = np.concatenate([e["dt_matched"][:, :max_det] for e in per_img], 1)[:, order]
                    ignored = np.concatenate([e["dt_ignore"][:, :max_det] for e in per_img], 1)[:, order]
                    npig = sum(e["num_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    tps = np.cumsum(matched & ~ignored, axis=1, dtype=float)
                    fps = np.cumsum(~matched & ~ignored, axis=1, dtype=float)
                    for t in range(T):
                        tp, fp = tps[t], fps[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # precision envelope: monotone non-increasing from the right
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        q = np.zeros(R)
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                        precision[t, :, k, a, m] = q
        self.eval = {"precision": precision, "recall": recall}
        return self.eval

    def _ap(self, iou_thr=None, area="all", max_det=100):
        p = self.eval["precision"]
        a = [r[0] for r in AREA_RNG].index(area)
        m = MAX_DETS.index(max_det)
        if iou_thr is not None:
            p = p[[int(round((iou_thr - 0.5) / 0.05))]]
        p = p[:, :, :, a, m]
        p = p[p > -1]
        return float(np.mean(p)) if p.size else -1.0

    def _ar(self, area="all", max_det=100):
        r = self.eval["recall"]
        a = [x[0] for x in AREA_RNG].index(area)
        m = MAX_DETS.index(max_det)
        r = r[:, :, a, m]
        r = r[r > -1]
        return float(np.mean(r)) if r.size else -1.0

    def summarize(self) -> np.ndarray:
        """The standard 12 COCO stats: AP, AP50, AP75, APs/m/l, AR1/10/100, ARs/m/l."""
        if not self.eval:
            self.evaluate()
        return np.array(
            [
                self._ap(),
                self._ap(iou_thr=0.5),
                self._ap(iou_thr=0.75),
                self._ap(area="small"),
                self._ap(area="medium"),
                self._ap(area="large"),
                self._ar(max_det=1),
                self._ar(max_det=10),
                self._ar(max_det=100),
                self._ar(area="small"),
                self._ar(area="medium"),
                self._ar(area="large"),
            ]
        )


def gt_from_yolo_labels(labels: List[Dict], im_files: List[str], class_map: List[int]) -> Dict:
    """Synthesize a COCO GT dict from a YOLODataset's label records.

    Used when no annotations/instances_*.json ships with the dataset (e.g. coco8),
    so eval_json can still score the exported predictions.json. Boxes are xywh
    normalized in `lb["bboxes"]` with pixel shape in `lb["shape"]` (h, w).
    """
    from pathlib import Path

    images, anns = [], []
    aid = 1
    for lb, f in zip(labels, im_files):
        stem = Path(f).stem
        img_id = int(stem) if stem.isnumeric() else stem
        h, w = lb["shape"][:2]
        images.append({"id": img_id, "width": w, "height": h})
        cls = np.asarray(lb["cls"]).reshape(-1)
        boxes = np.asarray(lb["bboxes"]).reshape(-1, 4)
        for c, b in zip(cls, boxes):
            bw, bh = b[2] * w, b[3] * h
            anns.append(
                {
                    "id": aid,
                    "image_id": img_id,
                    "category_id": class_map[int(c)],
                    "bbox": [float(b[0] * w - bw / 2), float(b[1] * h - bh / 2), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "iscrowd": 0,
                }
            )
            aid += 1
    cats = [{"id": c} for c in sorted(set(class_map))]
    return {"images": images, "annotations": anns, "categories": cats}
