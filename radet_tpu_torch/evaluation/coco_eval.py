"""COCO-protocol bbox evaluation in pure numpy (port of
``radet_tpu/evaluation/coco_eval.py``).

pycocotools is not a dependency, so the evaluator re-implements the
COCOeval bbox protocol RADet's BOP datasets evaluate with: IoU thresholds
.50:.05:.95, 101-point interpolated precision, area ranges
all/small/medium/large, maxDets (1, 10, 100), greedy per-image
per-category matching with crowd/ignore handling, and the standard
12-number summary.

Matching rules follow pycocotools.cocoeval.COCOeval.evaluateImg:
- detections sorted by score (descending, stable), capped at maxDet;
- ground truths sorted ignored-last; a detection greedily takes the
  highest-IoU ground truth above the threshold, preferring non-ignored ones
  (once a non-ignored match exists, ignored GTs are only taken if no
  non-ignored GT remains);
- crowd GTs may match multiple detections (IoU uses detection area as the
  denominator) and matched detections become ignored;
- unmatched detections whose area falls outside the range are ignored.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def iou_xywh(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU of xywh boxes; crowd GTs use detection area as denominator
    (pycocotools maskUtils.iou semantics)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    xl = np.maximum(dx1[:, None], gx1[None])
    yt = np.maximum(dy1[:, None], gy1[None])
    xr = np.minimum(dx2[:, None], gx2[None])
    yb = np.minimum(dy2[:, None], gy2[None])
    inter = np.clip(xr - xl, 0, None) * np.clip(yb - yt, 0, None)
    area_d = (dts[:, 2] * dts[:, 3])[:, None]
    area_g = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    def __init__(
        self,
        gt_index,  # CocoIndex
        cat_ids: Sequence[int],
        img_ids: Optional[Sequence[int]] = None,
        iou_thrs: Optional[np.ndarray] = None,
        max_dets: Sequence[int] = (1, 10, 100),
    ):
        self.gt = gt_index
        self.cat_ids = list(cat_ids)
        self.img_ids = list(img_ids) if img_ids is not None else gt_index.get_img_ids()
        self.iou_thrs = (
            iou_thrs if iou_thrs is not None else np.linspace(0.5, 0.95, 10)
        )
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = sorted(max_dets)
        self.area_labels = list(AREA_RNG.keys())

        self._gt_by_img_cat: Dict = defaultdict(list)
        for img_id in self.img_ids:
            for ann in self.gt.get_anns(img_id):
                if ann["category_id"] in self.cat_ids:
                    self._gt_by_img_cat[(img_id, ann["category_id"])].append(ann)

    def evaluate(self, results: List[dict]) -> Dict[str, float]:
        """results: COCO-style detection dicts (image_id, category_id, bbox
        xywh, score). Returns the reference summary keys (bop.py:284-299)."""
        dt_by_img_cat: Dict = defaultdict(list)
        for r in results:
            if self._use_detection(r):
                dt_by_img_cat[(r["image_id"], r["category_id"])].append(r)

        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(self.area_labels)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            # per-image matching at the largest maxDet; smaller maxDets reuse
            per_img = [
                self._match_img(img_id, cat_id, dt_by_img_cat)
                for img_id in self.img_ids
            ]
            for a, area in enumerate(self.area_labels):
                for m, max_det in enumerate(self.max_dets):
                    self._accumulate(
                        per_img, area, max_det, precision[:, :, k, a, m], recall[:, k, a, m]
                    )

        def _ap(t_slice=slice(None), area="all", max_det=None):
            a = self.area_labels.index(area)
            m = self.max_dets.index(max_det if max_det is not None else self.max_dets[-1])
            p = precision[t_slice, :, :, a, m]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(t_slice=slice(None), area="all", max_det=None):
            a = self.area_labels.index(area)
            m = self.max_dets.index(max_det if max_det is not None else self.max_dets[-1])
            r = recall[t_slice, :, a, m]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        t50 = [i for i, t in enumerate(self.iou_thrs) if abs(t - 0.5) < 1e-6]
        t75 = [i for i, t in enumerate(self.iou_thrs) if abs(t - 0.75) < 1e-6]
        md = self.max_dets
        out = {
            "mAP": _ap(),
            "mAP_50": _ap(t50) if t50 else -1.0,
            "mAP_75": _ap(t75) if t75 else -1.0,
            "mAP_s": _ap(area="small"),
            "mAP_m": _ap(area="medium"),
            "mAP_l": _ap(area="large"),
        }
        # one AR per distinct maxDet (custom lists may have 1..n entries;
        # indexing md[1] unconditionally crashed on single-entry lists)
        for m_det in dict.fromkeys(md):
            out[f"AR@{m_det}"] = _ar(max_det=m_det)
        out.update({
            f"AR_s@{md[-1]}": _ar(area="small", max_det=md[-1]),
            f"AR_m@{md[-1]}": _ar(area="medium", max_det=md[-1]),
            f"AR_l@{md[-1]}": _ar(area="large", max_det=md[-1]),
        })
        self.precision = precision
        self.recall = recall
        return out

    def classwise_ap(self) -> Dict[str, float]:
        """Per-class AP@[.5:.95] from the last evaluate() call — the
        ``classwise=True`` eval option of the reference protocol
        (mmdet CocoDataset.evaluate)."""
        assert getattr(self, "precision", None) is not None, "run evaluate() first"
        a = self.area_labels.index("all")
        m = len(self.max_dets) - 1
        out = {}
        for k, cat_id in enumerate(self.cat_ids):
            p = self.precision[:, :, k, a, m]
            p = p[p > -1]
            name = self.gt.cats.get(cat_id, {}).get("name", str(cat_id))
            out[name] = float(p.mean()) if p.size else -1.0
        return out

    # the protocol's hooks, which the LVIS federated protocol overrides
    # (evaluation/lvis_eval.py)
    def _use_detection(self, r: dict) -> bool:
        return True

    def _dt_unmatched_ignore(self, img_id: int, cat_id: int, num_dt: int) -> np.ndarray:
        """(D,) mask of the unmatched detections to ignore besides those
        outside the area range."""
        return np.zeros(num_dt, bool)

    # ------------------------------------------------------------------
    def _match_img(self, img_id: int, cat_id: int, dt_by_img_cat) -> dict:
        gts = self._gt_by_img_cat.get((img_id, cat_id), [])
        dts = dt_by_img_cat.get((img_id, cat_id), [])
        dts = sorted(dts, key=lambda d: -d["score"])
        max_det = self.max_dets[-1]
        dts = dts[:max_det]

        gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        dt_boxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        gt_crowd = np.asarray([g.get("iscrowd", 0) for g in gts], np.int64)
        gt_area = np.asarray(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts], np.float64
        )
        gt_base_ignore = np.asarray(
            [bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0)) for g in gts], bool
        )
        dt_scores = np.asarray([d["score"] for d in dts], np.float64)
        dt_area = dt_boxes[:, 2] * dt_boxes[:, 3] if len(dts) else np.zeros(0)

        ious = iou_xywh(dt_boxes, gt_boxes, gt_crowd)
        extra_ig = self._dt_unmatched_ignore(img_id, cat_id, len(dts))
        T = len(self.iou_thrs)

        per_area = {}
        for area in self.area_labels:
            lo, hi = AREA_RNG[area]
            gt_ig0 = gt_base_ignore | (gt_area < lo) | (gt_area > hi)
            # sort gts: non-ignored first (stable)
            order = np.argsort(gt_ig0, kind="stable")
            gt_ig_sorted = gt_ig0[order]
            iou_sorted = ious[:, order] if len(gts) else ious
            crowd_sorted = gt_crowd[order]

            G = len(gts)
            D = len(dts)
            gtm = np.zeros((T, G), np.int64) - 1
            dtm = np.zeros((T, D), np.int64) - 1
            dt_ig = np.zeros((T, D), bool)
            for t, thr in enumerate(self.iou_thrs):
                for d in range(D):
                    best = min(thr, 1 - 1e-10)
                    match = -1
                    for g in range(G):
                        if gtm[t, g] >= 0 and not crowd_sorted[g]:
                            continue
                        if match > -1 and not gt_ig_sorted[match] and gt_ig_sorted[g]:
                            break  # remaining gts are all ignored
                        if iou_sorted[d, g] < best:
                            continue
                        best = iou_sorted[d, g]
                        match = g
                    if match == -1:
                        continue
                    dt_ig[t, d] = gt_ig_sorted[match]
                    dtm[t, d] = match
                    gtm[t, match] = d
                # unmatched dts outside the area range are ignored, and those
                # the protocol ignores (LVIS: not-exhaustive categories)
                out_rng = (dt_area < lo) | (dt_area > hi)
                dt_ig[t] |= (dtm[t] == -1) & (out_rng | extra_ig)
            per_area[area] = dict(
                dtm=dtm,
                dt_ig=dt_ig,
                dt_scores=dt_scores,
                num_gt=int((~gt_ig0).sum()),
            )
        return per_area

    def _accumulate(self, per_img, area, max_det, precision_out, recall_out):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        scores = np.concatenate([p[area]["dt_scores"][:max_det] for p in per_img])
        dtm = np.concatenate([p[area]["dtm"][:, :max_det] for p in per_img], axis=1)
        dt_ig = np.concatenate([p[area]["dt_ig"][:, :max_det] for p in per_img], axis=1)
        npig = sum(p[area]["num_gt"] for p in per_img)
        if npig == 0:
            return
        order = np.argsort(-scores, kind="mergesort")
        dtm = dtm[:, order]
        dt_ig = dt_ig[:, order]

        tps = (dtm >= 0) & (~dt_ig)
        fps = (dtm < 0) & (~dt_ig)
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / npig
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            recall_out[t] = rc[-1] if nd else 0.0
            q = np.zeros(R)
            # precision envelope
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, self.rec_thrs, side="left")
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision_out[t] = q
