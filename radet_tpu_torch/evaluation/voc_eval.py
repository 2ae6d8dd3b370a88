"""VOC-protocol mean AP and proposal recall in numpy (port of
``radet_tpu/evaluation/voc_eval.py``; the port keeps its own copy).

The protocol, as mmdet's ``mean_ap.py`` and ``recall.py`` define it:

- per class and image, detections in descending score order each look at
  their single argmax-IoU GT only: if that GT is already covered the
  detection is a false positive, even when another GT above the threshold
  is free;
- a detection whose argmax GT is ignored (``bboxes_ignore``, or outside
  the area range) counts neither as TP nor as FP;
- in an image without GT every detection in range is a FP;
- AP modes 'area' (the precision envelope's area under the PR curve) and
  '11points' (VOC2007); the mean is over the classes that have GT;
- ``scale_ranges`` are side lengths, squared into area ranges;
- :func:`eval_recalls`: per image, proposals assigned to GTs greedily by
  the largest remaining IoU, one to one; recall over (proposal count, IoU
  threshold).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EPS = np.finfo(np.float32).eps


def bbox_overlaps_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, N) IoU of xyxy boxes."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    xl = np.maximum(a[:, None, 0], b[None, :, 0])
    yt = np.maximum(a[:, None, 1], b[None, :, 1])
    xr = np.minimum(a[:, None, 2], b[None, :, 2])
    yb = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(xr - xl, 0, None) * np.clip(yb - yt, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, EPS)


def average_precision(recalls: np.ndarray, precisions: np.ndarray, mode: str = "area"):
    """AP of one PR curve (or a stack of them along axis 0)."""
    squeeze = recalls.ndim == 1
    rc = np.atleast_2d(recalls)
    pr = np.atleast_2d(precisions)
    s = rc.shape[0]
    ap = np.zeros(s, np.float32)
    if mode == "area":
        z = np.zeros((s, 1), rc.dtype)
        mrec = np.concatenate([z, rc, np.ones((s, 1), rc.dtype)], 1)
        mpre = np.concatenate([z, pr, z], 1)
        # precision envelope (monotone non-increasing from the right)
        mpre = np.maximum.accumulate(mpre[:, ::-1], axis=1)[:, ::-1]
        for i in range(s):
            steps = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, steps + 1] - mrec[i, steps]) * mpre[i, steps + 1])
    elif mode == "11points":
        for i in range(s):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                above = pr[i, rc[i] >= thr]
                ap[i] += above.max() if above.size else 0.0
            ap[i] /= 11.0
    else:
        raise ValueError(f"unknown AP mode {mode!r}")
    return float(ap[0]) if squeeze else ap


def tpfp_image(
    dets: np.ndarray,  # (M, 5) xyxy+score
    gts: np.ndarray,  # (N, 4)
    gts_ignore: Optional[np.ndarray] = None,  # (K, 4)
    iou_thr: float = 0.5,
    area_ranges: Optional[Sequence[Tuple[float, float]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy TP/FP marks, shape (num_scales, M) each."""
    gts_ignore = (
        gts_ignore if gts_ignore is not None else np.zeros((0, 4), np.float32)
    )
    ignore_flag = np.concatenate(
        [np.zeros(len(gts), bool), np.ones(len(gts_ignore), bool)]
    )
    all_gts = np.vstack([gts.reshape(-1, 4), gts_ignore.reshape(-1, 4)])
    ranges = list(area_ranges) if area_ranges is not None else [(None, None)]
    m = len(dets)
    tp = np.zeros((len(ranges), m), np.float32)
    fp = np.zeros((len(ranges), m), np.float32)
    det_areas = (
        (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
        if m
        else np.zeros(0)
    )

    if len(all_gts) == 0:
        for k, (lo, hi) in enumerate(ranges):
            if lo is None:
                fp[k] = 1
            else:
                fp[k, (det_areas >= lo) & (det_areas < hi)] = 1
        return tp, fp

    ious = bbox_overlaps_np(dets[:, :4], all_gts)
    best_iou = ious.max(axis=1) if m else np.zeros(0)
    best_gt = ious.argmax(axis=1) if m else np.zeros(0, int)
    order = np.argsort(-dets[:, 4], kind="stable") if m else []
    gt_areas = (all_gts[:, 2] - all_gts[:, 0]) * (all_gts[:, 3] - all_gts[:, 1])
    for k, (lo, hi) in enumerate(ranges):
        covered = np.zeros(len(all_gts), bool)
        area_ignored = (
            np.zeros(len(all_gts), bool)
            if lo is None
            else (gt_areas < lo) | (gt_areas >= hi)
        )
        for i in order:
            if best_iou[i] >= iou_thr:
                g = best_gt[i]
                if ignore_flag[g] or area_ignored[g]:
                    continue  # neither tp nor fp
                if covered[g]:
                    fp[k, i] = 1
                else:
                    covered[g] = True
                    tp[k, i] = 1
            elif lo is None or (lo <= det_areas[i] < hi):
                fp[k, i] = 1
    return tp, fp


def eval_map(
    det_results: List[List[np.ndarray]],  # [img][cls] -> (M, 5)
    annotations: List[Dict],  # per image: bboxes, labels, [bboxes_ignore, labels_ignore]
    scale_ranges: Optional[Sequence[Tuple[float, float]]] = None,
    iou_thr: float = 0.5,
    mode: str = "area",
) -> Tuple[float | List[float], List[Dict]]:
    """VOC-protocol mAP. Returns (mAP, per-class results)."""
    assert len(det_results) == len(annotations)
    num_classes = len(det_results[0])
    area_ranges = (
        [(lo ** 2, hi ** 2) for lo, hi in scale_ranges] if scale_ranges else None
    )
    num_scales = len(scale_ranges) if scale_ranges else 1

    per_class = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_ign = [], [], []
        for dets, ann in zip(det_results, annotations):
            cls_dets.append(np.asarray(dets[c], np.float32).reshape(-1, 5))
            sel = np.asarray(ann["labels"]) == c
            cls_gts.append(np.asarray(ann["bboxes"], np.float32).reshape(-1, 4)[sel])
            if ann.get("labels_ignore") is not None:
                isel = np.asarray(ann["labels_ignore"]) == c
                cls_ign.append(
                    np.asarray(ann["bboxes_ignore"], np.float32).reshape(-1, 4)[isel]
                )
            else:
                cls_ign.append(np.zeros((0, 4), np.float32))

        marks = [
            tpfp_image(d, g, gi, iou_thr, area_ranges)
            for d, g, gi in zip(cls_dets, cls_gts, cls_ign)
        ]
        num_gts = np.zeros(num_scales, int)
        for g in cls_gts:
            if area_ranges is None:
                num_gts[0] += len(g)
            else:
                areas = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
                for k, (lo, hi) in enumerate(area_ranges):
                    num_gts[k] += int(((areas >= lo) & (areas < hi)).sum())

        all_dets = np.vstack(cls_dets)
        order = np.argsort(-all_dets[:, 4], kind="stable")
        tp = np.concatenate([m[0] for m in marks], axis=1)[:, order]
        fp = np.concatenate([m[1] for m in marks], axis=1)[:, order]
        tp = np.cumsum(tp, axis=1)
        fp = np.cumsum(fp, axis=1)
        recalls = tp / np.maximum(num_gts[:, None], EPS)
        precisions = tp / np.maximum(tp + fp, EPS)
        if scale_ranges is None:
            recalls, precisions = recalls[0], precisions[0]
            n_gt = int(num_gts[0])
        else:
            n_gt = num_gts
        ap = average_precision(recalls, precisions, mode)
        per_class.append(
            dict(
                num_gts=n_gt,
                num_dets=len(all_dets),
                recall=recalls,
                precision=precisions,
                ap=ap,
            )
        )

    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in per_class])  # (C, S)
        all_gt = np.vstack([r["num_gts"] for r in per_class])
        mean_ap = [
            float(all_ap[all_gt[:, s] > 0, s].mean()) if (all_gt[:, s] > 0).any() else 0.0
            for s in range(num_scales)
        ]
    else:
        aps = [r["ap"] for r in per_class if r["num_gts"] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, per_class


def eval_recalls(
    gts: List[np.ndarray],  # per image (N, 4)
    proposals: List[np.ndarray],  # per image (K, 4) or (K, 5): if scored, sorted by score
    proposal_nums: Sequence[int] | int = (100, 300, 1000),
    iou_thrs: Sequence[float] | float = 0.5,
) -> np.ndarray:
    """Proposal recall matrix, shape (len(proposal_nums), len(iou_thrs)).

    Per image, proposals (top-N by score when scored) are greedily assigned
    to GTs by globally-maximal IoU, one-to-one (recall.py:11-40)."""
    pnums = np.atleast_1d(np.asarray(proposal_nums, int))
    thrs = np.atleast_1d(np.asarray(iou_thrs, float))
    total_gt = sum(len(g) for g in gts)
    gt_best = np.zeros((len(pnums), total_gt), np.float32)
    for k, pn in enumerate(pnums):
        ofs = 0
        for g, p in zip(gts, proposals):
            p = np.asarray(p, np.float32)
            if p.ndim == 2 and p.shape[1] == 5:
                p = p[np.argsort(-p[:, 4], kind="stable")][:, :4]
            p = p[:pn]
            n = len(g)
            if n == 0:
                continue
            ious = bbox_overlaps_np(np.asarray(g, np.float32), p)
            # greedy global max assignment, one-to-one
            for _ in range(n):
                if ious.size == 0:
                    break
                j_best = ious.argmax(axis=1)
                row_max = ious[np.arange(n), j_best]
                gi = row_max.argmax()
                if row_max[gi] < 0:
                    break
                gt_best[k, ofs + gi] = row_max[gi]
                ious[gi, :] = -1
                ious[:, j_best[gi]] = -1
            ofs += n
    recalls = np.zeros((len(pnums), len(thrs)))
    for t, thr in enumerate(thrs):
        recalls[:, t] = (gt_best >= thr).sum(axis=1) / max(float(total_gt), EPS)
    return recalls
