"""The LVIS federated evaluation protocol in numpy (port of
``radet_tpu/evaluation/lvis_eval.py``), on :class:`COCOEvaluator`.

Its three departures from COCO (the ``lvis`` package's LVISEval, which is
not a dependency):

1. **A per-image cap across categories**: at most ``max_dets=300``
   detections per image in all (LVISResults' limit), not COCO's
   per-category maxDets list.
2. **Federated categories**: a detection of category ``c`` on image ``i``
   is evaluated only where ``c`` is annotated on ``i`` or listed in its
   ``neg_category_ids`` (verified absent); elsewhere it is dropped
   (neither TP nor FP).
3. **Not-exhaustive categories**: on images that list ``c`` in
   ``not_exhaustive_category_ids``, unmatched detections of ``c`` are
   ignored rather than counted as false positives.

The summary adds APr/APc/APf over the categories' ``frequency`` buckets
(rare/common/frequent) of LVIS v1's category records.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .coco_eval import COCOEvaluator


class LVISEvaluator(COCOEvaluator):
    def __init__(
        self,
        gt_index,  # CocoIndex over an LVIS-format annotation dict
        cat_ids: Sequence[int],
        img_ids: Optional[Sequence[int]] = None,
        iou_thrs: Optional[np.ndarray] = None,
        max_dets: int = 300,
    ):
        super().__init__(
            gt_index,
            cat_ids,
            img_ids=img_ids,
            iou_thrs=iou_thrs,
            max_dets=(max_dets,),
        )
        # positive set: categories with annotations on the image
        self._img_pos: Dict[int, Set[int]] = defaultdict(set)
        for img_id in self.img_ids:
            for ann in gt_index.get_anns(img_id):
                self._img_pos[img_id].add(ann["category_id"])
        # negative / not-exhaustive sets from the image records
        self._img_neg: Dict[int, Set[int]] = {}
        self._img_nel: Dict[int, Set[int]] = {}
        for img_id in self.img_ids:
            info = gt_index.imgs[img_id]
            self._img_neg[img_id] = set(info.get("neg_category_ids", []))
            self._img_nel[img_id] = set(
                info.get("not_exhaustive_category_ids", [])
            )

    # -- protocol hooks --------------------------------------------------
    def _use_detection(self, r: dict) -> bool:
        img_id, cat_id = r["image_id"], r["category_id"]
        return (
            cat_id in self._img_pos.get(img_id, ())
            or cat_id in self._img_neg.get(img_id, ())
        )

    def _dt_unmatched_ignore(self, img_id: int, cat_id: int, num_dt: int) -> np.ndarray:
        if cat_id in self._img_nel.get(img_id, ()):
            return np.ones(num_dt, bool)
        return np.zeros(num_dt, bool)

    # -- entry -----------------------------------------------------------
    def evaluate(self, results: List[dict]) -> Dict[str, float]:
        """COCO-style detection dicts → LVIS summary.

        The per-image across-category cap (LVISResults max_dets) applies
        before matching; per-(image, category) lists are then capped by the
        inherited machinery at the same value, which is a no-op."""
        cap = self.max_dets[-1]
        by_img: Dict[int, List[dict]] = defaultdict(list)
        for r in results:
            by_img[r["image_id"]].append(r)
        capped: List[dict] = []
        for img_id, dts in by_img.items():
            if len(dts) > cap:
                dts = sorted(dts, key=lambda d: -d["score"])[:cap]
            capped.extend(dts)

        base = super().evaluate(capped)
        out = {
            "mAP": base["mAP"],
            "mAP_50": base["mAP_50"],
            "mAP_75": base["mAP_75"],
            "mAP_s": base["mAP_s"],
            "mAP_m": base["mAP_m"],
            "mAP_l": base["mAP_l"],
            f"AR@{cap}": base[f"AR@{cap}"],
        }
        out.update(self._frequency_aps())
        return out

    def _frequency_aps(self) -> Dict[str, float]:
        """APr/APc/APf over LVIS v1 category frequency buckets; empty when
        the annotation file carries no ``frequency`` fields."""
        buckets = {"r": [], "c": [], "f": []}
        for k, cat_id in enumerate(self.cat_ids):
            freq = self.gt.cats.get(cat_id, {}).get("frequency")
            if freq in buckets:
                buckets[freq].append(k)
        if not any(buckets.values()):
            return {}
        a = self.area_labels.index("all")
        m = len(self.max_dets) - 1
        out = {}
        for freq, ks in buckets.items():
            p = self.precision[:, :, ks, a, m]
            p = p[p > -1]
            out[f"mAP_{freq}"] = float(p.mean()) if p.size else -1.0
        return out
