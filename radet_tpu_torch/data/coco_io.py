"""Minimal COCO-format annotation index (port of
``radet_tpu/data/coco_io.py``, plain json; pycocotools is not a dependency).

Provides just what the BOP data path needs: image records, per-image
annotation lookup, category id <-> contiguous label mapping with optional
class-name filtering.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence


class CocoIndex:
    def __init__(self, ann_file):
        """``ann_file``: a json path, or an already-built COCO-format dict
        (the XML-style datasets convert PASCAL annotations in memory,
        data/datasets_extra.py)."""
        if isinstance(ann_file, dict):
            data = ann_file
        else:
            with open(ann_file) as f:
                data = json.load(f)
        self.dataset = data
        for img in data.get("images", []):
            # normalize the COCO 'file_name' key (the reference CocoDataset
            # aliases it to 'filename', coco.py:77)
            if "filename" not in img and "file_name" in img:
                img["filename"] = img["file_name"]
            elif "filename" not in img and "coco_url" in img:
                # LVIS v1 images carry only coco_url (reference
                # lvis.py:736-739): strip the host to get the split-relative
                # path, e.g. 'val2017/000000397133.jpg'
                img["filename"] = "/".join(img["coco_url"].rsplit("/", 2)[-2:])
        self.imgs: Dict[int, dict] = {img["id"]: img for img in data.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {img_id: [] for img_id in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    # -- pycocotools-compatible helpers ----------------------------------
    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_cat_ids(self, cat_names: Optional[Sequence[str]] = None) -> List[int]:
        if cat_names is None:
            return sorted(self.cats.keys())
        # stringify both sides: BOP tless/itodd/hb configs use integer class
        # names (reference configs/bop/r50_tless_pbr.py:6-7)
        by_name = {str(c["name"]): c["id"] for c in self.cats.values()}
        missing = [n for n in cat_names if str(n) not in by_name]
        if missing:
            raise KeyError(f"classes not found in annotations: {missing}")
        return [by_name[str(n)] for n in cat_names]

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def get_anns(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])
