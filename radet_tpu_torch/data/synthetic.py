"""Synthetic BOP scenes without cv2: the scenes of filled rectangles that
``tools/validate_learning.py`` trains on (port of
``tests/fixtures.py::make_synthetic_bop``, which the port's package cannot
import and which writes with cv2), written with ``utils/image_write.py``'s
PNG writer."""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Tuple

import numpy as np

from ..utils.image_write import write_png


def make_synthetic_bop(
    root: str,
    num_scenes: int = 1,
    images_per_scene: int = 4,
    img_hw: Tuple[int, int] = (480, 640),
    num_classes: int = 3,
    max_objects: int = 4,
    seed: int = 0,
    split: str = "train_pbr",
):
    """BOP scenes of filled rectangles on noise and their COCO json, with the
    same random draws as ``make_synthetic_bop``: per image the noise, the
    object count, and per object its size, corner and class.  As there, an
    object's image rectangle is ``cv2.rectangle``'s filled (bw + 1) x (bh + 1)
    pixels and its ``mask_visib`` PNG is bw x bh (255 inside, later objects
    not cut out).  Images are PNG (``.png`` file names; everything else in
    the json is the fixture's), holding what ``cv2.imread`` gives for the
    fixture's JPEG before its compression.  Returns (ann_file, img_prefix)."""
    rng = np.random.RandomState(seed)
    split_dir = osp.join(root, split)
    images, annotations = [], []
    categories = [dict(id=c + 1, name=f"obj_{c + 1:06d}") for c in range(num_classes)]
    h, w = img_hw
    lo = max(16, min(h, w) // 8)
    hi = max(lo + 8, min(h, w) // 3)
    for scene in range(num_scenes):
        scene_dir = osp.join(split_dir, f"{scene:06d}")
        for sub in ("rgb", "mask_visib"):
            os.makedirs(osp.join(scene_dir, sub), exist_ok=True)
        for i in range(images_per_scene):
            img = rng.randint(0, 80, (h, w, 3), np.uint8)  # BGR, as cv2 writes it
            img_id = len(images) + 1
            for a in range(rng.randint(1, max_objects + 1)):
                bw, bh = rng.randint(lo, hi), rng.randint(lo, hi)
                x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
                cls = rng.randint(0, num_classes)
                img[y1:y1 + bh + 1, x1:x1 + bw + 1] = [(60 + 60 * cls) % 256, (200 - 50 * cls) % 256, 255]
                mask = np.zeros((h, w), np.uint8)
                mask[y1:y1 + bh, x1:x1 + bw] = 255
                write_png(osp.join(scene_dir, "mask_visib", f"{i:06d}_{a:06d}.png"), mask)
                annotations.append(dict(id=len(annotations) + 1, image_id=img_id, category_id=int(cls) + 1,
                                        bbox=[float(x1), float(y1), float(bw), float(bh)],
                                        area=float(bw * bh), iscrowd=0, visib_fract=1.0))
            write_png(osp.join(scene_dir, "rgb", f"{i:06d}.png"), img[..., ::-1])
            name = f"{scene:06d}/rgb/{i:06d}.png"
            images.append(dict(id=img_id, width=w, height=h, filename=name, file_name=name))
    ann_dir = osp.join(root, "detector_annotations")
    os.makedirs(ann_dir, exist_ok=True)
    ann_file = osp.join(ann_dir, f"{split}.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=categories), f)
    return ann_file, split_dir + "/"
