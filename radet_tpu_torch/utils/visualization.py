"""Detection drawing helpers without cv2 (port of
``radet_tpu/utils/visualization.py``): the same signatures, palette and
returned BGR array, drawn by ``utils/raster.py`` and written by
``utils/image_write.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .image_write import imwrite
from .raster import FONT_HERSHEY_SIMPLEX, put_text, rectangle

_PALETTE = [
    (54, 67, 244), (99, 30, 233), (176, 39, 156), (183, 58, 103),
    (181, 81, 63), (243, 150, 33), (212, 188, 0), (136, 150, 0),
    (80, 175, 76), (74, 195, 139), (57, 220, 205), (59, 235, 255),
    (0, 152, 255), (34, 87, 255), (72, 85, 121), (158, 158, 158),
]


def imshow_det_bboxes(
    img: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.0,
    thickness: int = 2,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """Draw xyxy boxes onto an RGB image; returns (and optionally saves) BGR."""
    out = np.ascontiguousarray(img[..., ::-1])
    for i, (box, label) in enumerate(zip(boxes, labels)):
        score = float(scores[i]) if scores is not None else None
        if score is not None and score < score_thr:
            continue
        color = _PALETTE[int(label) % len(_PALETTE)]
        x1, y1, x2, y2 = [int(v) for v in box]
        rectangle(out, (x1, y1), (x2, y2), color, thickness)
        name = (
            str(class_names[int(label)])
            if class_names is not None and int(label) < len(class_names)
            else str(int(label))
        )
        text = f"{name}|{score:.2f}" if score is not None else name
        put_text(out, text, (x1, max(0, y1 - 4)), FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    if out_file:
        imwrite(out_file, out)
    return out


def imshow_gt_det_bboxes(img, gt_boxes, gt_labels, det_boxes, det_labels,
                         det_scores=None, class_names=None, score_thr=0.0,
                         out_file=None):
    """GT in green, detections in palette colors."""
    out = np.ascontiguousarray(img[..., ::-1])
    for box in gt_boxes:
        x1, y1, x2, y2 = [int(v) for v in box]
        rectangle(out, (x1, y1), (x2, y2), (0, 255, 0), 2)
    return imshow_det_bboxes(
        out[..., ::-1], det_boxes, det_labels, det_scores, class_names, score_thr, out_file=out_file
    )
