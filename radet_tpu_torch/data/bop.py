"""Training samples of static shape (port of the sample packing of
``radet_tpu/data/bop.py::BOPDataset``), and an in-memory source that
serves them.

The file-backed ``BOPDataset`` (COCO json, image and mask files) is not
ported: it reads through cv2 (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from ..core.anchors import AnchorConfig, anchor_centers, generate_anchors
from .pipeline import Compose, GenerateDistanceMap, Pad, RandomFlip, SampleDistanceAtAnchors


def pack_sample(results: Dict[str, Any], max_gt: int, img_id: int = 0) -> Optional[Dict[str, np.ndarray]]:
    """A pipeline's ``results`` -> the training sample dict:

    ``image`` uint8 (H, W, 3), ``img_shape`` (2,) and ``scale_factor`` (4,)
    float32, ``img_id``, ``gt_boxes`` (max_gt, 4) float32, ``gt_labels``
    (max_gt,) int32, ``gt_valid`` (max_gt,) bool and, when the pipeline
    sampled them, ``dist_vals`` (N_anchor, max_gt) float16.  GTs past
    ``max_gt`` are dropped.  Returns None for a sample without GT (the
    caller draws another)."""
    boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
    labels = results.get("gt_labels", np.zeros((0,), np.int64))
    g = min(len(boxes), max_gt)
    if g == 0:
        return None
    h, w = results["img_shape"]
    gt_boxes = np.zeros((max_gt, 4), np.float32)
    gt_labels = np.zeros((max_gt,), np.int32)
    gt_valid = np.zeros((max_gt,), bool)
    gt_boxes[:g] = boxes[:g]
    gt_labels[:g] = labels[:g]
    gt_valid[:g] = True
    sample = dict(
        image=np.ascontiguousarray(results["img"]),
        img_shape=np.asarray([h, w], np.float32),
        scale_factor=np.asarray(results["scale_factor"], np.float32),
        img_id=np.int64(img_id),
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_valid=gt_valid,
    )
    if "dist_vals" in results:
        sample["dist_vals"] = results["dist_vals"]
    return sample


def draw_sample(prepare: Callable[[int], Optional[dict]], idx: int, size: int, tries: int = 50) -> dict:
    """``prepare(idx)``, and on a degenerate (None) sample another index drawn
    from ``RandomState(idx)``, up to ``tries`` times."""
    rng = np.random.RandomState(idx)
    for _ in range(tries):
        out = prepare(idx)
        if out is not None:
            return out
        idx = int(rng.randint(0, size))
    raise RuntimeError(f"could not draw a valid training sample in {tries} tries")


def train_transforms(input_size, anchor_cfg: AnchorConfig | None = None, max_gt: int = 32,
                     flip_ratio: float = 0.5, seed: Optional[int] = None) -> Compose:
    """The flagship's training transforms after loading and resizing:
    ``Compose([RandomFlip, GenerateDistanceMap, SampleDistanceAtAnchors, Pad])``."""
    anchors, _, _, _ = generate_anchors(tuple(input_size), anchor_cfg)
    return Compose([
        RandomFlip(flip_ratio, seed=seed),
        GenerateDistanceMap(),
        SampleDistanceAtAnchors(anchor_centers(anchors), max_gt=max_gt),
        Pad(size=tuple(input_size)),
    ])


class InMemoryBOPDataset:
    """Training samples from in-memory records, through a pipeline.

    A record holds ``img`` (H, W, 3) uint8 RGB at most ``input_size``,
    ``gt_bboxes`` (G, 4) xyxy float32, ``gt_labels`` (G,) and binary
    visible masks ``gt_masks`` (G, H, W) uint8.  Item ``i`` is record ``i``
    through ``pipeline`` and :func:`pack_sample`, resampled when it has no
    GT: what the file-backed ``BOPDataset`` yields after loading."""

    def __init__(self, records: Sequence[Dict[str, Any]], pipeline: Compose, max_gt: int = 32,
                 classes: Sequence[str] = ()):
        self.records = list(records)
        self.pipeline = pipeline
        self.max_gt = max_gt
        self.CLASSES = list(classes)

    def __len__(self) -> int:
        return len(self.records)

    def prepare_sample(self, idx: int) -> Optional[dict]:
        rec = self.records[idx]
        h, w = rec["img"].shape[:2]
        results = dict(
            img=rec["img"],
            img_shape=(h, w),
            ori_shape=(h, w),
            scale_factor=np.ones(4, np.float32),
            gt_bboxes=np.asarray(rec["gt_bboxes"], np.float32).reshape(-1, 4),
            gt_labels=np.asarray(rec["gt_labels"], np.int64),
            gt_masks=rec["gt_masks"],
        )
        results = self.pipeline(results)
        return None if results is None else pack_sample(results, self.max_gt, img_id=idx)

    def __getitem__(self, idx: int) -> dict:
        return draw_sample(self.prepare_sample, idx, len(self))
