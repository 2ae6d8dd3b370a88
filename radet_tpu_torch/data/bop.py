"""BOP datasets (port of ``radet_tpu/data/bop.py``): the file-backed
:class:`BOPDataset` (COCO json with BOP extensions, images and masks read
without cv2) in training and test mode, the static-shape packing of
training samples, and an in-memory source that serves training samples.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.anchors import AnchorConfig, anchor_centers, generate_anchors
from .coco_io import CocoIndex
from .pipeline import (
    Compose,
    GenerateDistanceMap,
    Pad,
    RandomFlip,
    SampleDistanceAtAnchors,
    build_pipeline,
)

MASK_PATH_TEMPLATE = "{:06d}/mask_visib/{:06d}_{:06d}.png"
# one instance-id map per image (0 = background, ann_idx + 1 = instance)
MASK_PACKED_TEMPLATE = "{:06d}/mask_packed/{:06d}.png"


class BOPDataset:
    """COCO-format BOP annotations and image files as static-shape samples.

    Training (the default, ``test_mode=False``): item ``i`` is image ``i``
    through the pipeline and :func:`pack_sample` (``image``, ``img_shape``,
    ``scale_factor``, ``img_id``, ``gt_boxes``, ``gt_labels``, ``gt_valid``
    and, when the pipeline samples them, ``dist_vals``); a sample without
    GT is replaced by :func:`draw_sample`'s draws.  With
    ``filter_empty_gt`` the images without trainable GT (none that is not
    ignored, of a known class, not difficult and at least
    ``min_visib_frac`` visible) are dropped up front.

    Test mode: ``image`` uint8 (H, W, 3) padded to ``input_size``,
    ``img_shape`` (2,) and ``scale_factor`` (4,) float32, ``img_id``.

    ``classes`` selects and orders the categories by name (``cat2label``);
    ``orientation`` ('landscape' / 'portrait') keeps only the images of that
    orientation (the static-shape view of an aspect-mixed dataset, which
    ``apis.test.test_from_config`` builds per orientation).  ``det2json``
    and ``bop_det2json`` write COCO results and the BOP submission format."""

    def __init__(
        self,
        ann_file: str,
        img_prefix: str = "",
        seg_prefix: Optional[str] = None,
        classes: Optional[Sequence[str]] = None,
        pipeline: Optional[Sequence[dict]] = None,
        test_mode: bool = False,
        min_visib_frac: float = 0.0,
        filter_empty_gt: bool = True,
        bop_submission: bool = False,
        input_size: Tuple[int, int] = (480, 640),
        max_gt: int = 32,
        anchor_cfg: Optional[AnchorConfig] = None,
        img_norm: Optional[dict] = None,
        orientation: Optional[str] = None,
    ):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix if seg_prefix is not None else img_prefix
        self.test_mode = test_mode
        self.min_visib_frac = min_visib_frac
        self.bop_submission = bop_submission
        self.input_size = tuple(input_size)
        self.max_gt = max_gt

        self.coco = CocoIndex(ann_file)
        self.cat_ids = self.coco.get_cat_ids(classes)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.CLASSES = (
            list(classes) if classes is not None else [self.coco.cats[c]["name"] for c in self.cat_ids]
        )
        self.img_ids = self.coco.get_img_ids()
        self.data_infos = [self.coco.load_img(i) for i in self.img_ids]
        if orientation is not None:
            if orientation not in ("landscape", "portrait"):
                raise ValueError(f"orientation must be 'landscape' or 'portrait', got {orientation!r}")
            want_portrait = orientation == "portrait"
            keep = [i for i, info in enumerate(self.data_infos)
                    if (info["height"] > info["width"]) == want_portrait]
            self.img_ids = [self.img_ids[i] for i in keep]
            self.data_infos = [self.data_infos[i] for i in keep]
        if not test_mode and filter_empty_gt:
            keep = [i for i, info in enumerate(self.data_infos) if self._has_valid_gt(info)]
            self.img_ids = [self.img_ids[i] for i in keep]
            self.data_infos = [self.data_infos[i] for i in keep]

        anchors, _, _, _ = generate_anchors(self.input_size, anchor_cfg or AnchorConfig())
        self.pipeline: Optional[Compose] = None
        if pipeline is not None:
            self.pipeline = build_pipeline(
                pipeline, input_size=self.input_size, anchor_centers=anchor_centers(anchors),
                max_gt=max_gt, img_norm=img_norm,
            )

    def __len__(self) -> int:
        return len(self.img_ids)

    def _has_valid_gt(self, img_info: dict) -> bool:
        for ann in self.coco.get_anns(img_info["id"]):
            if ann.get("ignore", False) or ann["category_id"] not in self.cat2label or ann.get("difficult", 0):
                continue
            if ann.get("visib_fract", 1.0) >= self.min_visib_frac:
                return True
        return False

    def parse_ann_info(self, img_info: dict) -> Dict[str, Any]:
        """Boxes and labels of an image's annotations; ignored, empty,
        degenerate and unknown-category ones dropped, those below
        ``min_visib_frac`` (or marked difficult) kept as ignore regions."""
        anns = self.coco.get_anns(img_info["id"])
        parts = img_info["filename"].rsplit("/", 3)
        try:
            # BOP layout: {scene:06d}/rgb/{img:06d}.png
            scene_id = int(parts[-3]) if len(parts) >= 3 else 0
            img_id_in_scene = int(osp.splitext(parts[-1])[0])
        except ValueError:
            scene_id, img_id_in_scene = 0, 0

        gt_bboxes, gt_labels, gt_masks, gt_bboxes_ignore = [], [], [], []
        gt_labels_ignore, gt_polys, gt_masks_idx = [], [], []
        for i, ann in enumerate(anns):
            if ann.get("ignore", False):
                continue
            x1, y1, w, h = ann["bbox"]
            inter_w = max(0, min(x1 + w, img_info["width"]) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info["height"]) - max(y1, 0))
            if inter_w * inter_h == 0:
                continue
            if ann.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if ann["category_id"] not in self.cat2label:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get("visib_fract", 1.0) < self.min_visib_frac or ann.get("difficult", 0):
                gt_bboxes_ignore.append(bbox)
                gt_labels_ignore.append(self.cat2label[ann["category_id"]])
            else:
                gt_bboxes.append(bbox)
                gt_labels.append(self.cat2label[ann["category_id"]])
                gt_masks.append(MASK_PATH_TEMPLATE.format(scene_id, img_id_in_scene, i))
                gt_masks_idx.append(i)
                gt_polys.append(ann.get("segmentation"))

        return dict(
            bboxes=np.asarray(gt_bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(gt_labels, np.int64),
            bboxes_ignore=np.asarray(gt_bboxes_ignore, np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(gt_labels_ignore, np.int64),
            masks=gt_masks,
            masks_idx=gt_masks_idx,
            mask_packed=MASK_PACKED_TEMPLATE.format(scene_id, img_id_in_scene),
            segmentations=gt_polys if any(p is not None for p in gt_polys) else None,
            scene_id=scene_id,
            img_id_in_scene=img_id_in_scene,
        )

    def prepare_sample(self, idx: int) -> Optional[Dict[str, Any]]:
        """Image ``idx`` through the pipeline: a test sample, or a training
        sample (None when it has no GT)."""
        img_info = self.data_infos[idx]
        results = self.pipeline(dict(
            img_info=img_info,
            ann_info=self.parse_ann_info(img_info),
            img_prefix=self.img_prefix,
            seg_prefix=self.seg_prefix,
        ))
        if not self.test_mode:
            return None if results is None else pack_sample(results, self.max_gt, img_id=self.img_ids[idx])
        h, w = results["img_shape"]
        return dict(
            image=np.ascontiguousarray(results["img"]),
            img_shape=np.asarray([h, w], np.float32),
            scale_factor=results["scale_factor"].astype(np.float32),
            img_id=np.int64(self.img_ids[idx]),
        )

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self.test_mode:
            return self.prepare_sample(idx)
        return draw_sample(self.prepare_sample, idx, len(self))

    def det2json(self, detections: List[dict]) -> List[dict]:
        """COCO-style results. ``detections``: per-image dict with keys
        boxes (M, 4 xyxy), scores (M,), labels (M,), img_id."""
        out = []
        for det in detections:
            img_id = int(det["img_id"])
            for box, score, label in zip(det["boxes"], det["scores"], det["labels"]):
                x1, y1, x2, y2 = [float(v) for v in box]
                out.append(dict(image_id=img_id, bbox=[x1, y1, x2 - x1, y2 - y1], score=float(score),
                                category_id=self.cat_ids[int(label)]))
        return out

    def bop_det2json(self, detections: List[dict]) -> List[dict]:
        """The BOP challenge submission format (scene_id, image_id,
        category_id, xywh bbox, score, time=-1)."""
        out = []
        id_to_info = {info["id"]: info for info in self.data_infos}
        for det in detections:
            info = id_to_info[int(det["img_id"])]
            parts = info["filename"].rsplit("/", 3)
            scene_id = int(parts[-3])
            image_id = int(osp.splitext(parts[-1])[0])
            for box, score, label in zip(det["boxes"], det["scores"], det["labels"]):
                x1, y1, x2, y2 = [float(v) for v in box]
                out.append(dict(scene_id=scene_id, image_id=image_id, category_id=self.cat_ids[int(label)],
                                bbox=[x1, y1, x2 - x1, y2 - y1], score=float(score), time=-1.0))
        return out


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
