"""COCO bbox evaluation, numpy only."""

from .coco_eval import COCOEvaluator, iou_xywh

__all__ = ["COCOEvaluator", "iou_xywh"]
