"""Detection evaluation in numpy: the COCO bbox protocol, LVIS's federated
protocol and VOC's mean AP."""

from .coco_eval import COCOEvaluator, iou_xywh
from .lvis_eval import LVISEvaluator
from .voc_eval import average_precision, eval_map, eval_recalls

__all__ = ["COCOEvaluator", "LVISEvaluator", "average_precision", "eval_map", "eval_recalls", "iou_xywh"]
