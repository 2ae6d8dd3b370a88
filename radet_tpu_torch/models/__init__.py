from .builder import build_detector
from .detector import RADet, flatten_head_outputs, preprocess_images
from .fpn import FPN
from .postprocess import Detections, get_bboxes
from .radet_head import RADetHead
from .resnet import ResNet

__all__ = [
    "Detections",
    "FPN",
    "RADet",
    "RADetHead",
    "ResNet",
    "build_detector",
    "flatten_head_outputs",
    "get_bboxes",
    "preprocess_images",
]
