from .anchor_heads import AnchorHead, ATSSHead
from .builder import build_backbone, build_detector
from .detector import RADet, SingleStageDetector, flatten_head_outputs, preprocess_images
from .fpn import FPN, ChannelMapper
from .postprocess import Detections, get_bboxes, get_bboxes_anchor
from .radet_head import RADetHead
from .resnet import RegNet, ResNet

__all__ = [
    "ATSSHead",
    "AnchorHead",
    "ChannelMapper",
    "Detections",
    "FPN",
    "RADet",
    "RADetHead",
    "RegNet",
    "ResNet",
    "SingleStageDetector",
    "build_backbone",
    "build_detector",
    "flatten_head_outputs",
    "get_bboxes",
    "get_bboxes_anchor",
    "preprocess_images",
]
