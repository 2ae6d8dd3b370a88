"""Host data path: image files without cv2, numpy transforms (CosyPoseAug's
ops, uint8 HSV, box blur, affine warps and Telea inpainting in host C++;
polygon masks), the file-backed BOP dataset and its
wrappers, sample packing, an in-memory training source and the batching
loader."""

from .bop import BOPDataset, InMemoryBOPDataset, draw_sample, pack_sample, train_transforms
from .coco_io import CocoIndex
from .image_io import imread, imread_rgb
from .loader import DataLoader, collate
from .pipeline import (
    Compose,
    GenerateDistanceMap,
    LoadImageFromFile,
    Pad,
    RandomFlip,
    Resize,
    SampleDistanceAtAnchors,
    build_pipeline,
)

__all__ = [
    "BOPDataset",
    "CocoIndex",
    "Compose",
    "DataLoader",
    "GenerateDistanceMap",
    "InMemoryBOPDataset",
    "LoadImageFromFile",
    "Pad",
    "RandomFlip",
    "Resize",
    "SampleDistanceAtAnchors",
    "build_pipeline",
    "collate",
    "draw_sample",
    "imread",
    "imread_rgb",
    "pack_sample",
    "train_transforms",
]
