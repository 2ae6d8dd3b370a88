"""Host data path of the training step: numpy transforms, sample packing,
an in-memory sample source and the batching loader."""

from .bop import InMemoryBOPDataset, draw_sample, pack_sample, train_transforms
from .loader import DataLoader, collate
from .pipeline import (
    Compose,
    GenerateDistanceMap,
    Pad,
    RandomFlip,
    SampleDistanceAtAnchors,
    build_pipeline,
)

__all__ = [
    "Compose",
    "DataLoader",
    "GenerateDistanceMap",
    "InMemoryBOPDataset",
    "Pad",
    "RandomFlip",
    "SampleDistanceAtAnchors",
    "build_pipeline",
    "collate",
    "draw_sample",
    "pack_sample",
    "train_transforms",
]
