"""Single-stage detectors (backbone -> FPN -> head): RADet and the generic
anchor heads' ``SingleStageDetector``, port of ``radet_tpu/models/detector.py``.

The model consumes normalized float NCHW images; uint8 -> float
normalization runs on the device in :func:`preprocess_images`, so
host -> device transfers stay uint8.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .fpn import FPN


def preprocess_images(images_u8, mean, std, dtype=torch.float32):
    """uint8 RGB NHWC -> normalized ``dtype`` NCHW, on the images' device.

    The result is a channels-last view (NHWC bytes in NCHW shape): no
    transpose is copied, and cuDNN's convolutions take that layout as is.
    ``mean``/``std`` are per-channel tensors or sequences.  The
    normalization runs in float32, or in ``dtype`` where that is wider (a
    float64 model).
    """
    work = torch.promote_types(dtype, torch.float32)
    x = images_u8.to(work)
    mean = torch.as_tensor(mean, dtype=work, device=x.device)
    std = torch.as_tensor(std, dtype=work, device=x.device)
    x = (x - mean) / std
    return x.to(dtype).permute(0, 3, 1, 2)


class SingleStageDetector(nn.Module):
    """Backbone (any of ``models/resnet.py``'s zoo) -> FPN -> dense head.
    ``dtype`` is the compute dtype of the convolutions; parameters stay
    float32, GroupNorm and the head outputs run in float32."""

    def __init__(self, backbone: nn.Module, neck: FPN, bbox_head: nn.Module, dtype=torch.float32):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.dtype = dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init of every parameter and buffer (the JAX
        package's initialisers, drawn from a torch generator)."""
        self.backbone.init_weights(generator)
        self.neck.init_weights(generator)
        self.bbox_head.init_weights(generator)

    def forward(self, images):
        """images: (B, 3, H, W) normalized -> the head's per-level lists of
        float32 NHWC maps: (cls, reg, iou) for RADetHead, (cls, reg,
        centerness) for ATSSHead, (cls, reg) for AnchorHead."""
        feats = self.backbone(images.to(self.dtype))
        return self.bbox_head(self.neck(feats))


class RADet(SingleStageDetector):
    """The RADet detector: a single-stage detector with ``RADetHead``."""


def flatten_head_outputs(cls_list, reg_list, iou_list):
    """Per-level NHWC outputs -> anchor-ordered flat tensors.

    The NHWC reshape (B, H*W, C) concatenated over levels follows the anchor
    order of ``core.anchors.generate_anchors`` (levels in stride order,
    row-major within a level).  Returns (cls (B, N, C), reg (B, N, 4),
    iou (B, N)).
    """
    b = cls_list[0].shape[0]
    cls = torch.cat([c.reshape(b, -1, c.shape[-1]) for c in cls_list], dim=1)
    reg = torch.cat([r.reshape(b, -1, 4) for r in reg_list], dim=1)
    iou = torch.cat([i.reshape(b, -1) for i in iou_list], dim=1)
    return cls, reg, iou
