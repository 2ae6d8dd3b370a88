"""The generic anchor heads (port of ``radet_tpu/models/anchor_heads.py``).

- ``ATSSHead``: RADet's tower (``stacked_convs`` 3x3 conv + GroupNorm(32) +
  ReLU blocks on separate cls and reg branches shared across levels), then
  3x3 ``atss_cls`` (A * C channels, prior-probability bias),
  ``atss_reg`` (A * 4, times a per-level Scale, with no ReLU and no exp) and
  ``atss_centerness`` (A, on the reg branch).
- ``AnchorHead``: no tower, a 1x1 ``conv_cls`` (A * C) and a 1x1
  ``conv_reg`` (A * 4) on the neck's maps (the RetinaNet-base layout).

Outputs are float32 NHWC maps per level; :func:`flatten_anchor_outputs`
reshapes (B, H, W, A * k) to (B, H * W * A, k), the anchor order of
``core.anchor_generator`` (A fastest within a cell).  mmdet's state-dict
names: ``cls_convs.{i}.conv/.gn``, ``atss_cls``, ``scales.{i}.scale``,
``conv_cls``, ``conv_reg``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import Conv2d, normal_
from .radet_head import RADetHead


class ATSSHead(RADetHead):
    """RADet's head without the ReLU on the regression, with A anchors per
    cell; same parameters, initialisation and outputs (cls, reg,
    centerness)."""

    reg_relu = False


class AnchorHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256, num_levels: int = 5, num_anchors: int = 1):
        super().__init__()
        self.num_levels = num_levels
        self.conv_cls = Conv2d(in_channels, num_anchors * num_classes, 1)
        self.conv_reg = Conv2d(in_channels, num_anchors * 4, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.01) kernels, zero bias."""
        with torch.no_grad():
            for conv in (self.conv_cls, self.conv_reg):
                normal_(conv.weight, 0.01, generator)
                conv.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if len(feats) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} pyramid levels, got {len(feats)}")
        cls_out = [self.conv_cls(x).float().permute(0, 2, 3, 1) for x in feats]
        reg_out = [self.conv_reg(x).float().permute(0, 2, 3, 1) for x in feats]
        return cls_out, reg_out


def flatten_anchor_outputs(maps_list: Sequence[torch.Tensor], last_dim: int) -> torch.Tensor:
    """Per-level (B, H, W, A * k) maps -> (B, H * W * A, k), levels concatenated."""
    b = maps_list[0].shape[0]
    return torch.cat([m.reshape(b, -1, last_dim) for m in maps_list], dim=1)
