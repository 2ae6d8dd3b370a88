"""RADet dense head (port of ``radet_tpu/models/radet_head.py``, float only).

- ``stacked_convs`` blocks of 3x3 conv + GroupNorm(32) + ReLU on each of the
  cls and reg branches, shared across the pyramid levels;
- heads: cls (``num_classes`` channels), reg (4 channels, times a
  per-level learnable Scale, then ReLU) and an IoU-quality channel on the
  reg branch;
- cls bias initialised to -log((1-p)/p), p = 0.01.

mmdet names: ``cls_convs.{i}.conv/.gn``, ``atss_cls``, ``atss_reg``,
``atss_centerness``, ``scales.{i}.scale``.  Outputs are float32 and NHWC per
level, as in the JAX package, so that flattening them follows the anchor
order (x fastest).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, normal_


class ConvGNBlock(nn.Module):
    """3x3 conv (compute dtype) + GroupNorm(32) in float32 + ReLU."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, padding=1, bias=False)
        self.gn = nn.GroupNorm(32, channels, eps=1e-5)

    def forward(self, x):
        # GroupNorm in float32 on the upcast conv output, as the JAX package
        # does under bf16 compute
        return F.relu(self.gn(self.conv(x).float())).to(x.dtype)


class Scale(nn.Module):
    """mmcv ``Scale``: one learnable scalar."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x):
        return x * self.scale


class RADetHead(nn.Module):
    #: ReLU on the scaled regression (RADet's addition to the ATSS head)
    reg_relu = True

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 256,
        feat_channels: int = 256,
        stacked_convs: int = 4,
        num_levels: int = 5,
        num_anchors: int = 1,
    ):
        super().__init__()
        chans = [in_channels] + [feat_channels] * (stacked_convs - 1)
        self.cls_convs = nn.ModuleList(ConvGNBlock(c, feat_channels) for c in chans)
        self.reg_convs = nn.ModuleList(ConvGNBlock(c, feat_channels) for c in chans)
        self.atss_cls = Conv2d(feat_channels, num_anchors * num_classes, 3, padding=1)
        self.atss_reg = Conv2d(feat_channels, num_anchors * 4, 3, padding=1)
        self.atss_centerness = Conv2d(feat_channels, num_anchors, 3, padding=1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in range(num_levels))

    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.01) kernels, zero bias except cls at -log(99), identity GN,
        unit scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv2d):
                    normal_(m.weight, 0.01, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, Scale):
                    m.scale.fill_(1.0)
            self.atss_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(
        self, feats: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        if len(feats) != len(self.scales):
            raise ValueError(f"expected {len(self.scales)} pyramid levels, got {len(feats)}")
        cls_out, reg_out, iou_out = [], [], []
        for scale, x in zip(self.scales, feats):
            cls_feat, reg_feat = x, x
            for blk in self.cls_convs:
                cls_feat = blk(cls_feat)
            for blk in self.reg_convs:
                reg_feat = blk(reg_feat)
            cls_score = self.atss_cls(cls_feat).float()
            bbox_pred = scale(self.atss_reg(reg_feat).float())
            if self.reg_relu:
                bbox_pred = F.relu(bbox_pred)
            iou_pred = self.atss_centerness(reg_feat).float()
            cls_out.append(cls_score.permute(0, 2, 3, 1))
            reg_out.append(bbox_pred.permute(0, 2, 3, 1))
            iou_out.append(iou_pred.permute(0, 2, 3, 1))
        return cls_out, reg_out, iou_out
