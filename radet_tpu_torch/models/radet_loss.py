"""RADet head loss over flat head outputs (port of
``radet_tpu/models/radet_loss.py``).

- focal classification loss over all cells; per-cell weights are the
  assignment's (positives: sample multiplicity, negatives 1, ignores 0) and
  ``avg_factor`` is the positive weight sum plus the number of images;
- box loss (GIoU by default) on decoded boxes, each positive weighted by the
  detached IoU(pred, target) times its cell weight, averaged by that
  weight's sum;
- IoU-quality branch: BCE against the detached IoU, weighted by the cell
  weight, averaged by the positive weight sum.

Each cell's GT label and box come from ``torch.gather`` on its assigned GT
index, dense over the static (B, N) anchor grid.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.box_coder import tblr_decode
from ..core.box_ops import bbox_iou_aligned
from ..ops.losses import BBOX_LOSS_FNS, bce_with_logits, sigmoid_focal_loss

EPS = 1e-12


def radet_loss(
    cls_flat,  # (B, N, C) logits
    reg_flat,  # (B, N, 4) tblr predictions (already ReLU'd)
    iou_flat,  # (B, N) logits
    anchors,  # (N, 4)
    gt_boxes,  # (B, G, 4)
    gt_labels,  # (B, G) int
    gt_idx,  # (B, N) int: >=0 pos, -1 neg, -2 ignore
    weight,  # (B, N) float32
    *,
    num_classes: int,
    normalizer: float = 1.0 / 8.0,
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
    cls_loss_weight: float = 1.0,
    bbox_loss_weight: float = 2.0,
    iou_loss_weight: float = 1.0,
    bbox_loss_type: str = "GIoULoss",
    bbox_loss_extra: tuple = (),
) -> Dict[str, torch.Tensor]:
    b, n, c = cls_flat.shape
    pos = gt_idx >= 0
    ignore = gt_idx == -2
    safe_idx = gt_idx.clamp(min=0).long()

    # positives (and ignores, whose weight is 0) take their GT's class,
    # negatives the background index ``num_classes``
    assigned_labels = torch.gather(gt_labels.long(), 1, safe_idx)
    labels = torch.where(pos | ignore, assigned_labels, torch.full_like(assigned_labels, num_classes))
    cls_weight = torch.where(ignore, torch.zeros_like(weight), weight)
    pos_w = torch.where(pos, weight, torch.zeros_like(weight))
    num_pos = pos_w.sum()

    loss_cls = sigmoid_focal_loss(
        cls_flat.reshape(-1, c),
        labels.reshape(-1),
        cls_weight.reshape(-1),
        num_classes=num_classes,
        gamma=focal_gamma,
        alpha=focal_alpha,
        avg_factor=num_pos + b,
        loss_weight=cls_loss_weight,
    )

    target_boxes = torch.gather(gt_boxes, 1, safe_idx[..., None].expand(b, n, 4))
    decoded = tblr_decode(anchors[None], reg_flat, normalizer=normalizer)
    iou_target = bbox_iou_aligned(decoded, target_boxes).detach()

    bbox_w = torch.where(pos, iou_target.clamp(min=EPS) * weight, torch.zeros_like(weight))
    loss_bbox = BBOX_LOSS_FNS[bbox_loss_type](
        decoded,
        target_boxes,
        weight=bbox_w,
        avg_factor=bbox_w.sum(),
        loss_weight=bbox_loss_weight,
        **dict(bbox_loss_extra),
    )
    loss_iou = bce_with_logits(
        iou_flat, iou_target, weight=pos_w, avg_factor=num_pos, loss_weight=iou_loss_weight
    )
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_iou=loss_iou, num_pos=num_pos)
