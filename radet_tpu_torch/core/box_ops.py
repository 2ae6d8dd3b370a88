"""Box IoU and GIoU (port of ``radet_tpu/core/box_ops.py``): element-wise
over equal-shaped (..., 4) xyxy tensors, and the pairwise IoU of two box
sets; differentiable."""

from __future__ import annotations

import torch

EPS = 1e-6


def bbox_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def _inter_union(a, b):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, bbox_area(a) + bbox_area(b) - inter


def bbox_iou_aligned(a, b, eps: float = EPS):
    """Element-wise IoU of equal-shaped (..., 4) xyxy boxes."""
    inter, union = _inter_union(a, b)
    return inter / union.clamp(min=eps)


def bbox_giou_aligned(a, b, eps: float = EPS):
    """Element-wise GIoU of equal-shaped (..., 4) xyxy boxes."""
    inter, union = _inter_union(a, b)
    iou = inter / union.clamp(min=eps)
    enclose_wh = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    enclose = (enclose_wh[..., 0] * enclose_wh[..., 1]).clamp(min=eps)
    return iou - (enclose - union) / enclose


def bbox_iou_pairwise(a, b, eps: float = EPS):
    """Pairwise IoU: a (..., N, 4) x b (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return inter / union.clamp(min=eps)
