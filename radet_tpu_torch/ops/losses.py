"""Loss primitives (port of ``radet_tpu/ops/losses.py``): plain PyTorch,
differentiable, float32.

Every loss reduces as mmdet's ``weight_reduce_loss`` with ``reduction='sum'``
and an explicit ``avg_factor``: sum(loss * weight) / max(avg_factor, 1e-12)
times ``loss_weight``.  ``avg_factor`` may be a tensor or a number.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.box_ops import bbox_giou_aligned, bbox_iou_aligned


def _weighted_total(loss, weight, avg_factor, loss_weight):
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if avg_factor is not None:
        if isinstance(avg_factor, torch.Tensor):
            total = total / avg_factor.clamp(min=1e-12)
        else:
            total = total / max(float(avg_factor), 1e-12)
    return total * loss_weight


def _bce_terms(logits, targets):
    """Numerically stable BCE with logits: max(x, 0) - x t + log1p(exp(-|x|))."""
    return (
        torch.maximum(logits, torch.zeros_like(logits))
        - logits * targets
        + torch.log1p(torch.exp(-logits.abs()))
    )


def sigmoid_focal_loss(
    logits,
    labels,
    weight=None,
    *,
    num_classes: int,
    gamma: float = 2.0,
    alpha: float = 0.25,
    avg_factor=None,
    loss_weight: float = 1.0,
):
    """Multi-class sigmoid focal loss.

    logits (N, C); labels (N,) class indices where ``num_classes`` is the
    background (all-zero target); weight (N,) or None."""
    target = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes].to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = _bce_terms(logits, target)
    pt = p * target + (1.0 - p) * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) * torch.pow(1.0 - pt, gamma)
    return _weighted_total((ce * focal_weight).sum(-1), weight, avg_factor, loss_weight)


def giou_loss(pred_boxes, target_boxes, weight=None, avg_factor=None, loss_weight: float = 2.0):
    """1 - GIoU over aligned xyxy boxes."""
    loss = 1.0 - bbox_giou_aligned(pred_boxes, target_boxes)
    return _weighted_total(loss, weight, avg_factor, loss_weight)


def iou_loss(pred_boxes, target_boxes, weight=None, avg_factor=None,
             loss_weight: float = 2.0, linear: bool = False, eps: float = 1e-6):
    """-log(IoU), or 1 - IoU when ``linear``."""
    ious = bbox_iou_aligned(pred_boxes, target_boxes).clamp(min=eps)
    loss = (1.0 - ious) if linear else -torch.log(ious)
    return _weighted_total(loss, weight, avg_factor, loss_weight)


def bounded_iou_loss(pred_boxes, target_boxes, weight=None, avg_factor=None,
                     loss_weight: float = 2.0, beta: float = 0.2, eps: float = 1e-3):
    """Bounded IoU loss: per box, the sum of the four smooth-L1'd bound terms;
    the target takes no gradient."""
    px = (pred_boxes[..., 0] + pred_boxes[..., 2]) * 0.5
    py = (pred_boxes[..., 1] + pred_boxes[..., 3]) * 0.5
    pw = pred_boxes[..., 2] - pred_boxes[..., 0]
    ph = pred_boxes[..., 3] - pred_boxes[..., 1]
    t = target_boxes.detach()
    tx = (t[..., 0] + t[..., 2]) * 0.5
    ty = (t[..., 1] + t[..., 3]) * 0.5
    tw = t[..., 2] - t[..., 0]
    th = t[..., 3] - t[..., 1]
    dx = (tx - px).abs()
    dy = (ty - py).abs()
    zero = torch.zeros_like(dx)
    loss_dx = 1.0 - torch.maximum((tw - 2 * dx) / (tw + 2 * dx + eps), zero)
    loss_dy = 1.0 - torch.maximum((th - 2 * dy) / (th + 2 * dy + eps), zero)
    loss_dw = 1.0 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1.0 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta, comb - 0.5 * beta)
    return _weighted_total(loss.sum(-1), weight, avg_factor, loss_weight)


def _diou_terms(pred, target, eps):
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    ag = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    ious = overlap / (ap + ag - overlap + eps)
    enc_wh = (torch.maximum(pred[..., 2:], target[..., 2:])
              - torch.minimum(pred[..., :2], target[..., :2])).clamp(min=0)
    c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    rho2 = (((target[..., 0] + target[..., 2]) - (pred[..., 0] + pred[..., 2])) ** 2
            + ((target[..., 1] + target[..., 3]) - (pred[..., 1] + pred[..., 3])) ** 2) / 4.0
    return ious, rho2, c2


def diou_loss(pred_boxes, target_boxes, weight=None, avg_factor=None,
              loss_weight: float = 2.0, eps: float = 1e-7):
    """Distance-IoU loss."""
    ious, rho2, c2 = _diou_terms(pred_boxes, target_boxes, eps)
    return _weighted_total(1.0 - (ious - rho2 / c2), weight, avg_factor, loss_weight)


def ciou_loss(pred_boxes, target_boxes, weight=None, avg_factor=None,
              loss_weight: float = 2.0, eps: float = 1e-7):
    """Complete-IoU loss (aspect term v**2 / (1 - iou + v), alpha not detached)."""
    ious, rho2, c2 = _diou_terms(pred_boxes, target_boxes, eps)
    w1 = pred_boxes[..., 2] - pred_boxes[..., 0]
    h1 = pred_boxes[..., 3] - pred_boxes[..., 1] + eps
    w2 = target_boxes[..., 2] - target_boxes[..., 0]
    h2 = target_boxes[..., 3] - target_boxes[..., 1] + eps
    v = (4.0 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    # the term's limit at (iou == 1, v == 0) is 0: the double where keeps the
    # gradient free of the 0/0 as well
    denom = 1.0 - ious + v
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    aspect = torch.where(denom > 0, v**2 / safe, torch.zeros_like(denom))
    loss = 1.0 - (ious - (rho2 / c2 + aspect))
    return _weighted_total(loss, weight, avg_factor, loss_weight)


def l1_box_loss(pred_boxes, target_boxes, weight=None, avg_factor=None, loss_weight: float = 2.0):
    """L1 on decoded xyxy boxes; the per-box weight covers the 4 coordinates."""
    w = None if weight is None else weight[..., None]
    return l1_loss(pred_boxes, target_boxes, weight=w, avg_factor=avg_factor, loss_weight=loss_weight)


def smooth_l1_box_loss(pred_boxes, target_boxes, weight=None, avg_factor=None,
                       loss_weight: float = 2.0, beta: float = 1.0):
    """Smooth-L1 on decoded xyxy boxes (same weight expansion as L1)."""
    w = None if weight is None else weight[..., None]
    return smooth_l1_loss(pred_boxes, target_boxes, beta=beta, weight=w,
                          avg_factor=avg_factor, loss_weight=loss_weight)


#: config ``loss_bbox.type`` -> implementation
BBOX_LOSS_FNS = {
    "GIoULoss": giou_loss,
    "IoULoss": iou_loss,
    "BoundedIoULoss": bounded_iou_loss,
    "DIoULoss": diou_loss,
    "CIoULoss": ciou_loss,
    "L1Loss": l1_box_loss,
    "SmoothL1Loss": smooth_l1_box_loss,
}


def bce_with_logits(logits, targets, weight=None, avg_factor=None, loss_weight: float = 1.0):
    """Binary cross-entropy with logits and (possibly soft) targets."""
    return _weighted_total(_bce_terms(logits, targets), weight, avg_factor, loss_weight)


def smooth_l1_loss(pred, target, beta: float = 1.0, weight=None, avg_factor=None,
                   loss_weight: float = 1.0):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return _weighted_total(loss, weight, avg_factor, loss_weight)


def l1_loss(pred, target, weight=None, avg_factor=None, loss_weight: float = 1.0):
    return _weighted_total((pred - target).abs(), weight, avg_factor, loss_weight)
