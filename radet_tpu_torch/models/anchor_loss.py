"""Training losses of the generic anchor heads (port of
``radet_tpu/models/anchor_loss.py``): dense masked arithmetic over the
(B, N) anchor grid, with the assignment batched over the images.

- :func:`atss_loss` (ATSSHead): ATSS assignment, focal classification loss
  over ``sum_i max(num_pos_i, 1)``, a quality-weighted box loss on decoded
  boxes over the sum of the quality weights, and BCE of the centerness
  logits against the quality.
- :func:`anchor_head_loss` (AnchorHead): MaxIoU assignment, mmdet's
  PseudoSampler or, under a sampling loss (sigmoid CE), one of its
  samplers (:func:`random_sample_masks`, ``core.sampler_cores``), focal or
  sigmoid-CE classification loss and SmoothL1 / L1 on the encoded deltas
  (or an IoU-family loss on decoded boxes with ``reg_decoded_bbox``).

The normalisers are sums over the whole batch, which is what mmdet's
per-replica ``reduce_mean`` followed by data-parallel averaging computes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..core.anchor_assign import assigned_to_dense_targets, atss_assign, max_iou_assign
from ..core.box_ops import bbox_iou_aligned
from ..core.sampler_cores import as_draws, neg_quota, random_side, sample_with
from ..ops.losses import BBOX_LOSS_FNS, bce_with_logits, l1_loss, sigmoid_focal_loss, smooth_l1_loss

EPS = 1e-12
NON_SAMPLING_LOSSES = ("FocalLoss", "GHMC", "QualityFocalLoss")


def centerness_target(anchors, target_boxes, pos):
    """FCOS centerness of each anchor's center in its target box, 0 where
    not ``pos`` (clamped there, so no NaN reaches a product with 0)."""
    acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    l_ = acx - target_boxes[..., 0]
    t_ = acy - target_boxes[..., 1]
    r_ = target_boxes[..., 2] - acx
    b_ = target_boxes[..., 3] - acy
    lr = torch.minimum(l_, r_) / torch.maximum(l_, r_).clamp(min=EPS)
    tb = torch.minimum(t_, b_) / torch.maximum(t_, b_).clamp(min=EPS)
    c = torch.sqrt(lr.clamp(min=0.0) * tb.clamp(min=0.0))
    return torch.where(pos, c, torch.zeros_like(c))


def atss_loss(
    cls_flat,  # (B, N, C) logits
    reg_flat,  # (B, N, 4) encoded deltas
    ctr_flat,  # (B, N) centerness logits
    anchors,  # (N, 4)
    num_level_anchors: Sequence[int],
    gt_boxes,  # (B, G, 4)
    gt_labels,  # (B, G)
    gt_valid,  # (B, G) bool
    *,
    num_classes: int,
    encode_fn,
    decode_fn,
    topk: int = 9,
    quality: str = "centerness",  # 'centerness' | 'iou'
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
    cls_loss_weight: float = 1.0,
    bbox_loss_type: str = "GIoULoss",
    bbox_loss_weight: float = 2.0,
    centerness_loss_weight: float = 1.0,
    valid_mask=None,  # optional (N,) bool anchor flags
) -> Dict[str, torch.Tensor]:
    """ATSSHead's losses (loss_cls, loss_bbox, loss_centerness) and the
    number of positives."""
    b, n, c = cls_flat.shape
    with torch.no_grad():
        assigned, _ = atss_assign(anchors, num_level_anchors, gt_boxes, gt_valid, topk=topk,
                                  inside_mask=valid_mask)
        labels, target_boxes, pos = assigned_to_dense_targets(assigned, gt_boxes, gt_labels, num_classes)
    label_weights = torch.ones((b, n), dtype=torch.float32, device=cls_flat.device)
    if valid_mask is not None:
        label_weights = label_weights * valid_mask[None].float()
        pos = pos & valid_mask[None]
    num_pos_img = pos.sum(dim=1)
    num_total_samples = num_pos_img.clamp(min=1).sum().float().clamp(min=1.0)

    loss_cls = sigmoid_focal_loss(
        cls_flat.reshape(-1, c), labels.reshape(-1), label_weights.reshape(-1), num_classes=num_classes,
        gamma=focal_gamma, alpha=focal_alpha, avg_factor=num_total_samples, loss_weight=cls_loss_weight,
    )
    decoded_pred = decode_fn(anchors[None], reg_flat)
    with torch.no_grad():
        decoded_target = decode_fn(anchors[None], encode_fn(anchors[None], target_boxes))
        if quality == "centerness":
            q = centerness_target(anchors[None], decoded_target, pos)
        else:  # 'iou': IoU of the prediction with its target, no gradient
            q = torch.where(pos, bbox_iou_aligned(decoded_pred, decoded_target), torch.zeros((), device=pos.device))
        q = torch.where(pos, q, torch.zeros_like(q))
        bbox_avg = q.sum()
    loss_bbox = BBOX_LOSS_FNS[bbox_loss_type](
        decoded_pred, decoded_target, weight=q,
        avg_factor=torch.where(bbox_avg < EPS, torch.ones_like(bbox_avg), bbox_avg),
        loss_weight=bbox_loss_weight,
    )
    loss_centerness = bce_with_logits(
        ctr_flat, q, weight=pos.float(), avg_factor=num_total_samples, loss_weight=centerness_loss_weight,
    )
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_centerness=loss_centerness,
                num_pos=num_pos_img.sum().float())


def random_sample_masks(draws, pos, neg, *, num: int, pos_fraction: float, neg_pos_ub: float = -1.0):
    """mmdet's RandomSampler on (B, N) masks: up to ``int(num *
    pos_fraction)`` positives uniformly without replacement ('pos'), then up
    to ``num`` less the sampled positives of the negatives ('neg'), at most
    ``neg_pos_ub * max(sampled positives, 1)`` when ``neg_pos_ub >= 0``.
    ``draws``: a ``core.sampler_cores`` draw source."""
    pos_s = random_side(draws, "pos", pos, int(num * pos_fraction))
    return pos_s, random_side(draws, "neg", neg, neg_quota(pos_s, num, neg_pos_ub))


def _sampler_signals(sampler_type, extra, cls_flat, reg_flat, labels, anchors, decode_fn) -> Dict:
    """What a sampler ranks by, without a gradient: the per-anchor sigmoid-CE
    loss summed over the classes (OHEM, ScoreHLR's renormalisation, an OHEM
    component), and for ScoreHLR the largest class score and the decoded
    boxes.  Only the sampler's own are computed."""
    out = {}
    components = dict(extra)
    if sampler_type in ("OHEMSampler", "ScoreHLRSampler") or (
            sampler_type == "CombinedSampler" and "ohem" in (components.get("pos_sampler"),
                                                              components.get("neg_sampler"))):
        x = cls_flat.float()
        tgt = F.one_hot(labels, x.shape[-1] + 1)[..., :-1].to(x.dtype)  # background: all zero
        out["per_loss"] = (x.clamp(min=0) - x * tgt + torch.log1p(torch.exp(-x.abs()))).sum(-1)
    if sampler_type == "ScoreHLRSampler":
        out["max_fg_score"] = torch.sigmoid(cls_flat.float()).amax(-1)
        out["decoded_boxes"] = decode_fn(anchors[None], reg_flat)
    return out


def anchor_head_loss(
    cls_flat,  # (B, N, C) logits
    reg_flat,  # (B, N, 4) encoded deltas
    anchors,  # (N, 4)
    gt_boxes,
    gt_labels,
    gt_valid,
    *,
    num_classes: int,
    encode_fn,
    decode_fn,
    pos_iou_thr: float = 0.5,
    neg_iou_thr=0.4,
    min_pos_iou: float = 0.0,
    gt_max_assign_all: bool = True,
    match_low_quality: bool = True,
    cls_loss: str = "FocalLoss",  # 'FocalLoss' | 'CrossEntropyLoss' (sigmoid)
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
    cls_loss_weight: float = 1.0,
    bbox_loss_type: str = "SmoothL1Loss",
    bbox_loss_weight: float = 1.0,
    smooth_l1_beta: float = 1.0 / 9.0,
    reg_decoded_bbox: bool = False,
    pos_weight: float = -1.0,
    valid_mask=None,
    # train_cfg.sampler (num 0: PseudoSampler, every anchor kept); mmdet
    # samples only under a sampling loss (apis.common.anchor_head_spec)
    sampler_num: int = 0,
    sampler_pos_fraction: float = 0.5,
    sampler_neg_pos_ub: float = -1.0,
    sampler_type: str = "RandomSampler",
    sampler_extra: tuple = (),
    rng=None,  # the samplers' uniforms: a torch.Generator or a draw source (core.sampler_cores)
) -> Dict[str, torch.Tensor]:
    """AnchorHead's losses (loss_cls, loss_bbox) and the number of positives.

    With a focal loss the normaliser is the positive count; with sigmoid
    CE (a sampling loss) positives plus negatives, each as
    ``sum_i max(count_i, 1)``.  With ``sampler_num > 0`` the positives,
    negatives and every count are the sampled sets' (unsampled anchors keep
    their targets at weight 0); ScoreHLR's weights become the negatives'
    label weights."""
    b, n, c = cls_flat.shape
    with torch.no_grad():
        assigned, max_overlaps = max_iou_assign(
            anchors, gt_boxes, gt_valid, pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
            min_pos_iou=min_pos_iou, gt_max_assign_all=gt_max_assign_all,
            match_low_quality=match_low_quality,
        )
        labels, target_boxes, pos = assigned_to_dense_targets(assigned, gt_boxes, gt_labels, num_classes)
    neg = assigned == 0
    if valid_mask is not None:
        pos = pos & valid_mask[None]
        neg = neg & valid_mask[None]
    sampling = cls_loss not in NON_SAMPLING_LOSSES
    neg_weights = None
    if sampler_num > 0:
        if not sampling:
            raise AssertionError("samplers are only active for sampling losses (mmdet anchor_head.py:62-70 "
                                 "ignores train_cfg.sampler under FocalLoss)")
        if rng is None:
            raise AssertionError("samplers need the step's random source (rng)")
        draws = as_draws(rng)
        with torch.no_grad():
            if sampler_type == "RandomSampler":
                pos, neg = random_sample_masks(draws, pos, neg, num=sampler_num, pos_fraction=sampler_pos_fraction,
                                               neg_pos_ub=sampler_neg_pos_ub)
            else:
                pos, neg, neg_weights = sample_with(
                    sampler_type, draws, pos, neg, num=sampler_num, pos_fraction=sampler_pos_fraction,
                    neg_pos_ub=sampler_neg_pos_ub, max_overlaps=max_overlaps, assigned=assigned,
                    max_gt=gt_boxes.shape[1], extra=sampler_extra,
                    **_sampler_signals(sampler_type, sampler_extra, cls_flat, reg_flat, labels, anchors, decode_fn))
    pw = 1.0 if pos_weight <= 0 else float(pos_weight)
    zero = torch.zeros((), device=cls_flat.device)
    nw = torch.ones((), device=cls_flat.device) if neg_weights is None else neg_weights
    label_weights = torch.where(pos, torch.full((), pw, device=cls_flat.device), torch.where(neg, nw, zero))
    num_pos_img = pos.sum(dim=1)
    num_total_samples = num_pos_img.clamp(min=1).sum().float()
    if sampling:
        num_total_samples = num_total_samples + neg.sum(dim=1).clamp(min=1).sum().float()
    num_total_samples = num_total_samples.clamp(min=1.0)

    if cls_loss == "FocalLoss":
        loss_cls = sigmoid_focal_loss(
            cls_flat.reshape(-1, c), labels.reshape(-1), label_weights.reshape(-1), num_classes=num_classes,
            gamma=focal_gamma, alpha=focal_alpha, avg_factor=num_total_samples, loss_weight=cls_loss_weight,
        )
    elif cls_loss == "CrossEntropyLoss":  # sigmoid BCE over the C classes; background all zero
        onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].to(cls_flat.dtype)
        loss_cls = bce_with_logits(cls_flat, onehot, weight=label_weights[..., None],
                                   avg_factor=num_total_samples, loss_weight=cls_loss_weight)
    else:
        raise ValueError(f"unsupported AnchorHead loss_cls {cls_loss!r}")

    posf = pos.float()
    if reg_decoded_bbox:  # a box loss on decoded boxes against the GT box
        loss_bbox = BBOX_LOSS_FNS[bbox_loss_type](
            decode_fn(anchors[None], reg_flat), target_boxes, weight=posf, avg_factor=num_total_samples,
            loss_weight=bbox_loss_weight,
        )
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, num_pos=num_pos_img.sum().float())
    with torch.no_grad():
        bbox_targets = torch.where(pos[..., None], encode_fn(anchors[None], target_boxes), zero)
    reg_masked = torch.where(pos[..., None], reg_flat, zero)
    if bbox_loss_type == "SmoothL1Loss":
        loss_bbox = smooth_l1_loss(reg_masked, bbox_targets, beta=smooth_l1_beta, weight=posf[..., None],
                                   avg_factor=num_total_samples, loss_weight=bbox_loss_weight)
    elif bbox_loss_type == "L1Loss":
        loss_bbox = l1_loss(reg_masked, bbox_targets, weight=posf[..., None], avg_factor=num_total_samples,
                            loss_weight=bbox_loss_weight)
    else:
        raise ValueError(f"loss_bbox {bbox_loss_type!r} on encoded deltas is not a reference configuration "
                         "(use reg_decoded_bbox=True for IoU-family losses)")
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, num_pos=num_pos_img.sum().float())
