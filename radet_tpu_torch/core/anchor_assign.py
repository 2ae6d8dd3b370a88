"""IoU-based anchor assigners, MaxIoU and ATSS, batched over the images
(port of ``radet_tpu/core/anchor_assign.py``).

They run inside the train step on the step's device, on a static (N,)
anchor set and a padded (B, G) GT set, under ``no_grad``.  Output
convention (mmdet's ``AssignResult.gt_inds``), per image and anchor:
    -1  ignore (MaxIoU anchors that are neither positive nor negative)
     0  negative (background)
    g+1 positive, 1-based GT index
The PseudoSampler is the identity on this encoding (positive = gt_inds > 0,
negative = gt_inds == 0).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .box_ops import bbox_iou_pairwise

INF = 1e8


def max_iou_assign(
    bboxes,  # (N, 4) xyxy anchors
    gt_boxes,  # (B, G, 4) xyxy, padded
    gt_valid,  # (B, G) bool
    *,
    pos_iou_thr: float,
    neg_iou_thr,
    min_pos_iou: float = 0.0,
    gt_max_assign_all: bool = True,
    match_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mmdet's MaxIoUAssigner.  Returns (assigned (B, N) int64, max
    overlaps (B, N))."""
    overlaps = bbox_iou_pairwise(gt_boxes, bboxes[None])  # (B, G, N)
    overlaps = torch.where(gt_valid[..., None], overlaps, torch.full((), -1.0, device=overlaps.device))
    return assign_wrt_overlaps(
        overlaps, gt_valid, pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou,
        gt_max_assign_all=gt_max_assign_all, match_low_quality=match_low_quality,
    )


def assign_wrt_overlaps(
    overlaps,  # (B, G, N) IoU, rows of invalid GTs at -1
    gt_valid,  # (B, G) bool
    *,
    pos_iou_thr: float,
    neg_iou_thr,
    min_pos_iou: float = 0.0,
    gt_max_assign_all: bool = True,
    match_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The overlaps -> assignment core of MaxIoUAssigner; each step
    overwrites the previous ones:

    1. every anchor -1;
    2. max overlap in the negative window -> 0;
    3. max overlap >= ``pos_iou_thr`` -> its GT (the first on ties);
    4. low-quality matches: each valid GT whose best IoU is at least
       ``min_pos_iou`` claims its best anchors (all ties, or the first with
       ``gt_max_assign_all=False``); a later GT overwrites an earlier one.
    Images without a valid GT are all background."""
    g = overlaps.shape[1]
    dev = overlaps.device
    max_overlaps = overlaps.amax(dim=1)  # (B, N)
    argmax_overlaps = overlaps.argmax(dim=1)  # the first maximum
    assigned = torch.full_like(argmax_overlaps, -1)
    if isinstance(neg_iou_thr, (tuple, list)):
        lo, hi = neg_iou_thr
        neg = (max_overlaps >= lo) & (max_overlaps < hi)
    else:
        neg = (max_overlaps >= 0) & (max_overlaps < float(neg_iou_thr))
    assigned = torch.where(neg, torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1, assigned)
    if match_low_quality:
        gt_max = overlaps.amax(dim=2)  # (B, G)
        eligible = (gt_max >= min_pos_iou) & gt_valid
        if gt_max_assign_all:
            claim = overlaps == gt_max[..., None]
        else:
            n = overlaps.shape[2]
            claim = torch.arange(n, device=dev) == overlaps.argmax(dim=2)[..., None]
        claim = claim & eligible[..., None]
        gt_rank = torch.arange(1, g + 1, device=dev)[None, :, None]
        claim_idx = torch.where(claim, gt_rank, torch.zeros((), dtype=gt_rank.dtype, device=dev)).amax(dim=1)
        assigned = torch.where(claim_idx > 0, claim_idx, assigned)
    assigned = torch.where(gt_valid.any(dim=1, keepdim=True), assigned, torch.zeros_like(assigned))
    return assigned, max_overlaps.clamp(min=0.0)


def atss_assign(
    bboxes,  # (N, 4) xyxy anchors, all levels concatenated
    num_level_bboxes: Sequence[int],
    gt_boxes,  # (B, G, 4) padded
    gt_valid,  # (B, G) bool
    *,
    topk: int,
    inside_mask=None,  # optional (N,) bool: anchors eligible as candidates
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mmdet's ATSSAssigner.

    1. IoU of every anchor and GT, and the distances of their centers;
    2. per level, the ``min(topk, n_level)`` anchors closest to each GT
       center are its candidates (the lower index first on equal distances);
    3. per GT, threshold = mean + std (Bessel) of its candidates' IoUs;
       candidates at or above it whose center lies inside the GT by more
       than 0.01 are eligible;
    4. each anchor takes its eligible GT of highest IoU (the first on
       ties), else background.

    ``inside_mask`` pushes excluded anchors to an infinite distance, so
    they are never candidates.  Returns (assigned (B, N) int64: 0 negative,
    g+1 positive; max overlaps (B, N))."""
    n = bboxes.shape[0]
    b, g = gt_valid.shape
    dev = bboxes.device
    if sum(num_level_bboxes) != n:
        raise ValueError(f"level counts {list(num_level_bboxes)} do not add up to {n} anchors")
    overlaps = bbox_iou_pairwise(bboxes[None], gt_boxes)  # (B, N, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, torch.zeros((), device=dev))
    gt_cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5  # (B, G)
    gt_cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    acx = (bboxes[:, 0] + bboxes[:, 2]) * 0.5  # (N,)
    acy = (bboxes[:, 1] + bboxes[:, 3]) * 0.5
    distances = torch.sqrt((acx[None, :, None] - gt_cx[:, None, :]) ** 2
                           + (acy[None, :, None] - gt_cy[:, None, :]) ** 2)  # (B, N, G)
    if inside_mask is not None:
        distances = torch.where(inside_mask[None, :, None], distances, torch.full((), INF, device=dev))

    parts, start = [], 0
    for n_l in num_level_bboxes:
        d_l = distances[:, start:start + n_l]  # (B, n_l, G)
        idx = torch.sort(d_l, dim=1, stable=True).indices[:, :min(topk, n_l)]
        parts.append(idx + start)
        start += n_l
    cand_idx = torch.cat(parts, dim=1)  # (B, C, G)

    cand_overlaps = overlaps.gather(1, cand_idx)  # (B, C, G)
    mean = cand_overlaps.mean(dim=1)
    std = torch.sqrt(((cand_overlaps - mean[:, None]) ** 2).sum(dim=1) / (cand_overlaps.shape[1] - 1))
    is_pos = cand_overlaps >= (mean + std)[:, None]

    ccx, ccy = acx[cand_idx], acy[cand_idx]  # candidate centers (B, C, G)
    l_ = ccx - gt_boxes[:, None, :, 0]
    t_ = ccy - gt_boxes[:, None, :, 1]
    r_ = gt_boxes[:, None, :, 2] - ccx
    b_ = gt_boxes[:, None, :, 3] - ccy
    in_gt = torch.minimum(torch.minimum(l_, r_), torch.minimum(t_, b_)) > 0.01
    is_pos = is_pos & in_gt & gt_valid[:, None, :]
    if inside_mask is not None:
        is_pos = is_pos & inside_mask[cand_idx]

    # candidate eligibility back on the dense (B, N, G) grid
    eligible = torch.zeros((b, n, g), dtype=torch.bool, device=dev).scatter_(1, cand_idx, is_pos)
    overlaps_inf = torch.where(eligible, overlaps, torch.full((), -INF, device=dev))
    best = overlaps_inf.amax(dim=2)
    best_gt = overlaps_inf.argmax(dim=2)
    pos = best > -INF * 0.5
    return torch.where(pos, best_gt + 1, torch.zeros_like(best_gt)), torch.where(pos, best, torch.zeros_like(best))


def assigned_to_dense_targets(
    assigned,  # (B, N): -1 ignore, 0 negative, g+1 positive
    gt_boxes,  # (B, G, 4)
    gt_labels,  # (B, G)
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-anchor (labels (B, N) with ``num_classes`` for background,
    target boxes (B, N, 4), positive mask (B, N)); an anchor that is not
    positive gets its image's first GT box as target."""
    pos = assigned > 0
    idx0 = (assigned - 1).clamp(min=0)
    target_boxes = gt_boxes.gather(1, idx0[..., None].expand(-1, -1, 4))
    labels = torch.where(pos, gt_labels.long().gather(1, idx0), torch.full((), num_classes, device=pos.device))
    return labels, target_boxes, pos
