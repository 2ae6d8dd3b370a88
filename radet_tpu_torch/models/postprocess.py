"""Batched, fixed-shape inference post-processing: decode + vote-NMS.

Port of the vote branch of ``radet_tpu/models/postprocess.py::get_bboxes``:
sigmoid -> score-threshold mask -> top-k over (anchor, class) pairs (one
global top-k, or one per level) -> gather anchors/regs -> TBLR decode with
per-image border clamp -> optional min-size filter and rescale -> top
``nms_topk`` by cluster score -> vote-NMS.  The output is a fixed
(B, max_per_img) detection set plus a validity mask.

Rows are selected with ``torch.gather``/indexing; the JAX package's one-hot
matmul selection is a TPU workaround and has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..core.box_coder import tblr_decode
from ..ops.vote_nms import vote_nms

NEG_INF = -1e30

_OTHER_NMS = "ROADMAP.md Queue 1 item 12, other families and postprocess variants"


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, M, 4) xyxy
    scores: torch.Tensor  # (B, M)
    labels: torch.Tensor  # (B, M) int32
    valid: torch.Tensor  # (B, M) bool
    # only on the with_nms=False proposal path: the anchor of each candidate
    anchors: Optional[torch.Tensor] = None


def _decode_clip(g_anchors, g_regs, img_shapes, normalizer):
    """TBLR-decode candidates and clamp them to the per-image resized bounds."""
    hw = img_shapes.float()  # (B, 2) (h, w)
    return tblr_decode(g_anchors, g_regs, normalizer, max_shape=(hw[:, 0:1], hw[:, 1:2]))


def _gather_rows(values, idx):
    """values (B, N, d) or (B, N); idx (B, K) -> (B, K, d) or (B, K)."""
    if values.dim() == 2:
        return torch.gather(values, 1, idx)
    return torch.gather(values, 1, idx[..., None].expand(-1, -1, values.shape[-1]))


def _topk(masked, k):
    # exact top-k, sorted descending; the JAX package's approx_max_k
    # (test_cfg.approx_topk) is a TPU speed option and is not read here
    return torch.topk(masked, k, dim=1, largest=True, sorted=True)


def _resolve_score(kind, cls_scores, iou_scores):
    if isinstance(kind, (list, tuple)):
        return cls_scores * iou_scores
    if kind == "cls":
        return cls_scores
    if kind == "iou":
        return iou_scores
    raise ValueError(f"unexpected score type {kind!r}")


def _level_inputs(cls_map, reg_map, iou_map, n_l):
    b, c = cls_map.shape[0], cls_map.shape[-1]
    return (
        torch.sigmoid(cls_map.reshape(b, n_l, c)),
        torch.sigmoid(iou_map.reshape(b, n_l)),
        reg_map.reshape(b, n_l, 4),
    )


def _pick(scores, ious, regs, anchors, img_shapes, k, score_thr, normalizer):
    """Top-k (anchor, class) pairs of one score map (B, N, C) and decode."""
    b, n, c = scores.shape
    masked = torch.where(scores > score_thr, scores, torch.full((), NEG_INF, device=scores.device))
    top_scores, pair_idx = _topk(masked.reshape(b, n * c), k)
    anchor_idx = pair_idx // c
    labels = (pair_idx % c).to(torch.int32)
    valid = top_scores > NEG_INF
    g_anchors = anchors[anchor_idx]
    boxes = _decode_clip(g_anchors, _gather_rows(regs, anchor_idx), img_shapes, normalizer)
    cls_s = torch.where(valid, top_scores, torch.zeros((), device=scores.device))
    return boxes, cls_s, _gather_rows(ious, anchor_idx), labels, valid, g_anchors


def select_candidates(
    cls_list, reg_list, iou_list, anchors_per_level, img_shapes, *, score_thr, nms_pre,
    normalizer=1.0 / 8.0,
):
    """Per-level threshold + top-``nms_pre`` + decode; levels concatenated.

    Returns (boxes (B,K,4), cls_scores (B,K), iou_scores (B,K),
    labels (B,K) int32, valid (B,K), anchors (B,K,4))."""
    parts = []
    for cls_map, reg_map, iou_map, anchors in zip(cls_list, reg_list, iou_list, anchors_per_level):
        n_l = anchors.shape[0]
        scores, ious, regs = _level_inputs(cls_map, reg_map, iou_map, n_l)
        k = min(nms_pre, n_l * scores.shape[-1])
        parts.append(_pick(scores, ious, regs, anchors, img_shapes, k, score_thr, normalizer))
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def select_candidates_global(
    cls_list, reg_list, iou_list, anchors_per_level, img_shapes, *, score_thr, topk,
    normalizer=1.0 / 8.0,
):
    """One global top-``topk`` over all levels' (anchor, class) pairs, then
    decode only those; same returns as :func:`select_candidates`."""
    per_level = [
        _level_inputs(c, r, i, a.shape[0])
        for c, r, i, a in zip(cls_list, reg_list, iou_list, anchors_per_level)
    ]
    scores, ious, regs = (torch.cat(x, dim=1) for x in zip(*per_level))
    anchors = torch.cat(list(anchors_per_level), dim=0)
    k = min(topk, scores.shape[1] * scores.shape[2])
    return _pick(scores, ious, regs, anchors, img_shapes, k, score_thr, normalizer)


def _candidates(
    cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors, test_cfg,
    normalizer, rescale,
):
    """Candidate selection + min-size filter + rescale."""
    score_thr = float(test_cfg.get("score_thr", 0.05))
    if str(test_cfg.get("candidate_mode", "global")) == "global":
        out = select_candidates_global(
            cls_list, reg_list, iou_list, anchors_per_level, img_shapes,
            score_thr=score_thr, topk=int(test_cfg.get("nms_topk", 1024)),
            normalizer=normalizer,
        )
    else:
        out = select_candidates(
            cls_list, reg_list, iou_list, anchors_per_level, img_shapes,
            score_thr=score_thr, nms_pre=int(test_cfg.get("nms_pre", 1000)),
            normalizer=normalizer,
        )
    boxes, cls_s, iou_s, labels, valid, cand_anchors = out
    # min_bbox_size filter in network-input coordinates, before rescale
    min_bbox_size = float(test_cfg.get("min_bbox_size", 0))
    if min_bbox_size > 0:
        valid = valid & (
            ((boxes[..., 2] - boxes[..., 0]) >= min_bbox_size)
            & ((boxes[..., 3] - boxes[..., 1]) >= min_bbox_size)
        )
    if rescale:
        boxes = boxes / scale_factors[:, None, :]
    return boxes, cls_s, iou_s, labels, valid, cand_anchors


def vote_nms_inputs(
    cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors, *,
    test_cfg: dict, normalizer: float = 1.0 / 8.0, rescale: bool = True,
):
    """The candidates entering vote-NMS and its options.

    Returns ``(args, kwargs)`` for :func:`ops.vote_nms.vote_nms`: args are
    (boxes, cluster scores, vote scores, labels, valid) of the top
    ``nms_topk`` candidates by cluster score, sorted descending with invalid
    slots last."""
    nms_cfg = dict(test_cfg.get("nms", {"type": "vote", "iou_threshold": 0.65}))
    nms_type = nms_cfg.pop("type", "vote")
    if nms_type not in ("vote", "global_vote"):
        raise NotImplementedError(f"nms.type={nms_type!r} is not ported ({_OTHER_NMS})")
    # 'fast' (XLA) and 'pallas' (TPU kernel) compute the same vote-NMS: here
    # that is the CUDA kernel on the card and the plain version on the CPU
    nms_impl = str(test_cfg.get("nms_impl", "fast"))
    if nms_impl not in ("fast", "pallas"):
        raise NotImplementedError(f"nms_impl={nms_impl!r} is not ported ({_OTHER_NMS})")
    boxes, cls_s, iou_s, labels, valid, _ = _candidates(
        cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors,
        test_cfg, normalizer, rescale,
    )
    cluster = _resolve_score(nms_cfg.pop("cluster_score", "cls"), cls_s, iou_s)
    vote = _resolve_score(nms_cfg.pop("vote_score", "iou"), cls_s, iou_s)
    kk = min(int(test_cfg.get("nms_topk", 1024)), boxes.shape[1])
    masked = torch.where(valid, cluster, torch.full((), NEG_INF, device=cluster.device))
    _, top_idx = _topk(masked, kk)
    args = (
        _gather_rows(boxes, top_idx).contiguous(),
        _gather_rows(cluster, top_idx).contiguous(),
        _gather_rows(vote, top_idx).contiguous(),
        _gather_rows(labels, top_idx).contiguous(),
        _gather_rows(valid, top_idx).contiguous(),
    )
    kwargs = dict(
        iou_threshold=float(nms_cfg.pop("iou_threshold", 0.6)),
        max_out=int(test_cfg.get("max_per_img", 100)),
        iou_enable=bool(nms_cfg.pop("iou_enable", False)),
        sigma=float(nms_cfg.pop("sigma", 0.025)),
        global_mode=nms_type == "global_vote",
    )
    return args, kwargs


def get_bboxes(
    cls_list,
    reg_list,
    iou_list,
    anchors_per_level: Sequence[torch.Tensor],
    img_shapes,  # (B, 2) resized image (h, w) for border clamping
    scale_factors,  # (B, 4) (w_scale, h_scale, w_scale, h_scale)
    *,
    test_cfg: dict,
    normalizer: float = 1.0 / 8.0,
    rescale: bool = True,
    with_nms: bool = True,
) -> Detections:
    """Full batched post-processing of per-level NHWC head outputs into
    fixed-size Detections.  ``anchors_per_level`` are (N_l, 4) float32
    tensors on the outputs' device.

    ``with_nms=False`` returns the decoded candidate set (scores = cls*iou,
    no suppression) with each candidate's anchor."""
    if not with_nms:
        boxes, cls_s, iou_s, labels, valid, anchors = _candidates(
            cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors,
            test_cfg, normalizer, rescale,
        )
        return Detections(boxes, cls_s * iou_s, labels, valid, anchors)
    args, kwargs = vote_nms_inputs(
        cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors,
        test_cfg=test_cfg, normalizer=normalizer, rescale=rescale,
    )
    boxes, labels, scores, valid = vote_nms(*args, **kwargs)
    return Detections(boxes=boxes, scores=scores, labels=labels, valid=valid)
