"""Batched, fixed-shape inference post-processing: decode + NMS.

Port of ``radet_tpu/models/postprocess.py``.  :func:`get_bboxes` (RADet):
sigmoid -> score-threshold mask -> top-k over (anchor, class) pairs (one
global top-k, or one per level) -> gather anchors/regs -> TBLR decode with
per-image border clamp -> optional min-size filter and rescale -> top
``nms_topk`` by cluster score -> vote-NMS, or with ``nms.type='nms'``
class-aware greedy NMS ranked by cls * iou.  :func:`get_bboxes_anchor`
(ATSSHead, AnchorHead): per level the ``nms_pre`` anchor rows of highest
score -> delta decode with the border clamp -> rescale -> one top
``nms_topk`` over the (box, class) pairs above ``score_thr`` -> class-aware
greedy NMS.  The output is a fixed (B, max_per_img) detection set plus a
validity mask.  :func:`vote_fuse` fuses several such sets of one batch
(test-time augmentation's views) with one vote-NMS call.

Rows are selected with ``torch.gather``/indexing; the JAX package's one-hot
matmul selection is a TPU workaround and has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..core.box_coder import tblr_decode
from ..ops.vote_nms import batched_nms, vote_nms

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


def _topk_stable(x, k):
    """Top-k along dim 1, sorted descending, ties in index order (the order
    of ``jax.lax.top_k``, and the order the NMS kernel keeps in)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


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
    ``nms_topk`` candidates by cluster score (with ``nms_impl='scan'``,
    every candidate, ties in index order), sorted descending with invalid
    slots last."""
    nms_cfg = dict(test_cfg.get("nms", {"type": "vote", "iou_threshold": 0.65}))
    nms_type = nms_cfg.pop("type", "vote")
    if nms_type not in ("vote", "global_vote"):
        raise ValueError(f"vote_nms_inputs takes nms.type 'vote' or 'global_vote', got {nms_type!r}")
    # 'fast' (XLA) and 'pallas' (TPU kernel) compute the same vote-NMS over
    # the top nms_topk candidates, 'scan' (the JAX package's lax.scan of
    # argmax steps) over every candidate: here each is the CUDA kernel on
    # the card and the plain version on the CPU
    nms_impl = str(test_cfg.get("nms_impl", "fast"))
    if nms_impl not in ("fast", "pallas", "scan"):
        raise ValueError(f"nms_impl is 'fast', 'pallas' or 'scan', got {nms_impl!r}")
    boxes, cls_s, iou_s, labels, valid, _ = _candidates(
        cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors,
        test_cfg, normalizer, rescale,
    )
    cluster = _resolve_score(nms_cfg.pop("cluster_score", "cls"), cls_s, iou_s)
    vote = _resolve_score(nms_cfg.pop("vote_score", "iou"), cls_s, iou_s)
    masked = torch.where(valid, cluster, torch.full((), NEG_INF, device=cluster.device))
    if nms_impl == "scan":
        # every candidate, ties in index order: the scan's argmax takes the
        # lowest index among equal scores
        _, top_idx = _topk_stable(masked, boxes.shape[1])
    else:
        _, top_idx = _topk(masked, min(int(test_cfg.get("nms_topk", 1024)), boxes.shape[1]))
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
    nms_cfg = dict(test_cfg.get("nms", {"type": "vote", "iou_threshold": 0.65}))
    nms_type = nms_cfg.get("type", "vote")
    if with_nms and nms_type in ("vote", "global_vote"):
        args, kwargs = vote_nms_inputs(
            cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors,
            test_cfg=test_cfg, normalizer=normalizer, rescale=rescale,
        )
        boxes, labels, scores, valid = vote_nms(*args, **kwargs)
        return Detections(boxes=boxes, scores=scores, labels=labels, valid=valid)
    if with_nms and nms_type != "nms":
        raise NotImplementedError(f"nms.type={nms_type!r} is not ported ({_OTHER_NMS})")
    boxes, cls_s, iou_s, labels, valid, anchors = _candidates(
        cls_list, reg_list, iou_list, anchors_per_level, img_shapes, scale_factors,
        test_cfg, normalizer, rescale,
    )
    if not with_nms:
        return Detections(boxes, cls_s * iou_s, labels, valid, anchors)
    return _greedy_nms(boxes, cls_s * iou_s, labels, valid, float(nms_cfg.get("iou_threshold", 0.6)),
                       int(test_cfg.get("max_per_img", 100)))


def vote_fuse(dets: Sequence[Detections], test_cfg: dict) -> Detections:
    """One vote-NMS call over the union of several (B, M_v) detection sets
    of the same images: the test-time augmentation's fusion (the JAX
    package's ``apis/test.py::_host_vote_fuse`` over each image's
    concatenated views).  Each image's valid detections, view by view, are
    sorted stably by score, descending (so that on ties an earlier view's
    come first), with the invalid slots last; the score is both the
    cluster and the vote score.  Returns (B, ``max_per_img``) Detections.

    The fusion's settings are the JAX package's whatever ``test_cfg.nms``
    says besides its threshold: ``nms.iou_threshold`` (default 0.6), no IoU
    reweighting, sigma 0.025, not global.  On CPU tensors the plain version
    votes in float64, as the JAX package's host fusion does; the kernel on
    the card votes in float32."""
    boxes, scores, labels, valid = (torch.cat([getattr(d, f) for d in dets], dim=1)
                                    for f in ("boxes", "scores", "labels", "valid"))
    if boxes.device.type == "cpu":
        boxes, scores = boxes.double(), scores.double()
    ranked = torch.where(valid, scores, torch.full((), NEG_INF, device=scores.device))
    _, order = _topk_stable(ranked, ranked.shape[1])
    boxes, scores, labels, valid = (_gather_rows(t, order).contiguous()
                                    for t in (boxes, scores, labels.to(torch.int32), valid))
    out = vote_nms(boxes, scores, scores, labels, valid,
                   iou_threshold=float(dict(test_cfg.get("nms", {})).get("iou_threshold", 0.6)),
                   max_out=int(test_cfg.get("max_per_img", 100)), iou_enable=False, sigma=0.025,
                   global_mode=False)
    return Detections(boxes=out[0].float(), scores=out[2].float(), labels=out[1], valid=out[3])


def _greedy_nms(boxes, scores, labels, valid, iou_threshold: float, max_out: int) -> Detections:
    """Class-aware greedy NMS of (B, K) candidates in any order: sorted by
    score (ties in index order, as the JAX package's argmax picks; invalid
    last), then ``ops.vote_nms.batched_nms``."""
    ranked = torch.where(valid, scores, torch.full((), NEG_INF, device=scores.device))
    _, order = _topk_stable(ranked, ranked.shape[1])
    boxes, labels, scores, valid = batched_nms(
        *(_gather_rows(t, order).contiguous() for t in (boxes, scores, labels, valid)),
        iou_threshold=iou_threshold, max_out=max_out,
    )
    return Detections(boxes=boxes, scores=scores, labels=labels, valid=valid)


def get_bboxes_anchor(
    cls_list,
    reg_list,
    factor_list,  # per-level (B, H, W, A) centerness maps, or None
    anchors_per_level: Sequence[torch.Tensor],  # (N_l, 4), N_l counting the A anchors of a cell
    img_shapes,  # (B, 2) resized (h, w)
    scale_factors,  # (B, 4)
    decode_fn,  # (anchors, deltas, max_shape=...) -> boxes (core.box_coder.build_bbox_coder)
    *,
    test_cfg: dict,
    rescale: bool = True,
) -> Detections:
    """Fixed-size Detections of the generic anchor heads' per-level NHWC
    outputs (cls (B, H, W, A * C), reg (B, H, W, A * 4) and, for ATSS,
    centerness (B, H, W, A), whose sigmoid multiplies the scores)."""
    nms_cfg = dict(test_cfg.get("nms", {"type": "nms", "iou_threshold": 0.6}))
    if nms_cfg.pop("type", "nms") != "nms":
        raise NotImplementedError(f"nms.type={test_cfg['nms']['type']!r} for an anchor head is not ported "
                                  f"({_OTHER_NMS})")
    iou_threshold = float(nms_cfg.pop("iou_threshold", 0.6))
    score_thr = float(test_cfg.get("score_thr", 0.05))
    nms_pre = int(test_cfg.get("nms_pre", 1000))
    max_per_img = int(test_cfg.get("max_per_img", 100))
    nms_topk = int(test_cfg.get("nms_topk", 1024))

    hw = img_shapes.float()
    max_shape = (hw[:, 0:1], hw[:, 1:2])  # broadcast over (B, K) coordinates
    all_boxes, all_scores = [], []
    for lvl, (cls_map, reg_map) in enumerate(zip(cls_list, reg_list)):
        b = cls_map.shape[0]
        anchors = anchors_per_level[lvl]
        n_l = anchors.shape[0]
        scores = torch.sigmoid(cls_map.reshape(b, n_l, -1))
        if factor_list is not None:
            scores = scores * torch.sigmoid(factor_list[lvl].reshape(b, n_l))[..., None]
        regs = reg_map.reshape(b, n_l, 4)
        if n_l > nms_pre:
            _, top_idx = _topk_stable(scores.max(dim=-1).values, nms_pre)
            g_anchors, regs, scores = anchors[top_idx], _gather_rows(regs, top_idx), _gather_rows(scores, top_idx)
        else:
            g_anchors = anchors.expand(b, n_l, 4)
        all_boxes.append(decode_fn(g_anchors, regs, max_shape=max_shape))
        all_scores.append(scores)
    boxes = torch.cat(all_boxes, dim=1)  # (B, K, 4)
    scores = torch.cat(all_scores, dim=1)  # (B, K, C)
    if rescale:
        boxes = boxes / scale_factors[:, None, :]

    b, k, c = scores.shape
    masked = torch.where(scores > score_thr, scores, torch.full((), NEG_INF, device=scores.device))
    top_scores, pair_idx = _topk_stable(masked.reshape(b, k * c), min(nms_topk, k * c))
    valid = top_scores > NEG_INF
    return _greedy_nms(_gather_rows(boxes, pair_idx // c), torch.where(valid, top_scores, 0.0),
                       (pair_idx % c).to(torch.int32), valid, iou_threshold, max_per_img)
