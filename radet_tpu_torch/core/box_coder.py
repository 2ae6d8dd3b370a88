"""Box coders, port of ``radet_tpu/core/box_coder.py``: mmdet's coder zoo.

- TBLR (RADet's coder): (top, bottom, left, right) offsets from the anchor
  center, normalized by anchor height (t, b) / width (l, r), then divided
  by ``normalizer`` (RADet uses 1/8).
- DeltaXYWH (the generic anchor heads' coder): the R-CNN (dx, dy, dw, dh)
  with means/stds normalization and ``wh_ratio_clip`` on decode;
  LegacyDeltaXYWH is mmdet v1's, whose widths and heights are x2 - x1 + 1
  and whose decode clamps to max_shape - 1.
- YOLO: stride-relative center offsets and log w/h; Pseudo: the identity;
  Bucketing: per-side bucket classification and offsets (decode takes a
  (cls, offset) pair and also returns a localisation confidence).

All are functions of (..., 4) tensors that broadcast over leading batch
dims (Bucketing's of (n, 4)).  A decode's ``max_shape`` (h, w) is a pair of
numbers or of tensors broadcastable against the coordinates, e.g. (B, 1)
per-image shapes against (B, K) boxes.
"""

from __future__ import annotations

import math

import torch


def tblr_encode(anchors, gt_boxes, normalizer: float = 1.0 / 8.0):
    """Encode gt xyxy boxes against anchor xyxy boxes. Shapes (..., 4)."""
    cx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    cy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    top = (cy - gt_boxes[..., 1]) / h
    bottom = (gt_boxes[..., 3] - cy) / h
    left = (cx - gt_boxes[..., 0]) / w
    right = (gt_boxes[..., 2] - cx) / w
    return torch.stack([top, bottom, left, right], dim=-1) / normalizer


def tblr_decode(anchors, tblr, normalizer: float = 1.0 / 8.0, max_shape=None):
    """Decode (t, b, l, r) predictions back to xyxy boxes.

    Args:
        anchors: (..., 4) xyxy anchors.
        tblr: (..., 4) encoded offsets.
        max_shape: optional (h, w) for border clamping: tensors broadcastable
            against the box coordinates (per-image shapes) or python numbers.
    """
    loc = tblr * normalizer
    cx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    cy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    x1 = cx - loc[..., 2] * w
    y1 = cy - loc[..., 0] * h
    x2 = cx + loc[..., 3] * w
    y2 = cy + loc[..., 1] * h
    if max_shape is not None:
        hmax, wmax = max_shape
        x1 = _clip(x1, wmax)
        x2 = _clip(x2, wmax)
        y1 = _clip(y1, hmax)
        y2 = _clip(y2, hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _clip(x, hi):
    """``jnp.clip(x, 0, hi)`` = min(max(x, 0), hi) for a tensor or number ``hi``."""
    x = torch.clamp(x, min=0)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else torch.clamp(x, max=hi)


def _box_cxcywh(boxes, plus_one: float = 0.0):
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    if plus_one:
        w, h = w + plus_one, h + plus_one
    return cx, cy, w, h


def delta_encode(proposals, gt, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0), *, plus_one: float = 0.0):
    """(..., 4) xyxy proposals and targets -> (..., 4) normalized (dx, dy, dw, dh).

    ``means`` and ``stds`` are numbers: no host-to-device copy per call.
    ``plus_one=1.0`` is mmdet v1's legacy variant (w = x2 - x1 + 1)."""
    px, py, pw, ph = _box_cxcywh(proposals, plus_one)
    gx, gy, gw, gh = _box_cxcywh(gt, plus_one)
    deltas = ((gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph))
    return torch.stack([(d - m) / s for d, m, s in zip(deltas, means, stds)], dim=-1)


def delta_decode(rois, deltas, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0), max_shape=None,
                 wh_ratio_clip: float = 16 / 1000, clip_border: bool = True, *, plus_one: float = 0.0):
    """Apply (dx, dy, dw, dh) deltas to (..., 4) xyxy base boxes.

    dw and dh are clamped to |log(wh_ratio_clip)|; ``max_shape`` (h, w),
    tensors broadcastable against the coordinates (per-image shapes) or
    numbers, clamps the result into [0, w] x [0, h] (legacy, ``plus_one=1``:
    [0, w - 1] x [0, h - 1])."""
    dx, dy, dw, dh = (deltas[..., i] * stds[i] + means[i] for i in range(4))
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph = _box_cxcywh(rois, plus_one)
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1, y1, x2, y2 = gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5
    if clip_border and max_shape is not None:
        hmax, wmax = max_shape
        if plus_one:
            hmax, wmax = hmax - plus_one, wmax - plus_one
        x1, x2 = _clip(x1, wmax), _clip(x2, wmax)
        y1, y2 = _clip(y1, hmax), _clip(y2, hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def legacy_delta_encode(proposals, gt, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)):
    """mmdet v1's delta encoding (w = x2 - x1 + 1)."""
    return delta_encode(proposals, gt, means, stds, plus_one=1.0)


def legacy_delta_decode(rois, deltas, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0), max_shape=None,
                        wh_ratio_clip: float = 16 / 1000):
    """mmdet v1's delta decoding (w = x2 - x1 + 1, clamped to max_shape - 1)."""
    return delta_decode(rois, deltas, means, stds, max_shape, wh_ratio_clip, plus_one=1.0)


def yolo_encode(bboxes, gt_bboxes, stride, eps: float = 1e-6):
    """YOLO encode: stride-relative center offsets in (eps, 1 - eps) and log
    w/h ratios (at least log eps)."""
    gx, gy, gw, gh = _box_cxcywh(gt_bboxes)
    px, py, pw, ph = _box_cxcywh(bboxes)
    w_t = torch.log(torch.clamp(gw / pw, min=eps))
    h_t = torch.log(torch.clamp(gh / ph, min=eps))
    x_t = torch.clamp((gx - px) / stride + 0.5, eps, 1 - eps)
    y_t = torch.clamp((gy - py) / stride + 0.5, eps, 1 - eps)
    return torch.stack([x_t, y_t, w_t, h_t], dim=-1)


def yolo_decode(bboxes, pred_bboxes, stride):
    """YOLO decode (the inverse of :func:`yolo_encode`, unclamped)."""
    px, py, pw, ph = _box_cxcywh(bboxes)
    gx = (pred_bboxes[..., 0] - 0.5) * stride + px
    gy = (pred_bboxes[..., 1] - 0.5) * stride + py
    gw = torch.exp(pred_bboxes[..., 2]) * pw
    gh = torch.exp(pred_bboxes[..., 3]) * ph
    return torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)


def pseudo_encode(bboxes, gt_bboxes):
    """PseudoBBoxCoder: the targets are the GT boxes."""
    return gt_bboxes


def pseudo_decode(bboxes, pred_bboxes):
    return pred_bboxes


def bbox_rescale(bboxes, scale_factor: float):
    """Scale boxes about their centers."""
    c = (bboxes[..., :2] + bboxes[..., 2:]) * 0.5
    half = (bboxes[..., 2:] - bboxes[..., :2]) * 0.5 * scale_factor
    return torch.cat([c - half, c + half], dim=-1)


def _buckets(proposals, num_buckets: int, scale_factor: float):
    """Per-side bucket widths and centers of the rescaled proposals:
    (bucket w, bucket h, left, right, top, down), each side's (n, side)."""
    p = bbox_rescale(proposals, scale_factor)
    side = int(math.ceil(num_buckets / 2.0))
    bw = (p[..., 2] - p[..., 0]) / num_buckets
    bh = (p[..., 3] - p[..., 1]) / num_buckets
    off = 0.5 + torch.arange(side, dtype=p.dtype, device=p.device)
    l_b = p[..., 0, None] + off * bw[..., None]
    r_b = p[..., 2, None] - off * bw[..., None]
    t_b = p[..., 1, None] + off * bh[..., None]
    d_b = p[..., 3, None] - off * bh[..., None]
    return bw, bh, l_b, r_b, t_b, d_b


def bucketing_encode(proposals, gt, num_buckets: int, scale_factor: float, offset_topk: int = 2,
                     offset_upperbound: float = 1.0, cls_ignore_neighbor: bool = True):
    """BucketingBBoxCoder.encode (mmdet's bbox2bucket) of (n, 4) proposals
    and targets: per side, each bucket center's offset to the GT edge in
    bucket units, weight 1 on the ``offset_topk`` nearest buckets (beyond
    the nearest only where |offset| < ``offset_upperbound``), the nearest
    bucket's one-hot label, and classification weights that ignore the
    other buckets within one unit with ``cls_ignore_neighbor``.  Ranks by
    |offset| break ties to the lower index.  Returns (offsets, offset
    weights, bucket labels, cls weights), each (n, 4 * side) in [l, r, t,
    d] order."""
    bw, bh, l_b, r_b, t_b, d_b = _buckets(proposals, num_buckets, scale_factor)
    offs = [(l_b - gt[..., 0, None]) / bw[..., None], (r_b - gt[..., 2, None]) / bw[..., None],
            (t_b - gt[..., 1, None]) / bh[..., None], (d_b - gt[..., 3, None]) / bh[..., None]]
    w_parts, lab_parts, clsw_parts = [], [], []
    for o in offs:
        a = o.abs()
        order = torch.argsort(a, dim=-1, stable=True)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(o.shape[-1], device=o.device).expand_as(order))
        gated = (rank == 0) | (a < offset_upperbound)
        w_parts.append(((rank < offset_topk) & gated).to(o.dtype))
        lab_parts.append((rank == 0).to(o.dtype))
        if cls_ignore_neighbor:
            clsw_parts.append((~((a < 1.0) & (rank != 0))).to(o.dtype))
        else:
            clsw_parts.append(torch.ones_like(o))
    return (torch.cat(offs, dim=-1), torch.cat(w_parts, dim=-1), torch.cat(lab_parts, dim=-1),
            torch.cat(clsw_parts, dim=-1))


def bucketing_decode(proposals, cls_preds, offset_preds, num_buckets: int, scale_factor: float = 1.0,
                     max_shape=None, clip_border: bool = True):
    """BucketingBBoxCoder.decode (mmdet's bucket2bbox) of (n, 4) proposals
    and (n, 4 * side) bucket logits and offsets: each side's softmax-argmax
    bucket, refined by its offset; the localisation confidence averages each
    side's top-1 probability, plus its top-2 where the two buckets are
    adjacent.  Clamped to [0, w - 1] x [0, h - 1].  Returns (boxes (n, 4),
    loc_confidence (n,))."""
    side = int(math.ceil(num_buckets / 2.0))
    n = proposals.shape[0]
    scores = torch.softmax(cls_preds.reshape(n, 4, side), dim=-1)
    top2, lab2 = torch.topk(scores, 2, dim=-1)  # (n, 4, 2)
    best = lab2[..., 0]

    bw, bh = _buckets(proposals, num_buckets, scale_factor)[:2]
    p = bbox_rescale(proposals, scale_factor)
    units = torch.stack([bw, bw, bh, bh], dim=-1)
    starts = torch.stack([p[:, 0], p[:, 2], p[:, 1], p[:, 3]], dim=-1)
    signs = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=proposals.dtype, device=proposals.device)
    buckets = starts + signs * (0.5 + best.to(proposals.dtype)) * units
    picked = offset_preds.reshape(n, 4, side).gather(-1, best[..., None])[..., 0]
    edges = buckets - picked * units  # x1, x2, y1, y2
    x1, x2, y1, y2 = edges.unbind(-1)
    if clip_border and max_shape is not None:
        hmax, wmax = max_shape
        x1, x2 = _clip(x1, wmax - 1), _clip(x2, wmax - 1)
        y1, y2 = _clip(y1, hmax - 1), _clip(y2, hmax - 1)
    loc_conf = top2[..., 0] + top2[..., 1] * ((lab2[..., 0] - lab2[..., 1]).abs() == 1).to(top2.dtype)
    return torch.stack([x1, y1, x2, y2], dim=-1), loc_conf.mean(dim=-1)


def _bucketing_pair_decode(nb, sf, clip):
    def decode(anchors, preds, max_shape=None):
        if not isinstance(preds, (tuple, list)):
            raise TypeError("BucketingBBoxCoder.decode wants (cls, offset) preds")
        return bucketing_decode(anchors, preds[0], preds[1], nb, sf, max_shape, clip)
    return decode


def build_bbox_coder(cfg: dict):
    """A bbox_coder config -> (encode_fn, decode_fn) closures over its
    parameters, with the JAX package's signatures: ``(anchors, gt)`` and
    ``(anchors, deltas, max_shape=None)``; YOLO's take a ``stride`` instead
    of ``max_shape``, Bucketing's decode a (cls, offset) pair and returns
    (boxes, loc_confidence).  Another type raises KeyError."""
    cfg = dict(cfg)
    ctype = cfg.pop("type", "DeltaXYWHBBoxCoder")
    if ctype == "TBLRBBoxCoder":
        normalizer = float(cfg.get("normalizer", 1.0 / 8.0))
        return (lambda a, g: tblr_encode(a, g, normalizer=normalizer),
                lambda a, d, max_shape=None: tblr_decode(a, d, normalizer=normalizer, max_shape=max_shape))
    if ctype in ("DeltaXYWHBBoxCoder", "LegacyDeltaXYWHBBoxCoder"):
        means = tuple(cfg.get("target_means", (0.0, 0.0, 0.0, 0.0)))
        stds = tuple(cfg.get("target_stds", (1.0, 1.0, 1.0, 1.0)))
        clip_border = bool(cfg.get("clip_border", True))
        plus_one = 1.0 if ctype.startswith("Legacy") else 0.0

        def encode(anchors, gt):
            return delta_encode(anchors, gt, means, stds, plus_one=plus_one)

        def decode(anchors, deltas, max_shape=None):
            return delta_decode(anchors, deltas, means, stds, max_shape, clip_border=clip_border, plus_one=plus_one)

        return encode, decode
    if ctype == "YOLOBBoxCoder":
        eps = float(cfg.get("eps", 1e-6))
        return (lambda a, g, stride: yolo_encode(a, g, stride, eps=eps),
                lambda a, d, stride: yolo_decode(a, d, stride))
    if ctype == "PseudoBBoxCoder":
        return pseudo_encode, pseudo_decode
    if ctype == "BucketingBBoxCoder":
        nb, sf = int(cfg["num_buckets"]), float(cfg["scale_factor"])
        topk, ub = int(cfg.get("offset_topk", 2)), float(cfg.get("offset_upperbound", 1.0))
        ign, clip = bool(cfg.get("cls_ignore_neighbor", True)), bool(cfg.get("clip_border", True))
        return (lambda a, g: bucketing_encode(a, g, nb, sf, topk, ub, ign), _bucketing_pair_decode(nb, sf, clip))
    raise KeyError(f"unsupported bbox_coder type {ctype!r} (implemented: TBLR, DeltaXYWH, LegacyDeltaXYWH, YOLO, "
                   "Pseudo, Bucketing)")
