"""Box coders, port of ``radet_tpu/core/box_coder.py``: TBLR decoding
(RADet's coder) and DeltaXYWH encoding and decoding (the generic anchor
heads' coder).

TBLR's encoded layout is (top, bottom, left, right) offsets from the anchor
center, normalized by anchor height (t, b) / width (l, r), then divided by
``normalizer`` (RADet uses 1/8).  DeltaXYWH is the R-CNN (dx, dy, dw, dh)
with means/stds normalization and ``wh_ratio_clip`` on decode.  All are
functions of (..., 4) tensors that broadcast over leading batch dims.
"""

from __future__ import annotations

import math

import torch

_OTHER_CODERS = "ROADMAP.md Queue 1 item 12, other families"


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


def _box_cxcywh(boxes):
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return cx, cy, boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]


def delta_encode(proposals, gt, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)):
    """(..., 4) xyxy proposals and targets -> (..., 4) normalized (dx, dy, dw, dh).

    ``means`` and ``stds`` are numbers: no host-to-device copy per call."""
    px, py, pw, ph = _box_cxcywh(proposals)
    gx, gy, gw, gh = _box_cxcywh(gt)
    deltas = ((gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph))
    return torch.stack([(d - m) / s for d, m, s in zip(deltas, means, stds)], dim=-1)


def delta_decode(rois, deltas, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0), max_shape=None,
                 wh_ratio_clip: float = 16 / 1000, clip_border: bool = True):
    """Apply (dx, dy, dw, dh) deltas to (..., 4) xyxy base boxes.

    dw and dh are clamped to |log(wh_ratio_clip)|; ``max_shape`` (h, w),
    tensors broadcastable against the coordinates (per-image shapes) or
    numbers, clamps the result into [0, w] x [0, h]."""
    dx, dy, dw, dh = (deltas[..., i] * stds[i] + means[i] for i in range(4))
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph = _box_cxcywh(rois)
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1, y1, x2, y2 = gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5
    if clip_border and max_shape is not None:
        hmax, wmax = max_shape
        x1, x2 = _clip(x1, wmax), _clip(x2, wmax)
        y1, y2 = _clip(y1, hmax), _clip(y2, hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def build_bbox_coder(cfg: dict):
    """A ``DeltaXYWHBBoxCoder`` config -> (encode_fn(anchors, gt),
    decode_fn(anchors, deltas, max_shape=None)) closures."""
    cfg = dict(cfg)
    ctype = cfg.pop("type", "DeltaXYWHBBoxCoder")
    if ctype != "DeltaXYWHBBoxCoder":
        raise NotImplementedError(f"bbox coder {ctype!r} is not ported ({_OTHER_CODERS})")
    means = tuple(cfg.get("target_means", (0.0, 0.0, 0.0, 0.0)))
    stds = tuple(cfg.get("target_stds", (1.0, 1.0, 1.0, 1.0)))
    clip_border = bool(cfg.get("clip_border", True))

    def encode(anchors, gt):
        return delta_encode(anchors, gt, means, stds)

    def decode(anchors, deltas, max_shape=None):
        return delta_decode(anchors, deltas, means, stds, max_shape, clip_border=clip_border)

    return encode, decode
