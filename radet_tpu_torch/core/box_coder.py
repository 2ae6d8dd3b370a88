"""TBLR box decoding (RADet's coder), port of
``radet_tpu/core/box_coder.py::tblr_decode``.

Encoded layout is (top, bottom, left, right) offsets from the anchor center,
normalized by anchor height (t, b) / width (l, r), then divided by
``normalizer`` (RADet uses 1/8).
"""

from __future__ import annotations

import torch


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
