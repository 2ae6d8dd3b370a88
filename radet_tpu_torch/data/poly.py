"""Polygon masks without cv2 (port of the polygon path of
``radet_tpu/data/pipeline.py::LoadAnnotations``, which calls
``cv2.fillPoly(m, pts, 1)``).

:func:`fill_poly` gives cv2's mask bit for bit, in integer arithmetic as
cv2 (OpenCV 5.0) computes it:

- every part's closed outline is drawn 8-connected, each edge as
  ``cv2.line`` draws it: clipped to the image by ``cv2.clipLine`` (int64
  endpoints moved by truncated double quotients), then Bresenham from its
  left end;
- the interior is filled even-odd over all parts together: each
  non-horizontal edge holds x in 16.16 fixed point from its image-clipped
  endpoints (the clipped y only where the clipped segment is not
  horizontal), steps by a truncated integer slope over its unclipped rows
  [y0, y1), and each row fills from ceil to floor between consecutive
  edge crossings sorted by x.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16  # cv2's fixed-point fraction bits
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> Tuple[bool, int, int, int, int]:
    """``cv2.clipLine`` on a (w, h) image: (some part inside, the moved
    endpoints).  Endpoints move only when the segment is not rejected
    outright, and may stay outside when it misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of ``cv2.line``'s 8-connected pixels from (x1, y1) to
    (x2, y2) inside a (w, h) image.  Bresenham's minor coordinate after k
    major steps is ceil((2 dy k - dx) / (2 dx)), the closed form of cv2's
    error recurrence (err = dx - 2 dy, stepping the minor axis while
    err < 0)."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:  # cv2 walks from the left end
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), 1 if y2 >= y1 else -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    minor = -((dx - 2 * dy * k) // (2 * dx)) if dx else np.zeros(1, np.int64)
    if steep:
        return x1 + minor, y1 + sy * k
    return x1 + k, y1 + sy * minor


def fill_poly(mask: np.ndarray, parts: Sequence[np.ndarray], value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(mask, parts, value)`` on a 2-D uint8 ``mask`` in
    place (and returned): ``parts`` are (N, 2) integer (x, y) vertex
    arrays, N >= 1, filled together even-odd."""
    h, w = mask.shape
    edges = []  # (y0, y1, x at y0 in 16.16, dx per row)
    for pts in parts:
        pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            xs, ys = line_pixels(w, h, x0, y0, x1, y1)
            mask[ys, xs] = value
            if y0 != y1:
                cx0, cy0, cx1, cy1 = x0, y0, x1, y1
                if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
                    _, cx0, ty0, cx1, ty1 = clip_line(w, h, x0, y0, x1, y1)
                    if ty0 != ty1:
                        cy0, cy1 = ty0, ty1
                dx = _tdiv((cx1 - cx0) << XY_SHIFT, cy1 - cy0)
                if y0 < y1:
                    edges.append((y0, y1, (cx0 << XY_SHIFT) + (y0 - cy0) * dx, dx))
                else:
                    edges.append((y1, y0, (cx1 << XY_SHIFT) + (y1 - cy1) * dx, dx))
            x0, y0 = x1, y1
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    rows = np.arange(max(0, int(e[:, 0].min())), min(h, int(e[:, 1].max())), dtype=np.int64)
    if not len(rows):
        return mask
    active = (e[:, :1] <= rows) & (rows < e[:, 1:2])  # (E, rows)
    x = np.where(active, e[:, 2:3] + (rows - e[:, :1]) * e[:, 3:4], np.iinfo(np.int64).max)
    x.sort(axis=0)  # the active crossings of a row come first, an even number of them
    left, right = x[0::2][: x.shape[0] // 2], x[1::2]
    pair = np.arange(left.shape[0])[:, None] < active.sum(0)[None] // 2
    x1 = (left + (XY_ONE - 1)) >> XY_SHIFT
    x2 = right >> XY_SHIFT
    pair &= (x1 < w) & (x2 >= 0)
    x1, x2 = np.maximum(x1, 0), np.minimum(x2, w - 1)
    r = np.broadcast_to(rows - rows[0], pair.shape)
    marks = np.zeros((len(rows), w + 1), np.int32)
    np.add.at(marks, (r[pair], x1[pair]), 1)
    np.add.at(marks, (r[pair], x2[pair] + 1), -1)
    filled = np.cumsum(marks[:, :w], axis=1) > 0
    mask[rows[0]:rows[-1] + 1][filled] = value
    return mask
