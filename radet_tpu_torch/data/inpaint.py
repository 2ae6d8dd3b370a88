"""Telea inpainting without cv2 (InstaBoost's hole filling).

The JAX package's ``InstaBoost`` restores the background under the
instances it moves with ``cv2.inpaint(img, hole, 3, cv2.INPAINT_TELEA)``;
here ``csrc/inpaint.cpp`` repeats OpenCV's fast-marching code step for step
(the file's header lists its parts), so that the result is cv2's byte for
byte.  :func:`inpaint_telea_plain` is its numpy twin, which the tests hold
equal to it and to cv2; the pipeline calls the C++ function.  The library is
built at first use into ``radet_tpu_torch/_build/`` (a failed build raises)
and called through ``ctypes``, which releases the interpreter lock.
"""

from __future__ import annotations

import ctypes
import heapq
import math

import numpy as np

from ..utils.native import CSRC, load_library

SOURCE = CSRC / "inpaint.cpp"
# -ffp-contract=off: every float operation rounded on its own, as OpenCV's build
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
_API = {
    "radet_inpaint_telea": ([ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_double], None),
}

KNOWN, BAND, INSIDE, CHANGE = 0, 1, 2, 3
_F32 = np.float32


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the library."""
    return load_library(SOURCE, CXX_FLAGS, _API)


def _check(img: np.ndarray, mask: np.ndarray):
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or min(img.shape[:2]) < 2:
        # OpenCV's gradient reads an out-of-image row or column of a 1-pixel-wide image
        raise ValueError(f"expected an (H, W, 3) uint8 image of at least 2x2, got {img.dtype} {img.shape}")
    if mask.shape != img.shape[:2]:
        raise ValueError(f"mask of shape {mask.shape} for an image of {img.shape}")
    return np.ascontiguousarray(img), np.ascontiguousarray(mask != 0, np.uint8)


def inpaint_telea(img: np.ndarray, mask: np.ndarray, radius: float = 3) -> np.ndarray:
    """``cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA)`` of an (H, W, 3)
    uint8 image; ``mask`` (H, W), nonzero where the image is to be filled."""
    img, mask = _check(img, mask)
    out = np.empty_like(img)
    build().radet_inpaint_telea(img.ctypes.data, mask.ctypes.data, out.ctypes.data, img.shape[0], img.shape[1],
                                float(radius))
    return out


# -------------------------------------------------------------- numpy twin


def _dilate(m: np.ndarray, r: int, cross: bool) -> np.ndarray:
    """``m`` dilated by a (2 r + 1) square, or by the 3x3 cross."""
    rows, cols = m.shape
    p = np.pad(m, r)
    out = np.zeros_like(m)
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            if not (cross and di and dj):
                out |= p[r + di:r + di + rows, r + dj:r + dj + cols]
    return out


def _zero_border(m: np.ndarray) -> np.ndarray:
    m[0], m[-1], m[:, 0], m[:, -1] = 0, 0, 0, 0
    return m


def _solve(i1, j1, i2, j2, f, t) -> float:
    a11, a22 = float(t[i1, j1]), float(t[i2, j2])
    in1, in2 = f[i1, j1] == INSIDE, f[i2, j2] == INSIDE
    if not in1 and not in2:
        if abs(a11 - a22) >= 1.0:
            sol = 1 + min(a11, a22)
        else:
            sol = (a11 + a22 + math.sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5
    elif not in1:
        sol = 1 + a11
    elif not in2:
        sol = 1 + a22
    else:
        sol = 1 + min(a11, a22)
    return float(_F32(sol))


def _arrival(i, j, f, t) -> float:
    return min(min(_solve(i - 1, j, i, j - 1, f, t), _solve(i + 1, j, i, j - 1, f, t)),
               min(_solve(i - 1, j, i, j + 1, f, t), _solve(i + 1, j, i, j + 1, f, t)))


_STEPS = ((-1, 0), (0, -1), (1, 0), (0, 1))


def _grad_t(i, j, f, t):
    """OpenCV's one-sided or central difference of T at (i, j), float32."""
    def diff(fwd, bwd, t_fwd, t_bwd):
        if fwd:
            return (t_fwd - t_bwd) * _F32(0.5) if bwd else t_fwd - t[i, j]
        return t[i, j] - t_bwd if bwd else _F32(0)
    gx = diff(f[i, j + 1] != INSIDE, f[i, j - 1] != INSIDE, t[i, j + 1], t[i, j - 1])
    gy = diff(f[i + 1, j] != INSIDE, f[i - 1, j] != INSIDE, t[i + 1, j], t[i - 1, j])
    return _F32(gx), _F32(gy)


def inpaint_telea_plain(img: np.ndarray, mask: np.ndarray, radius: float = 3) -> np.ndarray:
    """numpy twin of :func:`inpaint_telea`: the same two marches on a framed
    grid, the queues as (T, push order) heaps, each filled pixel's window
    sums accumulated in float32 in OpenCV's order (``np.cumsum``)."""
    img, mask = _check(img, mask)
    out = img.copy()
    h, w = mask.shape
    r = min(max(int(np.rint(radius)), 1), 100)
    rows, cols = h + 2, w + 2
    hole = np.zeros((rows, cols), bool)
    hole[1:-1, 1:-1] = mask != 0
    band = _zero_border(_dilate(hole, 1, True) & ~hole)
    f = np.where(band, BAND, np.where(hole, INSIDE, KNOWN)).astype(np.uint8)
    t = np.where(band, _F32(0), _F32(1.0e6)).astype(np.float32)
    seq = 0
    heap, outq = [], []
    for i, j in np.argwhere(band):
        heap.append((0.0, seq, int(i), int(j)))
        outq.append((0.0, seq, int(i), int(j)))
        seq += 1
    # the outward march over the ring within r of the hole; its times negated
    ring = _zero_border(np.where(_dilate(hole, r, False) & ~hole & ~band, INSIDE, KNOWN).astype(np.uint8))
    while outq:
        _, _, ii, jj = heapq.heappop(outq)
        ring[ii, jj] = CHANGE
        for di, dj in _STEPS:
            i, j = ii + di, jj + dj
            if i <= 0 or j <= 0 or i > rows or j > cols or ring[i, j] != INSIDE:
                continue
            dist = _arrival(i, j, ring, t)
            t[i, j] = dist
            ring[i, j] = BAND
            heapq.heappush(outq, (dist, seq, i, j))
            seq += 1
    t[ring == CHANGE] *= -1
    # the window of offsets, row by row as OpenCV walks it
    dk, dl = (a.ravel() for a in np.mgrid[-r:r + 1, -r:r + 1])
    near = dk * dk + dl * dl <= r * r
    while heap:
        _, _, ii, jj = heapq.heappop(heap)
        f[ii, jj] = KNOWN
        for di, dj in _STEPS:
            i, j = ii + di, jj + dj
            if i <= 0 or j <= 0 or i > rows - 1 or j > cols - 1 or f[i, j] != INSIDE:
                continue
            dist = _arrival(i, j, f, t)
            t[i, j] = dist
            gx, gy = _grad_t(i, j, f, t)
            k, l = i + dk, j + dl
            inner = near & (k > 0) & (l > 0) & (k < rows - 1) & (l < cols - 1)
            k, l = k[inner], l[inner]
            take = f[k, l] != INSIDE
            k, l = k[take], l[take]
            ry, rx = (i - k).astype(np.float32), (j - l).astype(np.float32)
            len2 = rx * rx + ry * ry
            dst = (1.0 / (len2 * np.sqrt(len2.astype(np.float64)))).astype(np.float32)
            lev = (1.0 / (1 + np.abs((t[k, l] - t[i, j]).astype(np.float64)))).astype(np.float32)
            direc = rx * gx + ry * gy
            direc = np.where(np.abs(direc).astype(np.float64) <= 0.01, _F32(0.000001), direc)
            wgt = np.abs(dst * lev * direc)
            km, kp = k - 1 + (k == 1), k - 1 - (k == rows - 2)
            lm, lp = l - 1 + (l == 1), l - 1 - (l == cols - 2)
            right, left = f[k, l + 1] != INSIDE, f[k, l - 1] != INSIDE
            down, up = f[k + 1, l] != INSIDE, f[k - 1, l] != INSIDE

            def px(y, x):
                return out[y, x].astype(np.float32)

            ix = np.where(right[:, None],
                          np.where(left[:, None], (px(km, lp + 1) - px(km, lm - 1)) * _F32(2), px(km, lp + 1) - px(km, lm)),
                          np.where(left[:, None], px(km, lp) - px(km, lm - 1), _F32(0)))
            iy = np.where(down[:, None],
                          np.where(up[:, None], (px(kp + 1, lm) - px(km - 1, lm)) * _F32(2), px(kp + 1, lm) - px(km, lm)),
                          np.where(up[:, None], px(kp, lm) - px(km - 1, lm), _F32(0)))
            wc = wgt[:, None]
            first = np.full((1, 3), 1.0e-20, np.float32)
            ia = np.cumsum(wc * px(k - 1, l - 1), 0, dtype=np.float32)[-1] if len(k) else np.zeros(3, np.float32)
            jx = np.cumsum(-(wc * (ix * rx[:, None])), 0, dtype=np.float32)[-1] if len(k) else np.zeros(3, np.float32)
            jy = np.cumsum(-(wc * (iy * ry[:, None])), 0, dtype=np.float32)[-1] if len(k) else np.zeros(3, np.float32)
            s = np.cumsum(np.concatenate([first, np.repeat(wc, 3, 1)]), 0, dtype=np.float32)[-1]
            sat = ia / s + (jx + jy) / (np.sqrt(jx * jx + jy * jy) + _F32(1.0e-20)) + _F32(0.5)
            out[i - 1, j - 1] = np.clip(np.rint(sat), 0, 255).astype(np.uint8)
            f[i, j] = BAND
            heapq.heappush(heap, (dist, seq, i, j))
            seq += 1
    return out
