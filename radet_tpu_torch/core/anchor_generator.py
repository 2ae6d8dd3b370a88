"""Multi-anchor grids of the generic anchor heads (numpy), port of
``radet_tpu/core/anchor_generator.py``'s ``AnchorGenerator``.

Base anchors are scales x ratios (or octave scales) per level, placed on
the level's grid.  Ordering: per level, anchors are row-major over cells
(y outer, x inner) with the A base anchors fastest, which is the order of
a (B, H, W, A * k) head map reshaped to (B, H * W * A, k).  The input
resolution is static, so anchors are computed once on the host.

The SSD, legacy, YOLO and point generators are not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

_OTHER_GENERATORS = "ROADMAP.md Queue 1 item 12, other families"


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class AnchorGenerator:
    """Standard anchor generator (mmdet ``AnchorGenerator``)."""

    def __init__(
        self,
        strides,
        ratios,
        scales=None,
        base_sizes=None,
        scale_major: bool = True,
        octave_base_scale: Optional[float] = None,
        scales_per_octave: Optional[int] = None,
        centers=None,
        center_offset: float = 0.0,
    ):
        if center_offset != 0 and centers is not None:
            raise ValueError(f"center cannot be set when center_offset != 0, {centers} given")
        if not 0 <= center_offset <= 1:
            raise ValueError(f"center_offset should be in [0, 1], got {center_offset}")
        if centers is not None and len(centers) != len(strides):
            raise ValueError("one center per stride")
        self.strides = [_pair(s) for s in strides]
        self.base_sizes = [min(s) for s in self.strides] if base_sizes is None else list(base_sizes)
        if len(self.base_sizes) != len(self.strides):
            raise ValueError("one base size per stride")
        if (octave_base_scale is not None and scales_per_octave is not None) == (scales is not None):
            raise ValueError("set either scales or octave_base_scale+scales_per_octave, not both")
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        else:
            octave_scales = np.array([2 ** (i / scales_per_octave) for i in range(scales_per_octave)])
            self.scales = (octave_scales * octave_base_scale).astype(np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.centers = centers
        self.center_offset = center_offset
        self.base_anchors = [
            self.gen_single_level_base_anchors(
                base_size, self.scales, self.ratios, None if centers is None else centers[i]
            )
            for i, base_size in enumerate(self.base_sizes)
        ]

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def gen_single_level_base_anchors(self, base_size, scales, ratios, center=None) -> np.ndarray:
        w = h = float(base_size)
        if center is None:
            x_center, y_center = self.center_offset * w, self.center_offset * h
        else:
            x_center, y_center = center
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        else:
            ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack(
            [x_center - 0.5 * ws, y_center - 0.5 * hs, x_center + 0.5 * ws, y_center + 0.5 * hs],
            axis=-1,
        ).astype(np.float32)

    def grid_anchors(self, featmap_sizes) -> List[np.ndarray]:
        """Per-level (H * W * A, 4) anchors for the given feature sizes."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature sizes for {self.num_levels} levels")
        return [
            self.single_level_grid_anchors(self.base_anchors[i], featmap_sizes[i], self.strides[i])
            for i in range(self.num_levels)
        ]

    @staticmethod
    def single_level_grid_anchors(base_anchors, featmap_size, stride) -> np.ndarray:
        feat_h, feat_w = int(featmap_size[0]), int(featmap_size[1])
        shift_x = np.arange(feat_w, dtype=np.float32) * stride[0]
        shift_y = np.arange(feat_h, dtype=np.float32) * stride[1]
        xx = np.tile(shift_x, feat_h)  # row-major: y outer, x inner
        yy = np.repeat(shift_y, feat_w)
        shifts = np.stack([xx, yy, xx, yy], axis=-1)
        return (base_anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4).astype(np.float32)

    def valid_flags(self, featmap_sizes, pad_shape) -> List[np.ndarray]:
        """Per-level (H * W * A,) flags: the cell lies inside ``pad_shape``."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature sizes for {self.num_levels} levels")
        flags = []
        h, w = pad_shape[:2]
        for i in range(self.num_levels):
            sw, sh = self.strides[i]
            feat_h, feat_w = featmap_sizes[i]
            valid_h = min(int(math.ceil(h / sh)), feat_h)
            valid_w = min(int(math.ceil(w / sw)), feat_w)
            vx = np.zeros(feat_w, bool)
            vy = np.zeros(feat_h, bool)
            vx[:valid_w] = True
            vy[:valid_h] = True
            valid = np.tile(vx, feat_h) & np.repeat(vy, feat_w)
            flags.append(np.repeat(valid, self.num_base_anchors[i]))
        return flags


def build_anchor_generator(cfg: dict) -> AnchorGenerator:
    cfg = dict(cfg)
    gen_type = cfg.pop("type", "AnchorGenerator")
    if gen_type != "AnchorGenerator":
        raise NotImplementedError(f"anchor generator {gen_type!r} is not ported ({_OTHER_GENERATORS})")
    return AnchorGenerator(**cfg)


def flat_anchors_for_input(
    generator: AnchorGenerator, img_shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Concatenated anchors and valid flags at a static input size.

    Feature sizes are ceil(img / stride), the conv output sizes of the
    ResNet + FPN tower.  Returns (anchors (N, 4), valid (N,) bool, per-level
    anchor counts)."""
    h, w = img_shape
    sizes = [(math.ceil(h / s[1]), math.ceil(w / s[0])) for s in generator.strides]
    per_level = generator.grid_anchors(sizes)
    flags = generator.valid_flags(sizes, (h, w))
    return np.concatenate(per_level, 0), np.concatenate(flags, 0), [a.shape[0] for a in per_level]
