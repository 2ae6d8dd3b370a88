"""Multi-anchor grids of the generic anchor heads (numpy), port of
``radet_tpu/core/anchor_generator.py``: mmdet's ``AnchorGenerator``,
``SSDAnchorGenerator``, ``LegacyAnchorGenerator`` (v1's (size - 1) centers
and rounded corners), ``LegacySSDAnchorGenerator``, ``YOLOAnchorGenerator``
(explicit per-level sizes, responsible flags) and ``PointGenerator``.

Base anchors are scales x ratios (or octave scales) per level, placed on
the level's grid.  Ordering: per level, anchors are row-major over cells
(y outer, x inner) with the A base anchors fastest, which is the order of
a (B, H, W, A * k) head map reshaped to (B, H * W * A, k).  The input
resolution is static, so anchors are computed once on the host.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

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
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def gen_base_anchors(self) -> List[np.ndarray]:
        return [self.gen_single_level_base_anchors(base_size, self.scales, self.ratios,
                                                   None if self.centers is None else self.centers[i])
                for i, base_size in enumerate(self.base_sizes)]

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


class SSDAnchorGenerator(AnchorGenerator):
    """SSD anchors: per-level min and max sizes from ``basesize_ratio_range``
    (the first level's a dataset preset at input 300 or 512), scales 1 and
    sqrt(max / min), ratios 1 and each r, 1 / r; the larger square second."""

    def __init__(self, strides, ratios, basesize_ratio_range, input_size: int = 300, scale_major: bool = True):
        if len(strides) != len(ratios):
            raise AssertionError("one ratio list per stride")
        self.strides = [_pair(s) for s in strides]
        self.input_size = input_size
        self.centers = [(s[0] / 2.0, s[1] / 2.0) for s in self.strides]
        self.basesize_ratio_range = tuple(basesize_ratio_range)
        min_ratio, max_ratio = (int(r * 100) for r in basesize_ratio_range)
        step = int(np.floor(max_ratio - min_ratio) / (self.num_levels - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(int(input_size * ratio / 100))
            max_sizes.append(int(input_size * (ratio + step) / 100))
        presets = {300: {0.15: (7, 15), 0.2: (10, 20)}, 512: {0.1: (4, 10), 0.15: (7, 15)}}
        if input_size not in presets:
            raise ValueError(f"only input_size 300 or 512 supported, got {input_size}")
        first = presets[input_size].get(basesize_ratio_range[0])
        if first is None:
            raise ValueError(f"basesize_ratio_range[0] must be {' or '.join(map(str, presets[input_size]))} for "
                             f"input {input_size}, got {basesize_ratio_range[0]}")
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))
        self.ratios, self.scales = [], []
        for k in range(len(self.strides)):
            anchor_ratio = [1.0]
            for r in ratios[k]:
                anchor_ratio += [1.0 / r, r]
            self.ratios.append(np.asarray(anchor_ratio, np.float32))
            self.scales.append(np.asarray([1.0, float(np.sqrt(max_sizes[k] / min_sizes[k]))], np.float32))
        self.base_sizes = min_sizes
        self.scale_major = scale_major
        self.center_offset = 0.0
        self.base_anchors = self.gen_base_anchors()

    def gen_base_anchors(self) -> List[np.ndarray]:
        out = []
        for i, base_size in enumerate(self.base_sizes):
            base = self.gen_single_level_base_anchors(base_size, self.scales[i], self.ratios[i], self.centers[i])
            indices = list(range(len(self.ratios[i])))
            indices.insert(1, len(indices))  # the sqrt(max / min) square at slot 1
            out.append(base[np.asarray(indices)])
        return out


class LegacyAnchorGenerator(AnchorGenerator):
    """mmdet v1's anchors: centers at ``center_offset * (size - 1)`` and
    corners ``center -+ (w - 1) / 2``, rounded."""

    def gen_single_level_base_anchors(self, base_size, scales, ratios, center=None) -> np.ndarray:
        w = h = float(base_size)
        if center is None:
            x_center, y_center = self.center_offset * (w - 1), self.center_offset * (h - 1)
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
        return np.round(np.stack([x_center - 0.5 * (ws - 1), y_center - 0.5 * (hs - 1),
                                  x_center + 0.5 * (ws - 1), y_center + 0.5 * (hs - 1)], axis=-1)).astype(np.float32)


class LegacySSDAnchorGenerator(SSDAnchorGenerator, LegacyAnchorGenerator):
    """mmdet v1's SSD anchors: SSD's sizes, (stride - 1) / 2 centers, the
    legacy corners."""

    def __init__(self, strides, ratios, basesize_ratio_range, input_size=300, scale_major=True):
        super().__init__(strides, ratios, basesize_ratio_range, input_size, scale_major)
        self.centers = [((s - 1) / 2.0, (s - 1) / 2.0) for s in strides]
        self.base_anchors = self.gen_base_anchors()


class YOLOAnchorGenerator(AnchorGenerator):
    """YOLO anchors from explicit per-level (w, h) base sizes, centered in
    the first cell."""

    def __init__(self, strides, base_sizes):
        self.strides = [_pair(s) for s in strides]
        self.centers = [(s[0] / 2.0, s[1] / 2.0) for s in self.strides]
        num_per_level = len(base_sizes[0])
        self.base_sizes = []
        for sizes_per_level in base_sizes:
            if len(sizes_per_level) != num_per_level:
                raise AssertionError("the same number of base sizes on every level")
            self.base_sizes.append([_pair(b) for b in sizes_per_level])
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_levels(self) -> int:
        return len(self.base_sizes)

    def gen_base_anchors(self) -> List[np.ndarray]:
        out = []
        for i, sizes_per_level in enumerate(self.base_sizes):
            xc, yc = self.centers[i]
            out.append(np.asarray([[xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h]
                                   for w, h in sizes_per_level], np.float32))
        return out

    def responsible_flags(self, featmap_sizes, gt_bboxes) -> List[np.ndarray]:
        """Per-level (H * W * A,) flags of the cells holding a GT box's center."""
        if len(featmap_sizes) != self.num_levels:
            raise AssertionError(f"{len(featmap_sizes)} feature sizes for {self.num_levels} levels")
        gt_bboxes = np.asarray(gt_bboxes, np.float32)
        cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
        cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
        out = []
        for i in range(self.num_levels):
            feat_h, feat_w = featmap_sizes[i]
            sw, sh = self.strides[i]
            idx = np.floor(cy / sh).astype(np.int64) * feat_w + np.floor(cx / sw).astype(np.int64)
            grid = np.zeros(feat_h * feat_w, bool)
            grid[idx] = True
            out.append(np.repeat(grid, self.num_base_anchors[i]))
        return out


class PointGenerator:
    """Per-cell (x, y, stride) points."""

    @staticmethod
    def grid_points(featmap_size, stride: float = 16.0) -> np.ndarray:
        feat_h, feat_w = featmap_size
        xx = np.tile(np.arange(feat_w, dtype=np.float32) * stride, feat_h)
        yy = np.repeat(np.arange(feat_h, dtype=np.float32) * stride, feat_w)
        return np.stack([xx, yy, np.full_like(xx, stride)], axis=-1)

    @staticmethod
    def valid_flags(featmap_size, valid_size) -> np.ndarray:
        feat_h, feat_w = featmap_size
        valid_h, valid_w = valid_size
        if valid_h > feat_h or valid_w > feat_w:
            raise AssertionError(f"valid size {valid_size} beyond the feature map {featmap_size}")
        vx = np.zeros(feat_w, bool)
        vy = np.zeros(feat_h, bool)
        vx[:valid_w] = True
        vy[:valid_h] = True
        return np.tile(vx, feat_h) & np.repeat(vy, feat_w)


ANCHOR_GENERATORS = {
    "AnchorGenerator": AnchorGenerator,
    "SSDAnchorGenerator": SSDAnchorGenerator,
    "LegacyAnchorGenerator": LegacyAnchorGenerator,
    "LegacySSDAnchorGenerator": LegacySSDAnchorGenerator,
    "YOLOAnchorGenerator": YOLOAnchorGenerator,
    "PointGenerator": PointGenerator,
}


def build_anchor_generator(cfg: dict):
    """The generator of an ``anchor_generator`` config (a type of
    :data:`ANCHOR_GENERATORS`, default ``AnchorGenerator``); another type
    raises KeyError."""
    cfg = dict(cfg)
    gen_type = cfg.pop("type", "AnchorGenerator")
    if gen_type not in ANCHOR_GENERATORS:
        raise KeyError(f"unknown anchor generator {gen_type!r}; available: {sorted(ANCHOR_GENERATORS)}")
    return ANCHOR_GENERATORS[gen_type](**cfg)


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
