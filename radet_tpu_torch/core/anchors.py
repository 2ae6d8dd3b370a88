"""Static multi-level anchor grids for the RADet head (numpy).

Port of ``radet_tpu/core/anchors.py``.  RADet uses one square anchor per
cell (``ratios=[1.0]``, ``octave_base_scale=8``, ``scales_per_octave=1``,
``center_offset=0``, ``base_size=stride``): cell (i, j) of the level with
stride s has its anchor centered at ``(j*s, i*s)`` with side ``8*s``.
Anchors are computed once per input resolution on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

INF = 1e8


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    octave_base_scale: float = 8.0
    # per-level regress ranges used by label assignment
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1.0, 64.0),
        (64.0, 128.0),
        (128.0, 256.0),
        (256.0, 512.0),
        (512.0, INF),
    )

    @classmethod
    def from_cfg(cls, cfg: dict) -> "AnchorConfig":
        ratios = cfg.get("ratios", [1.0])
        spo = cfg.get("scales_per_octave", 1)
        if list(ratios) != [1.0] or spo != 1:
            raise ValueError(
                "RADet anchors are one square anchor per cell (ratios=[1.0], "
                f"scales_per_octave=1); got ratios={ratios}, scales_per_octave={spo}"
            )
        center_offset = cfg.get("center_offset", 0.0)
        if float(center_offset) != 0.0:
            raise ValueError(
                "RADet anchors place centers at cell corners (center_offset=0); "
                f"got center_offset={center_offset}"
            )
        if "scales" in cfg or "base_sizes" in cfg:
            raise ValueError(
                "explicit anchor 'scales'/'base_sizes' are not supported: sizes "
                "derive from octave_base_scale * stride"
            )
        kwargs = {}
        if "strides" in cfg:
            kwargs["strides"] = tuple(cfg["strides"])
        if "octave_base_scale" in cfg:
            kwargs["octave_base_scale"] = float(cfg["octave_base_scale"])
        if "regress_ranges" in cfg:
            kwargs["regress_ranges"] = tuple(tuple(r) for r in cfg["regress_ranges"])
        return cls(**kwargs)

    def __post_init__(self):
        if len(self.strides) != len(self.regress_ranges):
            raise ValueError(
                f"strides ({len(self.strides)}) and regress_ranges "
                f"({len(self.regress_ranges)}) must align per level"
            )


def anchor_featmap_sizes(
    img_shape: Tuple[int, int], strides: Sequence[int]
) -> List[Tuple[int, int]]:
    """Feature-map (h, w) per level = ceil(img/stride), which is also the
    conv output size of the ResNet+FPN tower (stride-2 convs with symmetric
    padding round up)."""
    h, w = img_shape
    return [(math.ceil(h / s), math.ceil(w / s)) for s in strides]


def generate_anchors(
    img_shape: Tuple[int, int], cfg: AnchorConfig | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Build the concatenated multi-level anchor set for a fixed input size.

    Returns:
        anchors: (N, 4) float32 xyxy anchor boxes, levels concatenated in
            stride order, row-major within a level (x fastest).
        regress_ranges: (N, 2) float32 per-anchor regress range.
        strides: (N,) float32 per-anchor stride.
        num_level_anchors: list of per-level anchor counts.
    """
    cfg = cfg or AnchorConfig()
    sizes = anchor_featmap_sizes(img_shape, cfg.strides)
    all_anchors, all_ranges, all_strides, counts = [], [], [], []
    for (fh, fw), stride, rng in zip(sizes, cfg.strides, cfg.regress_ranges):
        half = 0.5 * cfg.octave_base_scale * stride
        xs = np.arange(fw, dtype=np.float32) * stride
        ys = np.arange(fh, dtype=np.float32) * stride
        cx, cy = np.meshgrid(xs, ys)  # row-major: y outer, x inner
        cx = cx.reshape(-1)
        cy = cy.reshape(-1)
        boxes = np.stack([cx - half, cy - half, cx + half, cy + half], axis=-1)
        all_anchors.append(boxes.astype(np.float32))
        all_ranges.append(np.tile(np.asarray(rng, np.float32), (fh * fw, 1)))
        all_strides.append(np.full((fh * fw,), stride, np.float32))
        counts.append(fh * fw)
    return (
        np.concatenate(all_anchors, 0),
        np.concatenate(all_ranges, 0),
        np.concatenate(all_strides, 0),
        counts,
    )


def anchor_centers(anchors: np.ndarray) -> np.ndarray:
    """(N, 2) centers (x, y) of xyxy anchor boxes."""
    return np.stack(
        [(anchors[:, 0] + anchors[:, 2]) * 0.5, (anchors[:, 1] + anchors[:, 3]) * 0.5],
        axis=-1,
    )
