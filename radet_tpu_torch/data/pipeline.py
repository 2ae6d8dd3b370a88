"""Host transforms of the training pipeline, numpy only (port of the
transforms of ``radet_tpu/data/pipeline.py`` that need no cv2 or PIL).

Each transform is a callable on a ``results`` dict (keys: img, gt_bboxes,
gt_labels, gt_masks, img_shape, scale_factor, distance_maps, dist_vals,
...).  Images stay uint8 RGB; normalization runs on the device.  The host's
only assignment work is :class:`SampleDistanceAtAnchors`: the distance-map
value of every GT at every anchor center; the assignment itself runs in the
train step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

_FILE_DATA = "ROADMAP.md Queue 1 item 7, host preprocessing without cv2"
_MASK_FREE = "ROADMAP.md Queue 1 item 17, mask-free distance maps"


class RandomFlip:
    """Horizontal flip of image, boxes and masks with probability
    ``flip_ratio``: drawn from ``np.random.RandomState(seed)``, or with
    ``seed=None`` from numpy's global generator (which the loader's process
    workers seed per sample)."""

    def __init__(self, flip_ratio: float = 0.5, seed: Optional[int] = None):
        self.flip_ratio = flip_ratio
        self.rng = np.random if seed is None else np.random.RandomState(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if self.rng.random_sample() >= self.flip_ratio:
            return results
        img = results["img"]
        w = img.shape[1]
        results["img"] = np.ascontiguousarray(np.flip(img, 1))
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            b = results["gt_bboxes"].copy()
            b[:, 0] = w - results["gt_bboxes"][:, 2]
            b[:, 2] = w - results["gt_bboxes"][:, 0]
            results["gt_bboxes"] = b
        if "gt_masks" in results and len(results["gt_masks"]):
            results["gt_masks"] = np.ascontiguousarray(np.flip(results["gt_masks"], 2))
        return results


class Pad:
    """Pad the image (bottom/right, zeros) to a static size (h, w) or to a
    multiple of ``size_divisor``."""

    def __init__(self, size: Optional[Tuple[int, int]] = None, size_divisor: Optional[int] = None):
        self.size = size
        self.size_divisor = size_divisor

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        img = results["img"]
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = (h + d - 1) // d * d, (w + d - 1) // d * d
        if h > th or w > tw:
            raise ValueError(
                f"Pad target {(th, tw)} is smaller than the image {(h, w)}: set input_size "
                "to cover the larger orientation"
            )
        if (th, tw) != (h, w):
            out = np.zeros((th, tw) + img.shape[2:], img.dtype)
            out[:h, :w] = img
            results["img"] = out
        results["pad_shape"] = (th, tw)
        return results


class GenerateDistanceMap:
    """With GT masks the binary visible mask is the distance map."""

    def __init__(self, with_gt_mask: bool = True, distance_transform: str = "gdt", **kwargs):
        if not with_gt_mask:
            raise NotImplementedError(
                f"GenerateDistanceMap(with_gt_mask=False) estimates maps from boxes "
                f"({distance_transform!r}) and is not ported ({_MASK_FREE})"
            )

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        results["distance_maps"] = results["gt_masks"].astype(np.float32)
        return results


class SampleDistanceAtAnchors:
    """Distance-map values at the anchor centers -> ``dist_vals`` (N, max_gt)
    float16 (values in [0, 1]; half the host->device bytes).  Centers outside
    the (pre-pad) image get 0."""

    def __init__(self, anchor_centers: np.ndarray, max_gt: int = 32):
        self.cx = anchor_centers[:, 0].astype(np.int64)
        self.cy = anchor_centers[:, 1].astype(np.int64)
        self.max_gt = max_gt

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        dist_vals = np.zeros((self.cx.shape[0], self.max_gt), np.float16)
        dmaps = results.get("distance_maps")
        if dmaps is not None and len(dmaps):
            h, w = results["img_shape"]
            inside = (self.cx < w) & (self.cy < h)
            cx = np.clip(self.cx, 0, w - 1)
            cy = np.clip(self.cy, 0, h - 1)
            g = min(len(dmaps), self.max_gt)
            vals = dmaps[:g, cy, cx] * inside[None].astype(np.float32)  # (g, N)
            dist_vals[:, :g] = vals.T.astype(np.float16)
        results["dist_vals"] = dist_vals
        return results


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


_TRANSFORMS = {"RandomFlip": RandomFlip, "GenerateDistanceMap": GenerateDistanceMap}


def build_pipeline(
    pipeline_cfg: Sequence[dict],
    *,
    input_size: Tuple[int, int] | None = None,
    anchor_centers: np.ndarray | None = None,
    max_gt: int = 32,
) -> Compose:
    """A Compose from pipeline config dicts.

    ``Pad`` pads to the static ``input_size`` (its ``size_divisor`` must
    divide it); ``SampleDistanceAtAnchors`` and a reference
    ``LabelAssignment`` entry become the anchor-center sampler.  Any type
    besides these, ``RandomFlip`` and ``GenerateDistanceMap`` raises
    ``NotImplementedError``."""
    ts = []
    for t_cfg in pipeline_cfg:
        t_cfg = dict(t_cfg)
        t_type = t_cfg.pop("type")
        if t_type == "Pad" and input_size is not None:
            d = t_cfg.pop("size_divisor", None)
            if d is not None and (input_size[0] % d or input_size[1] % d):
                raise ValueError(f"static input_size {input_size} not divisible by {d}")
            ts.append(Pad(size=input_size))
        elif t_type == "Pad":
            ts.append(Pad(**t_cfg))
        elif t_type in ("SampleDistanceAtAnchors", "LabelAssignment"):
            if anchor_centers is None:
                raise ValueError(f"{t_type} needs anchor_centers")
            if not any(isinstance(t, SampleDistanceAtAnchors) for t in ts):
                ts.append(SampleDistanceAtAnchors(anchor_centers, max_gt=max_gt))
        elif t_type in _TRANSFORMS:
            ts.append(_TRANSFORMS[t_type](**t_cfg))
        else:
            raise NotImplementedError(f"transform {t_type!r} is not ported ({_FILE_DATA})")
    return Compose(ts)
