"""AutoAugment for detection without cv2 (port of
``radet_tpu/data/auto_augment.py``).

``AutoAugment`` picks one policy (a list of transform configs) per sample;
its transforms are the geometric ``Shear``, ``Rotate`` and ``Translate``
(image, boxes and per-instance masks, a constant fill outside the image,
boxes that collapse dropped with their labels and masks) and the
photometric ``ColorTransform``, ``EqualizeTransform``,
``BrightnessTransform`` and ``ContrastTransform`` (image only).  A
``level`` in [0, 10] scales linearly to the magnitude, and the geometric
magnitudes are negated with probability ``random_negative_prob``.

Each output is the JAX package's byte for byte: images warp through
``warp.warp_affine`` (cv2's ``warpAffine``: bilinear, masks nearest),
rotations come from ``warp.rotation_matrix_2d`` (``getRotationMatrix2D``),
the gray of ``ColorTransform`` and ``ContrastTransform`` is
``color_aug.rgb_to_gray`` (``cv2.cvtColor``'s COLOR_RGB2GRAY), and the
matrices keep the JAX package's dtypes: ``Shear`` and ``Translate`` build
float32 matrices, ``Rotate`` float64, which the box corners follow.

The draws are the JAX package's, in its order, from Python's ``random``
(which the loader's process workers seed per task), or from a
``random.Random(seed)`` of the transform's own.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import color_aug
from .pipeline import _generator
from .warp import rotation_matrix_2d, warp_affine

_MAX_LEVEL = 10


def level_to_value(level: float, max_value: float) -> float:
    return (level / _MAX_LEVEL) * max_value


def enhance_level_to_value(level: float, a: float = 1.8, b: float = 0.1) -> float:
    return (level / _MAX_LEVEL) * a + b


def _random_negative(value: float, prob: float, rng) -> float:
    return -value if rng.random() < prob else value


def _fill3(img_fill_val) -> Tuple[float, float, float]:
    if isinstance(img_fill_val, (int, float)):
        return (float(img_fill_val),) * 3
    vals = tuple(float(v) for v in img_fill_val)
    if len(vals) != 3:
        raise ValueError(f"img_fill_val must be a scalar or 3-tuple, got {img_fill_val}")
    if not all(0 <= v <= 255 for v in vals):
        raise ValueError(f"img_fill_val out of [0,255]: {vals}")
    return vals


def _check_level_prob(level: float, prob: float):
    if not 0 <= level <= _MAX_LEVEL:
        raise ValueError(f"level must be in [0,{_MAX_LEVEL}], got {level}")
    if not 0 <= prob <= 1:
        raise ValueError(f"prob must be in [0,1], got {prob}")


def _warp_masks(masks: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Each (H, W) binary mask of ``masks`` warped nearest, fill 0."""
    if len(masks) == 0:
        return masks
    out = np.empty_like(masks)
    for i in range(len(masks)):
        out[i] = warp_affine(masks[i], mat[:2].astype(np.float64), 0, "nearest")
    return out


def _warp_bboxes(boxes: np.ndarray, mat: np.ndarray, w: int, h: int) -> np.ndarray:
    """Each box's 4 corners through the 2x3 affine, their axis-aligned hull
    clipped to the image, in the dtype numpy gives the corners and
    ``mat``, cast back to the boxes' dtype."""
    if len(boxes) == 0:
        return boxes
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack(
        [np.stack([x1, y1], -1), np.stack([x2, y1], -1),
         np.stack([x1, y2], -1), np.stack([x2, y2], -1)], axis=1
    )  # (N, 4, 2)
    ones = np.ones((*corners.shape[:2], 1), corners.dtype)
    hom = np.concatenate([corners, ones], -1)  # (N, 4, 3)
    new = hom @ mat[:2].T  # (N, 4, 2)
    min_xy = new.min(axis=1)
    max_xy = new.max(axis=1)
    min_x = np.clip(min_xy[:, 0], 0, w)
    min_y = np.clip(min_xy[:, 1], 0, h)
    max_x = np.clip(max_xy[:, 0], min_x, w)
    max_y = np.clip(max_xy[:, 1], min_y, h)
    return np.stack([min_x, min_y, max_x, max_y], -1).astype(boxes.dtype)


def _filter_degenerate(results: Dict[str, Any], min_size: float = 0):
    """Drop boxes no wider or taller than ``min_size`` after a warp, with
    their labels and masks."""
    boxes = results.get("gt_bboxes")
    if boxes is None or len(boxes) == 0:
        return
    keep = ((boxes[:, 2] - boxes[:, 0]) > min_size) & ((boxes[:, 3] - boxes[:, 1]) > min_size)
    if keep.all():
        return
    idx = np.nonzero(keep)[0]
    results["gt_bboxes"] = boxes[idx]
    if "gt_labels" in results:
        results["gt_labels"] = results["gt_labels"][idx]
    if "gt_masks" in results and len(results["gt_masks"]):
        results["gt_masks"] = np.ascontiguousarray(results["gt_masks"][idx])


def _apply_affine(results: Dict[str, Any], mat: np.ndarray, fill: Tuple[float, float, float], interpolation: str,
                  min_size: float = 0) -> Dict[str, Any]:
    img = results["img"]
    h, w = img.shape[:2]
    results["img"] = warp_affine(img, mat[:2].astype(np.float64), fill, interpolation)
    if "gt_bboxes" in results:
        results["gt_bboxes"] = _warp_bboxes(results["gt_bboxes"], mat, w, h)
    if "gt_masks" in results:
        results["gt_masks"] = _warp_masks(results["gt_masks"], mat)
    _filter_degenerate(results, min_size)
    return results


class Shear:
    """Shear image, boxes and masks along one axis by ``level / 10 *
    max_shear_magnitude`` (a float32 matrix)."""

    def __init__(self, level, img_fill_val=128, seg_ignore_label=255, prob: float = 0.5,
                 direction: str = "horizontal", max_shear_magnitude: float = 0.3,
                 random_negative_prob: float = 0.5, interpolation: str = "bilinear", seed: Optional[int] = None):
        _check_level_prob(level, prob)
        if direction not in ("horizontal", "vertical"):
            raise ValueError(f"direction must be horizontal|vertical, got {direction}")
        if not 0.0 <= max_shear_magnitude <= 1.0:
            raise ValueError(f"max_shear_magnitude must be in [0,1], got {max_shear_magnitude}")
        self.magnitude = level_to_value(level, max_shear_magnitude)
        self.fill = _fill3(img_fill_val)
        self.prob = prob
        self.direction = direction
        self.random_negative_prob = random_negative_prob
        self.interpolation = interpolation
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        m = _random_negative(self.magnitude, self.random_negative_prob, rng)
        if self.direction == "horizontal":
            mat = np.array([[1, m, 0], [0, 1, 0]], np.float32)
        else:
            mat = np.array([[1, 0, 0], [m, 1, 0]], np.float32)
        return _apply_affine(results, mat, self.fill, self.interpolation)


class Rotate:
    """Rotate image, boxes and masks about the image centre (or ``center``)
    by ``level / 10 * max_rotate_angle`` degrees, clockwise for a positive
    angle, with an isotropic ``scale`` (a float64 matrix)."""

    def __init__(self, level, scale: float = 1, center=None, img_fill_val=128, seg_ignore_label=255,
                 prob: float = 0.5, max_rotate_angle: float = 30, random_negative_prob: float = 0.5,
                 seed: Optional[int] = None):
        _check_level_prob(level, prob)
        if isinstance(center, (int, float)):
            center = (center, center)
        self.angle = level_to_value(level, max_rotate_angle)
        self.scale = scale
        self.center = center
        self.fill = _fill3(img_fill_val)
        self.prob = prob
        self.random_negative_prob = random_negative_prob
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        h, w = results["img"].shape[:2]
        center = self.center if self.center is not None else ((w - 1) * 0.5, (h - 1) * 0.5)
        angle = _random_negative(self.angle, self.random_negative_prob, rng)
        mat = rotation_matrix_2d(tuple(center), -angle, self.scale)
        return _apply_affine(results, mat, self.fill, "bilinear")


class Translate:
    """Translate image, boxes and masks by ``int(level / 10 *
    max_translate_offset)`` pixels along one axis (a float32 matrix)."""

    def __init__(self, level, prob: float = 0.5, img_fill_val=128, seg_ignore_label=255,
                 direction: str = "horizontal", max_translate_offset: float = 250.0,
                 random_negative_prob: float = 0.5, min_size: float = 0, seed: Optional[int] = None):
        _check_level_prob(level, prob)
        if direction not in ("horizontal", "vertical"):
            raise ValueError(f"direction must be horizontal|vertical, got {direction}")
        self.offset = int(level_to_value(level, max_translate_offset))
        self.prob = prob
        self.fill = _fill3(img_fill_val)
        self.direction = direction
        self.random_negative_prob = random_negative_prob
        self.min_size = min_size
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        off = _random_negative(self.offset, self.random_negative_prob, rng)
        if self.direction == "horizontal":
            mat = np.array([[1, 0, off], [0, 1, 0]], np.float32)
        else:
            mat = np.array([[1, 0, 0], [0, 1, off]], np.float32)
        return _apply_affine(results, mat, self.fill, "bilinear", self.min_size)


def _gray(img: np.ndarray) -> np.ndarray:
    return color_aug.rgb_to_gray(img, 15)


def _blend(img: np.ndarray, degenerated: np.ndarray, factor: float) -> np.ndarray:
    out = img.astype(np.float32) * factor + degenerated.astype(np.float32) * (1 - factor)
    return np.clip(out, 0, 255).astype(img.dtype)


class _Photometric:
    """With probability ``prob`` (``random() > prob`` skips), :meth:`apply`
    on the image at ``factor = enhance_level_to_value(level)``."""

    def __init__(self, level, prob: float = 0.5, seed: Optional[int] = None):
        _check_level_prob(level, prob)
        self.prob = prob
        self.factor = enhance_level_to_value(level)
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if (self.rng or random).random() > self.prob:
            return results
        results["img"] = self.apply(results["img"])
        return results


class ColorTransform(_Photometric):
    """Blend with the image's gray: factor 1 is the identity, 0 gray."""

    def apply(self, img: np.ndarray) -> np.ndarray:
        return _blend(img, np.repeat(_gray(img)[..., None], 3, -1), self.factor)


class BrightnessTransform(_Photometric):
    """Blend with black: factor 1 is the identity, 0 black."""

    def apply(self, img: np.ndarray) -> np.ndarray:
        return _blend(img, np.zeros_like(img), self.factor)


class ContrastTransform(_Photometric):
    """Blend with the image of its mean gray."""

    def apply(self, img: np.ndarray) -> np.ndarray:
        mean = int(round(float(_gray(img).mean())))
        return _blend(img, np.full_like(img, mean), self.factor)


class EqualizeTransform:
    """Per-channel histogram equalization (PIL's ``ImageOps.equalize``)."""

    def __init__(self, prob: float = 0.5, seed: Optional[int] = None):
        if not 0 <= prob <= 1:
            raise ValueError(f"prob must be in [0,1], got {prob}")
        self.prob = prob
        self.rng = _generator(seed)

    @staticmethod
    def _equalize_channel(ch: np.ndarray) -> np.ndarray:
        histo = np.histogram(ch, 256, (0, 255))[0]
        nonzero = histo[histo > 0]
        step = (nonzero.sum() - nonzero[-1]) // 255 if len(nonzero) else 0
        if not step:
            return ch
        lut = (np.cumsum(histo) + (step // 2)) // step
        lut = np.concatenate([[0], lut[:-1]], 0)
        return np.clip(lut, 0, 255).astype(ch.dtype)[ch]

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if (self.rng or random).random() > self.prob:
            return results
        img = results["img"]
        results["img"] = np.stack([self._equalize_channel(img[..., c]) for c in range(img.shape[-1])], -1)
        return results


class AutoAugment:
    """One policy per sample, drawn by ``randrange(len(policies))``; each
    policy is a list of transform configs of the pipeline's registry."""

    def __init__(self, policies: Sequence[Sequence[dict]], seed: Optional[int] = None):
        if not isinstance(policies, (list, tuple)) or not policies:
            raise ValueError("policies must be a non-empty list of policies")
        from .pipeline import _TRANSFORMS, Compose  # filled after this module is imported

        self.policies: List[List[dict]] = [list(p) for p in policies]
        built = []
        for policy in self.policies:
            if not isinstance(policy, (list, tuple)) or not policy:
                raise ValueError("each policy must be a non-empty list of dicts")
            steps = []
            for aug in policy:
                if not isinstance(aug, dict) or "type" not in aug:
                    raise ValueError(f"each augmentation must be a dict with 'type': {aug}")
                cfg = dict(aug)
                t = cfg.pop("type")
                if t not in _TRANSFORMS:
                    raise KeyError(f"unknown transform {t} in AutoAugment policy")
                steps.append(_TRANSFORMS[t](**cfg))
            built.append(Compose(steps))
        self.transforms = built
        self.rng = _generator(seed)

    def __call__(self, results):
        return self.transforms[(self.rng or random).randrange(len(self.transforms))](results)

    def __repr__(self):
        return f"AutoAugment(policies={self.policies})"


TRANSFORMS = {
    "AutoAugment": AutoAugment,
    "Shear": Shear,
    "Rotate": Rotate,
    "Translate": Translate,
    "ColorTransform": ColorTransform,
    "EqualizeTransform": EqualizeTransform,
    "BrightnessTransform": BrightnessTransform,
    "ContrastTransform": ContrastTransform,
}
