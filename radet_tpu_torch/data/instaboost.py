"""InstaBoost's instance paste-jitter without cv2 (port of
``radet_tpu/data/instaboost.py``).

With probability ``aug_ratio``, each instance draws an action ('normal',
'horizontal' or 'skip'); the instances that move leave one hole, the union
of their masks dilated by 3x3, which is filled by Telea inpainting
(``inpaint.inpaint_telea``, ``cv2.inpaint``'s bytes); the pixels of the
instances that stay are restored, and each moving instance, the largest
first, is pasted at a jittered place (rotation and scale about its box
centre, a shift of up to its size over ``dx``/``dy``, mirrored across the
image's vertical centre line for 'horizontal'), its colours jittered in
uint8 HSV with probability ``color_prob``.  Every paste occludes the masks
under it; the visible boxes are recomputed from the masks and the fully
occluded instances dropped.  It runs after ``LoadAnnotations`` on the
decoded (G, H, W) masks; ``hflag=True`` (the appearance heatmap of the
``instaboostfast`` package) raises, as in the JAX package.

The warps are ``warp.warp_affine`` (``cv2.warpAffine``: the image
bilinear with fill 0, the masks nearest), the matrices
``warp.rotation_matrix_2d`` (``getRotationMatrix2D``), the dilation
``warp.dilate3x3`` and the HSV pair ``color_aug.rgb_to_hsv_u8`` /
``hsv_to_rgb_u8``, so the output is the JAX package's byte for byte.  The
draws are its draws, in its order, from Python's ``random`` or from a
``random.Random(seed)`` of the transform's own.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import color_aug
from .inpaint import inpaint_telea
from .pipeline import _generator
from .warp import dilate3x3, rotation_matrix_2d, warp_affine


class InstaBoost:
    def __init__(
        self,
        action_candidate: Sequence[str] = ("normal", "horizontal", "skip"),
        action_prob: Sequence[float] = (1, 0, 0),
        scale: Tuple[float, float] = (0.8, 1.2),
        dx: float = 15,
        dy: float = 15,
        theta: Tuple[float, float] = (-1, 1),
        color_prob: float = 0.5,
        hflag: bool = False,
        aug_ratio: float = 0.5,
        seed: Optional[int] = None,
    ):
        if hflag:
            raise ValueError(
                "InstaBoost(hflag=True) — appearance-consistency heatmap "
                "guidance — requires the external instaboostfast matting "
                "model and is not supported by this native implementation; "
                "use hflag=False (the reference default)"
            )
        unknown = set(action_candidate) - {"normal", "horizontal", "skip"}
        if unknown:
            raise ValueError(f"unknown InstaBoost actions: {sorted(unknown)}")
        if len(action_candidate) != len(action_prob):
            raise ValueError("action_candidate and action_prob length mismatch")
        if dx <= 0 or dy <= 0:
            raise ValueError("dx/dy must be positive divisors")
        total = float(sum(action_prob))
        if total <= 0:
            raise ValueError("action_prob must sum to a positive value")
        self.actions = tuple(action_candidate)
        self.action_prob = tuple(p / total for p in action_prob)
        self.scale = tuple(scale)
        self.dx = float(dx)
        self.dy = float(dy)
        self.theta = tuple(theta)
        self.color_prob = float(color_prob)
        self.aug_ratio = float(aug_ratio)
        self.rng = _generator(seed)

    def _sample_action(self, rng) -> str:
        r = rng.random()
        acc = 0.0
        for a, p in zip(self.actions, self.action_prob):
            acc += p
            if r <= acc:
                return a
        return self.actions[-1]

    def _jitter_matrix(self, box: np.ndarray, action: str, img_w: int, rng) -> np.ndarray:
        """The 2x3 affine moving one instance: rotation and scale about its
        box centre, a shift of up to box size / dx|dy, and for 'horizontal'
        a mirror across x = (W - 1) / 2."""
        x1, y1, x2, y2 = box
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        w, h = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
        s = rng.uniform(*self.scale)
        tx = rng.uniform(-w / self.dx, w / self.dx)
        ty = rng.uniform(-h / self.dy, h / self.dy)
        ang = rng.uniform(*self.theta)
        mat = rotation_matrix_2d((float(cx), float(cy)), -ang, s)
        mat[0, 2] += tx
        mat[1, 2] += ty
        if action == "horizontal":
            flip = np.array([[-1, 0, img_w - 1], [0, 1, 0], [0, 0, 1]], np.float64)
            mat = (flip @ np.vstack([mat, [0, 0, 1]]))[:2]
        return mat

    @staticmethod
    def _color_jitter(patch: np.ndarray, rng) -> np.ndarray:
        """A small HSV jitter of a pasted instance's pixels (int16 hue shift
        mod 180, saturation and value scaled and clipped)."""
        hsv = color_aug.rgb_to_hsv_u8(patch).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + rng.randint(-6, 6)) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(0.9, 1.1), 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * rng.uniform(0.9, 1.1), 0, 255)
        return color_aug.hsv_to_rgb_u8(hsv.astype(np.uint8))

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if "gt_masks" not in results:
            raise KeyError(
                "InstaBoost needs per-instance masks: place it after "
                "LoadAnnotations(with_bop_mask=True) / LoadMaskFromFile "
                "(this build pastes decoded masks, not ann_info polygons)"
            )
        rng = self.rng or random
        if rng.random() > self.aug_ratio:
            return results
        masks = results["gt_masks"]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        g = len(masks)
        if g == 0:
            return results
        img = results["img"]
        h, w = img.shape[:2]

        actions = [self._sample_action(rng) for _ in range(g)]
        moved = [i for i in range(g) if actions[i] != "skip"]
        if not moved:
            return results

        # the background under every moving instance, restored in one inpaint
        hole = np.zeros((h, w), np.uint8)
        for i in moved:
            hole |= masks[i].astype(np.uint8)
        canvas = inpaint_telea(img, dilate3x3(hole), 3)
        for i in range(g):  # the instances that stay keep their pixels
            if i not in moved:
                m = masks[i].astype(bool)
                canvas[m] = img[m]

        new_masks = masks.copy()
        # the larger instances first, so that the smaller stay visible on top
        order = sorted(moved, key=lambda i: -float(masks[i].sum()))
        for i in order:
            mat = self._jitter_matrix(boxes[i], actions[i], w, rng)
            warped_mask = warp_affine(masks[i].astype(np.uint8), mat, 0, "nearest")
            if not warped_mask.any():
                # the jitter pushed the instance out of the frame: it stays
                m = masks[i].astype(bool)
                canvas[m] = img[m]
                continue
            patch = warp_affine(img, mat, 0, "bilinear")
            if rng.random() < self.color_prob:
                patch = self._color_jitter(patch, rng)
            sel = warped_mask.astype(bool)
            canvas[sel] = patch[sel]
            new_masks[:, sel] = 0  # the paste occludes what was under it
            new_masks[i] = warped_mask.astype(new_masks.dtype)

        keep, out_boxes = [], []
        for i in range(g):
            ys, xs = np.nonzero(new_masks[i])
            if len(xs) == 0:
                continue
            keep.append(i)
            out_boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        results["img"] = canvas
        results["gt_masks"] = np.ascontiguousarray(new_masks[keep])
        results["gt_bboxes"] = np.asarray(out_boxes, np.float32).reshape(-1, 4)
        if "gt_labels" in results:
            results["gt_labels"] = results["gt_labels"][keep]
        return results

    def __repr__(self):
        return (
            f"InstaBoost(actions={self.actions}, prob={self.action_prob}, "
            f"scale={self.scale}, dx={self.dx}, dy={self.dy}, theta={self.theta}, "
            f"color_prob={self.color_prob}, aug_ratio={self.aug_ratio})"
        )
