"""Host transforms of the test and training pipelines (port of the
transforms of ``radet_tpu/data/pipeline.py``, without cv2 or PIL): numpy,
with ``CosyPoseAug``'s image operations in host C++ (``color_aug``) and
polygon masks filled by ``poly.fill_poly``, each equal to cv2's output.
The registry also holds the AutoAugment family (``auto_augment``) and
``InstaBoost`` (``instaboost``), whose warps (``warp``) and inpainting
(``inpaint``) are host C++ equal to cv2's too.

Each transform is a callable on a ``results`` dict (keys: img, gt_bboxes,
gt_labels, gt_masks, img_shape, scale_factor, distance_maps, dist_vals,
...).  Images stay uint8 RGB; normalization runs on the device.  The host's
only assignment work is :class:`SampleDistanceAtAnchors`: the distance-map
value of every GT at every anchor center; the assignment itself runs in the
train step.

The random transforms draw as the JAX package's do, from Python's
``random`` (``RandomBackground``, ``CosyPoseAug``, ``RandomFlip``, the
crops, ``Expand``, ``PhotoMetricDistortion``, ``CutOut``,
``RandomCenterCropPad``, ``RandomHSV``, ``RandomNoise``, ``RandomSmooth``,
the AutoAugment family, ``InstaBoost``), so that both packages take the
same decisions from the same seed; a ``seed`` gives a transform a generator
of its own.  ``PhotoMetricDistortion`` converts RGB<->HSV in cv2's float32
arithmetic (``color_aug.rgb_to_hsv_f32``, ``color_aug.hsv_to_rgb_f32``),
``RandomHSV`` in its uint8 arithmetic (``color_aug.rgb_to_hsv_u8``,
``color_aug.hsv_to_rgb_u8``), and ``RandomSmooth`` blurs with
``color_aug.box_blur`` (``cv2.blur``): host C++.  ``Albu`` and ``Corrupt``
bridge to albumentations and imagecorruptions, imported when one is built.
"""

from __future__ import annotations

import glob
import os.path as osp
import random
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import color_aug
from .image_io import IMREAD_GRAYSCALE, IMREAD_UNCHANGED, imread, imread_rgb
from .poly import fill_poly


def _generator(seed: Optional[int]) -> Optional[random.Random]:
    """A transform's generator: ``random.Random(seed)``, or None for
    Python's global ``random`` (which the loader's process workers seed per
    task).  Either pickles, as process workers need."""
    return None if seed is None else random.Random(seed)


class LoadImageFromFile:
    """``img_prefix`` + ``img_info['filename']`` as RGB uint8, with its
    shape and a unit ``scale_factor``."""

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        path = osp.join(results.get("img_prefix", ""), results["img_info"]["filename"])
        img = imread_rgb(path)
        results["img"] = img
        results["img_shape"] = img.shape[:2]
        results["ori_shape"] = img.shape[:2]
        results["scale_factor"] = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        return results


class LoadAnnotations:
    """``gt_bboxes`` and ``gt_labels`` from ``ann_info``; with
    ``with_bop_mask`` also the visible masks ``gt_masks`` (G, H, W) uint8
    0/1: from the packed id map ``ann_info['mask_packed']``
    (``tools/pack_masks.py``: one PNG per image, GT ``i`` where it equals
    ``masks_idx[i] + 1``) when that file exists under ``seg_prefix``, else
    from each GT's ``mask_visib`` PNG (nonzero is foreground).  With
    ``poly2mask``, polygon ``segmentations`` take precedence: each object's
    parts of at least 3 points, rounded half to even to int32, filled
    together by :func:`poly.fill_poly` (``cv2.fillPoly``'s mask)."""

    def __init__(self, with_bbox: bool = True, with_bop_mask: bool = False, poly2mask: bool = True):
        self.with_bbox = with_bbox
        self.with_bop_mask = with_bop_mask
        self.poly2mask = poly2mask

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        ann = results["ann_info"]
        results["gt_bboxes"] = ann["bboxes"].copy()
        results["gt_labels"] = ann["labels"].copy()
        if not self.with_bop_mask:
            return results
        h, w = results["img_info"]["height"], results["img_info"]["width"]
        seg_prefix = results.get("seg_prefix", "")
        packed = osp.join(seg_prefix, ann["mask_packed"]) if ann.get("mask_packed") else None
        if ann.get("segmentations") is not None and self.poly2mask:
            masks = []
            for obj_polys in ann["segmentations"]:
                pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
                       for p in obj_polys or () if len(p) >= 6]
                masks.append(fill_poly(np.zeros((h, w), np.uint8), pts) if pts else np.zeros((h, w), np.uint8))
        elif packed and osp.exists(packed):
            ids = imread(packed, IMREAD_UNCHANGED)
            masks = [(ids == i + 1).astype(np.uint8) for i in ann["masks_idx"]]
        else:
            masks = [(imread(osp.join(seg_prefix, m), IMREAD_GRAYSCALE) > 0).astype(np.uint8)
                     for m in ann["masks"]]
        results["gt_masks"] = np.stack(masks, 0) if masks else np.zeros((0, h, w), np.uint8)
        return results


def rescale_size(old_wh: Tuple[int, int], scale_wh: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.rescale_size semantics: fit (w, h) into scale keeping ratio."""
    w, h = old_wh
    max_long, max_short = max(scale_wh), min(scale_wh)
    f = min(max_long / max(w, h), max_short / min(w, h))
    return int(w * f + 0.5), int(h * f + 0.5), f


def _linear_taps(dst: int, src: int):
    """cv2's INTER_LINEAR taps along one axis: source index and float32
    fraction of each output position, at (x + 0.5) * scale - 0.5 with
    scale = 1 / (dst / src)."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    return i, f - i.astype(np.float32)


def _weights(frac: np.ndarray):
    """The two taps' weights in cv2's 11-bit fixed point, each rounded half
    to even (``saturate_cast<short>``); their sum may be 2047 or 2049."""
    one = np.float32(2048)
    return (np.rint((np.float32(1) - frac) * one).astype(np.int32),
            np.rint(frac * one).astype(np.int32))


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)`` on a
    uint8 (H, W, C) image, bit for bit.

    cv2's arithmetic: an exact 2x downscale is a 2x2 box average,
    (a + b + c + d + 2) >> 2; otherwise each row is interpolated across x
    with 11-bit integer weights (exact int32 sums), and rows are blended as
    cv2's SIMD path does: ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16),
    then (+ 2) >> 2.  cv2 5.0.0 blends every column so, the last ones of a
    row whose W * C is not a multiple of its vector width included
    (tests/test_torch_distance_map.py holds this at odd widths and
    arbitrary ratios)."""
    w1, h1 = size_wh
    h0, w0 = img.shape[:2]
    x = img.reshape(h0, w0, -1).astype(np.int32)
    if (w0, h0) == (2 * w1, 2 * h1):
        out = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
        return out.astype(np.uint8).reshape((h1, w1) + img.shape[2:])
    sx, fx = _linear_taps(w1, w0)
    # columns past either edge take one tap at the edge
    fx[(sx < 0) | (sx >= w0 - 1)] = 0
    sx = np.clip(sx, 0, w0 - 1)
    a0, a1 = _weights(fx)
    rows = x[:, sx] * a0[:, None] + x[:, np.minimum(sx + 1, w0 - 1)] * a1[:, None]
    sy, fy = _linear_taps(h1, h0)
    b0, b1 = _weights(fy)  # rows past an edge keep their weights on the clamped row
    r0 = rows[np.clip(sy, 0, h0 - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h0 - 1)] >> 4
    out = ((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8).reshape((h1, w1) + img.shape[2:])


def resize_linear_f32(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh)`` (INTER_LINEAR) on a float32 (H, W) map,
    in OpenCV's own arithmetic, bit for bit: each row interpolated across x
    as s0 * (1 - fx) + s1 * fx and the rows blended as r0 * (1 - fy) + r1 *
    fy, each product and sum rounded to float32 (no fused multiply-add);
    columns past either edge take the edge, rows past an edge keep their
    weights on the clamped row; an exact 2x downscale is the 2x2 average
    ((a + b) + (c + d)) * 0.25, the last W % 4 columns ((a + b) + c) + d.

    cv2's default build sends float32 INTER_LINEAR through Intel IPP, whose
    source coordinates round otherwise: within 2e-5 of a [0, 1] map
    (tests/test_torch_distance_map.py); OpenCV's arithmetic is
    ``cv2.resize`` under ``cv2.ipp.setUseIPP(False)``."""
    w1, h1 = size_wh
    x = np.ascontiguousarray(img, np.float32)
    h0, w0 = x.shape
    if (w1, h1) == (w0, h0):
        return x.copy()
    f32 = np.float32
    if (w0, h0) == (2 * w1, 2 * h1):
        a, b, c, d = x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]
        out = ((a + b) + (c + d)) * f32(0.25)
        tail = w1 % 4
        if tail:
            out[:, w1 - tail:] = (((a + b) + c) + d)[:, w1 - tail:] * f32(0.25)
        return out
    sx, fx = _linear_taps(w1, w0)
    fx[(sx < 0) | (sx >= w0 - 1)] = 0
    sx = np.clip(sx, 0, w0 - 1)
    rows = x[:, sx] * (f32(1) - fx) + x[:, np.minimum(sx + 1, w0 - 1)] * fx
    sy, fy = _linear_taps(h1, h0)
    return (rows[np.clip(sy, 0, h0 - 1)] * (f32(1) - fy)[:, None]
            + rows[np.clip(sy + 1, 0, h0 - 1)] * fy[:, None])


def resize_nearest(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_NEAREST)``:
    source index floor(x / (dst / src)), clamped."""
    w1, h1 = size_wh
    h0, w0 = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w1) * (1.0 / (w1 / w0))).astype(np.int64), w0 - 1)
    ys = np.minimum(np.floor(np.arange(h1) * (1.0 / (h1 / h0))).astype(np.int64), h0 - 1)
    return img[ys][:, xs]


class Resize:
    """keep_ratio resize of image + boxes + masks: the image with cv2's
    ``INTER_LINEAR`` arithmetic, masks with ``INTER_NEAREST``."""

    def __init__(self, img_scale: Tuple[int, int], keep_ratio: bool = True):
        self.img_scale = tuple(img_scale)  # (w, h)
        self.keep_ratio = keep_ratio

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        img = results["img"]
        h0, w0 = img.shape[:2]
        if self.keep_ratio:
            new_w, new_h, _ = rescale_size((w0, h0), self.img_scale)
        else:
            new_w, new_h = self.img_scale
        if (new_w, new_h) != (w0, h0):
            img = resize_linear(img, (new_w, new_h))
        w_scale = new_w / w0
        h_scale = new_h / h0
        results["img"] = img
        results["img_shape"] = (new_h, new_w)
        results["scale_factor"] = np.array([w_scale, h_scale, w_scale, h_scale], np.float32)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            b = results["gt_bboxes"] * results["scale_factor"][None]
            b[:, 0::2] = b[:, 0::2].clip(0, new_w)
            b[:, 1::2] = b[:, 1::2].clip(0, new_h)
            results["gt_bboxes"] = b
        if "gt_masks" in results and len(results["gt_masks"]) and (new_w, new_h) != (w0, h0):
            results["gt_masks"] = np.stack([resize_nearest(m, (new_w, new_h)) for m in results["gt_masks"]], 0)
        return results


class RandomFlip:
    """Horizontal flip of image, boxes and masks with probability
    ``flip_ratio``, drawn as ``random.random()`` (see :func:`_generator`)."""

    def __init__(self, flip_ratio: float = 0.5, seed: Optional[int] = None):
        self.flip_ratio = flip_ratio
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if (self.rng or random).random() >= self.flip_ratio:
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


class RandomBackground:
    """With probability ``prob``, the pixels outside every GT mask come from
    a background image: one of the sorted ``*.jpg`` and ``*.png`` files of
    ``background_dir``, read as RGB and resized to the image (``cv2.resize``'s
    INTER_LINEAR, :func:`resize_linear`).  The draws are the JAX package's:
    ``random()`` against ``prob``, then ``choice`` of a file (see
    :func:`_generator`).  Decoded, resized backgrounds are kept in an LRU
    cache of ``cache_size`` entries keyed by (path, h, w)."""

    def __init__(self, background_dir: str, prob: float = 0.3, cache_size: int = 32,
                 seed: Optional[int] = None):
        self.background_dir = background_dir
        self.prob = prob
        self.files = sorted(glob.glob(osp.join(background_dir, "*.jpg"))
                            + glob.glob(osp.join(background_dir, "*.png")))
        if not self.files:
            raise RuntimeError(f"No background images found in {background_dir}")
        self.cache_size = int(cache_size)
        self.rng = _generator(seed)
        self._cache: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()  # loader threads share the cache

    def __getstate__(self):  # process workers: each starts with an empty cache
        state = dict(self.__dict__, _cache=OrderedDict())
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state, _lock=threading.Lock())

    def _background(self, path: str, h: int, w: int) -> np.ndarray:
        key = (path, h, w)
        with self._lock:
            bg = self._cache.get(key)
            if bg is not None:
                self._cache.move_to_end(key)
                return bg
        bg = imread_rgb(path)  # decoded outside the lock: threads decode in parallel
        if bg.shape[:2] != (h, w):
            bg = resize_linear(bg, (w, h))
        if self.cache_size > 0:
            with self._lock:
                self._cache[key] = bg
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
        return bg

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        if "gt_masks" not in results or not len(results["gt_masks"]):
            return results
        img = results["img"]
        h, w = img.shape[:2]
        bg = self._background(rng.choice(self.files), h, w)
        foreground = results["gt_masks"].any(axis=0)
        results["img"] = np.where(foreground[..., None], img, bg)
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


class LoadMaskFromFile:
    """Per-instance visible masks from the image path rewritten by
    ``replace_path`` (``{prefix}/rgb/x.png`` -> ``{prefix}/mask_visib/
    x_{i:06d}.png``), read as gray and divided by 255 into 0/1.  ``i`` is each
    GT's original annotation index where ``ann_info['masks']`` names one mask
    per GT (annotations may have been dropped), else 0, 1, ....  Runs after
    ``gt_bboxes`` are loaded."""

    def __init__(self, replace_path: Tuple[str, str] = ("rgb", "mask_visib")):
        self.replace_path = tuple(replace_path)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        filename = osp.join(results.get("img_prefix", ""), results["img_info"]["filename"]).replace(
            self.replace_path[0], self.replace_path[1])
        base = filename.rpartition(".")[0]
        h, w = results["img_info"]["height"], results["img_info"]["width"]
        ann_masks = (results.get("ann_info") or {}).get("masks")
        if ann_masks is not None and len(ann_masks) == len(results["gt_bboxes"]):
            orig_idx = [int(p.rpartition("_")[2].split(".")[0]) for p in ann_masks]
        else:
            orig_idx = list(range(len(results["gt_bboxes"])))
        masks = [(imread(f"{base}_{i:06d}.png", IMREAD_GRAYSCALE) // 255).astype(np.uint8) for i in orig_idx]
        results["gt_masks"] = np.stack(masks, 0) if masks else np.zeros((0, h, w), np.uint8)
        return results


class FilterAnnotations:
    """Drop the GT boxes not wider and taller than ``min_gt_bbox_wh``; None
    (the loader draws another sample) when none is left."""

    def __init__(self, min_gt_bbox_wh: Tuple[float, float]):
        self.min_gt_bbox_wh = tuple(min_gt_bbox_wh)

    def __call__(self, results: Dict[str, Any]):
        b = results["gt_bboxes"]
        keep = ((b[:, 2] - b[:, 0]) > self.min_gt_bbox_wh[0]) & ((b[:, 3] - b[:, 1]) > self.min_gt_bbox_wh[1])
        if not keep.any():
            return None
        for key in ("gt_bboxes", "gt_labels", "gt_masks", "distance_maps"):
            if key in results and len(results[key]):
                results[key] = results[key][keep]
        return results


def _filter_cropped_gt(results: Dict[str, Any], x1: int, y1: int, x2: int, y2: int, clip: bool,
                       require_gt: bool):
    """A crop's GT bookkeeping: boxes shifted into the patch (clipped to it
    with ``clip``), degenerate ones dropped with their labels and masks,
    masks cut to the patch.  None when no GT is left and ``require_gt``."""
    if "gt_bboxes" in results and len(results["gt_bboxes"]):
        b = results["gt_bboxes"] - np.array([x1, y1, x1, y1], np.float32)
        if clip:
            b[:, 0::2] = b[:, 0::2].clip(0, x2 - x1)
            b[:, 1::2] = b[:, 1::2].clip(0, y2 - y1)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        if not keep.any() and require_gt:
            return None
        results["gt_bboxes"] = b[keep]
        if "gt_labels" in results:
            results["gt_labels"] = results["gt_labels"][keep]
        if "gt_masks" in results and len(results["gt_masks"]):
            results["gt_masks"] = np.ascontiguousarray(results["gt_masks"][keep.nonzero()[0]][:, y1:y2, x1:x2])
    elif require_gt:
        return None
    return results


class RandomCrop:
    """A random crop of image, boxes and masks (mmdet's four ``crop_type``s:
    'absolute', 'absolute_range', 'relative', 'relative_range'; ``crop_size``
    is (h, w)).  A crop without GT gives None (the loader draws another
    sample) unless ``allow_negative_crop``."""

    def __init__(self, crop_size, crop_type: str = "absolute", allow_negative_crop: bool = False,
                 bbox_clip_border: bool = True, seed: Optional[int] = None):
        if crop_type not in ("relative_range", "relative", "absolute", "absolute_range"):
            raise ValueError(f"invalid crop_type {crop_type!r}")
        if crop_type in ("absolute", "absolute_range"):
            if not (crop_size[0] > 0 and crop_size[1] > 0):
                raise ValueError(f"crop_size {crop_size} must be positive for crop_type {crop_type!r}")
            if crop_type == "absolute_range" and crop_size[0] > crop_size[1]:
                raise ValueError(f"absolute_range crop_size {crop_size} must be (min, max)")
        elif not (0 < crop_size[0] <= 1 and 0 < crop_size[1] <= 1):
            raise ValueError(f"crop_size {crop_size} must lie in (0, 1] for crop_type {crop_type!r}")
        self.crop_size = tuple(crop_size)
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop
        self.bbox_clip_border = bbox_clip_border
        self.rng = _generator(seed)

    def _sample_size(self, rng, h: int, w: int) -> Tuple[int, int]:
        ch, cw = self.crop_size
        if self.crop_type == "absolute":
            return min(int(ch), h), min(int(cw), w)
        if self.crop_type == "absolute_range":
            return (rng.randint(min(h, int(ch)), min(h, int(cw))),
                    rng.randint(min(w, int(ch)), min(w, int(cw))))
        if self.crop_type == "relative":
            return int(h * ch + 0.5), int(w * cw + 0.5)
        fh = ch + rng.random() * (1 - ch)
        fw = cw + rng.random() * (1 - cw)
        return int(h * fh + 0.5), int(w * fw + 0.5)

    def __call__(self, results: Dict[str, Any]):
        rng = self.rng or random
        img = results["img"]
        h, w = img.shape[:2]
        ch, cw = self._sample_size(rng, h, w)
        y1 = rng.randint(0, max(h - ch, 0))
        x1 = rng.randint(0, max(w - cw, 0))
        y2, x2 = y1 + ch, x1 + cw
        results["img"] = np.ascontiguousarray(img[y1:y2, x1:x2])
        results["img_shape"] = results["img"].shape[:2]
        return _filter_cropped_gt(results, x1, y1, x2, y2, clip=self.bbox_clip_border,
                                  require_gt=not self.allow_negative_crop)


class MinIoURandomCrop:
    """SSD's min-IoU random crop: draw a mode from (1, *min_ious, 0) (1 keeps
    the image), then up to 50 crops of each side at least ``min_crop_size``
    of the image's and aspect within [0.5, 2], until one has IoU at least
    the mode with every GT and holds a GT's center; the GTs whose centers
    lie outside it are dropped.  Draws a new mode after 50 failures."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size: float = 0.3,
                 bbox_clip_border: bool = True, seed: Optional[int] = None):
        self.sample_modes = (1, *min_ious, 0)
        self.min_crop_size = float(min_crop_size)
        self.bbox_clip_border = bbox_clip_border
        self.rng = _generator(seed)

    @staticmethod
    def _iou_with_patch(patch: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        ix1 = np.maximum(patch[0], boxes[:, 0])
        iy1 = np.maximum(patch[1], boxes[:, 1])
        ix2 = np.minimum(patch[2], boxes[:, 2])
        iy2 = np.minimum(patch[3], boxes[:, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        area_p = (patch[2] - patch[0]) * (patch[3] - patch[1])
        return inter / np.maximum(area_b + area_p - inter, 1e-12)

    def __call__(self, results: Dict[str, Any]):
        rng = self.rng or random
        img = results["img"]
        h, w = img.shape[:2]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        while True:
            mode = rng.choice(self.sample_modes)
            if mode == 1:
                return results
            for _ in range(50):
                cw = rng.uniform(self.min_crop_size * w, w)
                ch = rng.uniform(self.min_crop_size * h, h)
                if not 0.5 <= ch / cw <= 2:
                    continue
                x1 = int(rng.uniform(0, w - cw))
                y1 = int(rng.uniform(0, h - ch))
                x2, y2 = int(x1 + cw), int(y1 + ch)
                if x2 == x1 or y2 == y1:
                    continue
                patch = np.array([x1, y1, x2, y2], np.float32)
                if len(boxes):
                    if self._iou_with_patch(patch, boxes).min() < mode:
                        continue
                    centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                    inside = ((centers[:, 0] > x1) & (centers[:, 1] > y1)
                              & (centers[:, 0] < x2) & (centers[:, 1] < y2))
                    if not inside.any():
                        continue
                    if "gt_labels" in results:
                        results["gt_labels"] = results["gt_labels"][inside]
                    if "gt_masks" in results and len(results["gt_masks"]):
                        results["gt_masks"] = np.ascontiguousarray(
                            results["gt_masks"][inside.nonzero()[0]][:, y1:y2, x1:x2])
                    b = boxes[inside].copy()
                    if self.bbox_clip_border:
                        b[:, 0::2] = b[:, 0::2].clip(x1, x2)
                        b[:, 1::2] = b[:, 1::2].clip(y1, y2)
                    results["gt_bboxes"] = b - np.array([x1, y1, x1, y1], np.float32)
                results["img"] = np.ascontiguousarray(img[y1:y2, x1:x2])
                results["img_shape"] = results["img"].shape[:2]
                return results


class Expand:
    """With probability ``prob``, the image on a ``mean``-filled canvas
    ``ratio`` (uniform in ``ratio_range``) times its size, at a random
    offset; boxes shift, masks are zero-padded."""

    def __init__(self, mean=(0, 0, 0), ratio_range=(1, 4), prob: float = 0.5, seed: Optional[int] = None):
        self.mean = tuple(float(m) for m in mean)
        self.min_ratio, self.max_ratio = ratio_range
        self.prob = prob
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        img = results["img"]
        h, w, c = img.shape
        ratio = rng.uniform(self.min_ratio, self.max_ratio)
        eh, ew = int(h * ratio), int(w * ratio)
        canvas = np.empty((eh, ew, c), img.dtype)
        canvas[...] = np.asarray(self.mean, img.dtype)
        top = int(rng.uniform(0, eh - h))
        left = int(rng.uniform(0, ew - w))
        canvas[top:top + h, left:left + w] = img
        results["img"] = canvas
        results["img_shape"] = (eh, ew)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            results["gt_bboxes"] = results["gt_bboxes"] + np.array([left, top, left, top], np.float32)
        if "gt_masks" in results and len(results["gt_masks"]):
            g = results["gt_masks"]
            out = np.zeros((g.shape[0], eh, ew), g.dtype)
            out[:, top:top + h, left:left + w] = g
            results["gt_masks"] = out
        return results


class PhotoMetricDistortion:
    """SSD's photometric distortion, each step with probability 0.5:
    brightness, contrast (before or after the HSV steps), saturation, hue,
    channel swap; in float32 on the uint8 RGB image, clipped back to uint8.
    The HSV steps convert as ``cv2.cvtColor`` does in float32
    (``color_aug.rgb_to_hsv_f32``, ``color_aug.hsv_to_rgb_f32``), and only
    when one of them fires.  The draws are the JAX package's: ``random`` (see
    :func:`_generator`), the swap's order from ``np.random.permutation`` (a
    ``RandomState(seed)`` of its own with ``seed``)."""

    def __init__(self, brightness_delta: int = 32, contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta: int = 18, seed: Optional[int] = None):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta
        self.rng = _generator(seed)
        self.np_rng = None if seed is None else np.random.RandomState(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        img = results["img"].astype(np.float32)
        if rng.random() < 0.5:
            img += rng.uniform(-self.brightness_delta, self.brightness_delta)
        contrast_last = rng.random() < 0.5
        if not contrast_last and rng.random() < 0.5:
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        sat = rng.uniform(self.saturation_lower, self.saturation_upper) if rng.random() < 0.5 else None
        hue = rng.uniform(-self.hue_delta, self.hue_delta) if rng.random() < 0.5 else None
        if sat is not None or hue is not None:
            hsv = color_aug.rgb_to_hsv_f32(img.clip(0, 255))
            if sat is not None:
                hsv[..., 1] *= sat
            if hue is not None:
                hsv[..., 0] += hue
                hsv[..., 0] %= 360
            hsv[..., 1] = hsv[..., 1].clip(0, 1)
            img = color_aug.hsv_to_rgb_f32(hsv)
        if contrast_last and rng.random() < 0.5:
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        if rng.random() < 0.5:
            img = img[..., (self.np_rng or np.random).permutation(3)]
        results["img"] = img.clip(0, 255).astype(np.uint8)
        return results


class CutOut:
    """Fill ``n_holes`` (a count or a (min, max) range) random rectangles
    with ``fill_in``; each hole's (w, h) is drawn from ``cutout_shape``, or
    from ``cutout_ratio`` times the image's (exactly one of them given)."""

    def __init__(self, n_holes, cutout_shape=None, cutout_ratio=None, fill_in=(0, 0, 0),
                 seed: Optional[int] = None):
        if (cutout_shape is None) == (cutout_ratio is None):
            raise ValueError("exactly one of cutout_shape / cutout_ratio required")
        if not isinstance(n_holes, (tuple, list)):
            n_holes = (n_holes, n_holes)
        if not 0 <= n_holes[0] <= n_holes[1]:
            raise ValueError(f"n_holes {n_holes} must be 0 <= min <= max")
        self.n_holes = tuple(n_holes)
        self.fill_in = tuple(fill_in)
        self.with_ratio = cutout_ratio is not None
        cands = cutout_ratio if self.with_ratio else cutout_shape
        self.candidates = list(cands) if isinstance(cands, list) else [cands]
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        img = results["img"]
        h, w = img.shape[:2]
        for _ in range(rng.randint(*self.n_holes)):
            x1 = rng.randrange(w)
            y1 = rng.randrange(h)
            cw, ch = rng.choice(self.candidates)
            if self.with_ratio:
                cw, ch = int(cw * w), int(ch * h)
            img[y1:min(y1 + ch, h), x1:min(x1 + cw, w)] = self.fill_in
        results["img"] = img
        return results


class RandomHSV:
    """With probability ``prob`` (``random() > prob`` skips), H, S and V of
    cv2's uint8 HSV scaled in float32 by 1 + ``uniform(-1, 1)`` times each
    ratio, each clipped (179 for H, 255 else) only when its factor is at
    least 1, truncated back to uint8 (RADet's ``color_aug.py``)."""

    def __init__(self, h_ratio: float, s_ratio: float, v_ratio: float, prob: float = 1.0, seed: Optional[int] = None):
        self.h_ratio = h_ratio
        self.s_ratio = s_ratio
        self.v_ratio = v_ratio
        self.prob = prob
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        hsv = color_aug.rgb_to_hsv_u8(results["img"]).astype(np.float32)
        a = rng.uniform(-1, 1) * self.h_ratio + 1
        b = rng.uniform(-1, 1) * self.s_ratio + 1
        c = rng.uniform(-1, 1) * self.v_ratio + 1
        hsv[:, :, 0] *= a
        hsv[:, :, 1] *= b
        hsv[:, :, 2] *= c
        if a >= 1:
            hsv[:, :, 0] = hsv[:, :, 0].clip(None, 179)
        if b >= 1:
            hsv[:, :, 1] = hsv[:, :, 1].clip(None, 255)
        if c >= 1:
            hsv[:, :, 2] = hsv[:, :, 2].clip(None, 255)
        results["img"] = color_aug.hsv_to_rgb_u8(hsv.astype(np.uint8))
        return results


class RandomNoise:
    """With probability ``prob``, additive Gaussian noise of sigma
    ``uniform(0, noise_ratio)`` times 255, in float64 from
    ``np.random.normal`` (a ``RandomState(seed)`` of its own with
    ``seed``), clipped back to uint8."""

    def __init__(self, noise_ratio: float, prob: float = 1.0, seed: Optional[int] = None):
        self.noise_ratio = noise_ratio
        self.prob = prob
        self.rng = _generator(seed)
        self.np_rng = None if seed is None else np.random.RandomState(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        img = results["img"].astype(np.float32)
        sigma = rng.uniform(0, self.noise_ratio)
        img = img + (self.np_rng or np.random).normal(0, sigma, img.shape) * 255
        results["img"] = img.clip(0, 255).astype(np.uint8)
        return results


class RandomSmooth:
    """With probability ``prob``, ``cv2.blur`` at a kernel size drawn by
    ``random.choice`` from the odd sizes up to ``max_kernel_size`` (1 leaves
    the image as it is)."""

    def __init__(self, max_kernel_size: int = 7, prob: float = 1.0, seed: Optional[int] = None):
        self.kernel_sizes = [i * 2 + 1 for i in range(max_kernel_size // 2 + 1)]
        self.prob = prob
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng or random
        if rng.random() > self.prob:
            return results
        results["img"] = color_aug.box_blur(results["img"], rng.choice(self.kernel_sizes))
        return results


class Albu:
    """A bridge to the albumentations library: a ``Compose`` of its
    transforms built from config dicts over img, gt_bboxes ('pascal_voc')
    and gt_masks.  The library is imported when the bridge is built, and
    its absence raises ``ImportError``.  With ``bbox_params``, each box's
    index rides along (``idx_mapper``) so that the masks of the boxes the
    library keeps stay aligned with them."""

    def __init__(self, transforms: Sequence[dict], bbox_params: Optional[dict] = None,
                 skip_img_without_anno: bool = False):
        try:
            import albumentations as A
        except ImportError as e:
            raise ImportError(
                "Albu requires the 'albumentations' package (not installed "
                "in this environment); use the built-in crop/photometric "
                "transforms instead"
            ) from e
        # the module is not kept on self: modules do not pickle, and process workers pickle the pipeline
        self.skip_img_without_anno = skip_img_without_anno

        def build(cfg):
            cfg = dict(cfg)
            t = getattr(A, cfg.pop("type"))
            if "transforms" in cfg:
                cfg["transforms"] = [build(c) for c in cfg["transforms"]]
            return t(**cfg)

        bp = None
        if bbox_params is not None:
            bp = A.BboxParams(format="pascal_voc", label_fields=["labels", "idx_mapper"],
                              **{k: v for k, v in bbox_params.items()
                                 if k not in ("type", "format", "label_fields", "filter_lost_elements")})
        self.aug = A.Compose([build(t) for t in transforms], bbox_params=bp)
        self.with_bboxes = bp is not None

    def __call__(self, results: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        kwargs = dict(image=results["img"])
        if self.with_bboxes:
            kwargs["bboxes"] = [tuple(b) for b in results.get("gt_bboxes", [])]
            kwargs["labels"] = list(results.get("gt_labels", []))
            kwargs["idx_mapper"] = list(range(len(kwargs["bboxes"])))
        if "gt_masks" in results and len(results["gt_masks"]):
            kwargs["masks"] = [m for m in results["gt_masks"]]
        out = self.aug(**kwargs)
        results["img"] = out["image"]
        results["img_shape"] = out["image"].shape[:2]
        if self.with_bboxes:
            boxes = np.asarray(out["bboxes"], np.float32).reshape(-1, 4)
            if not len(boxes) and self.skip_img_without_anno:
                return None
            results["gt_bboxes"] = boxes
            results["gt_labels"] = np.asarray(out["labels"], np.int64)
        if "masks" in out:
            masks = out["masks"]
            if self.with_bboxes and len(masks):
                masks = [masks[i] for i in out["idx_mapper"]]  # the masks of the boxes kept
            results["gt_masks"] = (np.stack(masks, 0) if len(masks)
                                   else np.zeros((0,) + results["img"].shape[:2], np.uint8))
        return results


class Corrupt:
    """A bridge to the imagecorruptions library's ``corrupt``, imported when
    the bridge is built; its absence raises ``ImportError``."""

    def __init__(self, corruption: str, severity: int = 1):
        try:
            from imagecorruptions import corrupt  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Corrupt requires the 'imagecorruptions' package (not "
                "installed in this environment)"
            ) from e
        self.corruption = corruption
        self.severity = severity

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        from imagecorruptions import corrupt

        results["img"] = corrupt(results["img"], corruption_name=self.corruption, severity=self.severity)
        return results


class GenerateDistanceMap:
    """With GT masks the binary visible mask is the distance map; without
    (``with_gt_mask=False``), each GT's map is estimated from its box by
    ``distance_transform`` ('gdt' or 'mbd'; ``kwargs`` are
    ``ops.distance_transform.boxes_to_distance_maps``'s), the fill colours
    of its padded crops drawn as the JAX package draws them (see
    :func:`_generator`)."""

    def __init__(self, with_gt_mask: bool = True, distance_transform: str = "gdt", seed: Optional[int] = None,
                 **kwargs):
        self.with_gt_mask = with_gt_mask
        self.distance_transform = distance_transform
        self.kwargs = kwargs
        self.rng = _generator(seed)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if self.with_gt_mask:
            results["distance_maps"] = results["gt_masks"].astype(np.float32)
            return results
        from ..ops.distance_transform import boxes_to_distance_maps  # it imports this module's resizes

        results["distance_maps"] = boxes_to_distance_maps(results["img"], results["gt_bboxes"],
                                                          method=self.distance_transform, rng=self.rng,
                                                          **self.kwargs)
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


class SegRescale:
    """Rescale ``gt_semantic_seg`` by ``scale_factor`` (new size int(dim *
    f + 0.5), ``cv2.resize``'s INTER_NEAREST: :func:`resize_nearest`); a
    no-op without that key, as on the BOP pipelines."""

    def __init__(self, scale_factor: float = 1.0, backend: str = "cv2"):
        if backend != "cv2":
            raise ValueError(f"SegRescale backend {backend!r}: cv2 only")
        self.scale_factor = float(scale_factor)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        seg = results.get("gt_semantic_seg")
        if seg is not None and self.scale_factor != 1:
            h, w = seg.shape[:2]
            size = (int(w * self.scale_factor + 0.5), int(h * self.scale_factor + 0.5))
            results["gt_semantic_seg"] = resize_nearest(seg, size)
        return results


class RandomCenterCropPad:
    """CenterNet's center crop and pad, boxes only.

    Training: up to 50 draws of a ratio of ``crop_size`` (h, w) for the
    output and a center inside the image shrunk by ``border``; the part of
    the image around that center is pasted onto a ``mean``-filled canvas
    with the two centers aligned, and the boxes whose centers fall inside it
    are kept (None when no draw keeps one: the loader draws another sample).
    Test (``test_mode``): the image padded around its center to
    ``test_pad_mode`` ('logical_or' with a mask, or 'size_divisor'), the
    border recorded.  ``mean`` is in 0-255 units (the images are uint8 RGB;
    the fill is the rounded mean) and ``to_rgb`` must be left off."""

    def __init__(self, crop_size=None, ratios=(0.9, 1.0, 1.1), border: int = 128, mean=None, std=None,
                 to_rgb=None, test_mode: bool = False, test_pad_mode=("logical_or", 127),
                 bbox_clip_border: bool = True, seed: Optional[int] = None):
        if test_mode:
            if crop_size is not None or ratios is not None or border is not None:
                raise ValueError("test_mode takes no crop_size, ratios or border (pass them as None)")
            if test_pad_mode[0] not in ("logical_or", "size_divisor"):
                raise ValueError(f"test_pad_mode {test_pad_mode[0]!r}: 'logical_or' or 'size_divisor'")
        else:
            if crop_size is None or not (crop_size[0] > 0 and crop_size[1] > 0):
                raise ValueError(f"crop_size {crop_size} must be positive in training mode")
            if test_pad_mode is not None:
                raise ValueError("test_pad_mode is test-only (pass None in training mode)")
        if to_rgb:
            raise ValueError("RandomCenterCropPad(to_rgb=True): images are RGB here; mmdet's BGR mean "
                             "reversal does not apply")
        self.crop_size = crop_size
        self.ratios = ratios
        self.border = border
        self.mean = np.asarray(mean if mean is not None else (0, 0, 0), np.float32)
        self.test_mode = test_mode
        self.test_pad_mode = test_pad_mode
        self.bbox_clip_border = bbox_clip_border
        self.rng = _generator(seed)

    @staticmethod
    def _get_border(border, size):
        """``border`` halved until the center range is not empty."""
        k = 2 * border / size
        i = pow(2, np.ceil(np.log2(np.ceil(k))) + (k == int(k)))
        return int(border // i)

    def _paste(self, img, center, size):
        """A ``mean``-filled canvas of ``size`` with the image's ``center``
        at the canvas's center: (canvas, border, patch)."""
        cy, cx = center
        th, tw = size
        h, w = img.shape[:2]
        x0, x1 = max(0, cx - tw // 2), min(cx + tw // 2, w)
        y0, y1 = max(0, cy - th // 2), min(cy + th // 2, h)
        patch = np.array((x0, y0, x1, y1))
        left, right = cx - x0, x1 - cx
        top, bottom = cy - y0, y1 - cy
        ccy, ccx = th // 2, tw // 2
        out = np.empty((th, tw, img.shape[2]), img.dtype)
        out[:] = np.round(self.mean).astype(img.dtype)
        out[ccy - top:ccy + bottom, ccx - left:ccx + right] = img[y0:y1, x0:x1]
        border = np.array([ccy - top, ccy + bottom, ccx - left, ccx + right], np.float32)
        return out, border, patch

    def __call__(self, results: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        img = results["img"]
        h, w = img.shape[:2]
        if self.test_mode:
            if self.test_pad_mode[0] == "logical_or":
                th, tw = h | self.test_pad_mode[1], w | self.test_pad_mode[1]
            else:
                d = self.test_pad_mode[1]
                th, tw = (h + d - 1) // d * d, (w + d - 1) // d * d
            out, border, _ = self._paste(img, (h // 2, w // 2), (th, tw))
            results["img"] = out
            results["img_shape"] = (h, w)
            results["pad_shape"] = (th, tw)
            results["border"] = border
            return results
        rng = self.rng or random
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        for _ in range(50):
            scale = rng.choice(self.ratios)
            new_h = int(self.crop_size[0] * scale)
            new_w = int(self.crop_size[1] * scale)
            h_border = self._get_border(self.border, h)
            w_border = self._get_border(self.border, w)
            cx = rng.randint(w_border, max(w - w_border - 1, w_border))
            cy = rng.randint(h_border, max(h - h_border - 1, h_border))
            out, border, patch = self._paste(img, (cy, cx), (new_h, new_w))
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            mask = ((centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                    & (centers[:, 0] < patch[2]) & (centers[:, 1] < patch[3]))
            if not mask.any() and len(boxes) > 0:
                continue
            results["img"] = out
            results["img_shape"] = (new_h, new_w)
            results["pad_shape"] = (new_h, new_w)
            x0, y0 = patch[0], patch[1]
            shift_x = new_w // 2 - (cx - x0) - x0
            shift_y = new_h // 2 - (cy - y0) - y0
            b = boxes[mask] + np.array([shift_x, shift_y, shift_x, shift_y], np.float32)
            if self.bbox_clip_border:
                b[:, 0::2] = b[:, 0::2].clip(0, new_w)
                b[:, 1::2] = b[:, 1::2].clip(0, new_h)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            results["gt_bboxes"] = b[keep]
            if "gt_labels" in results:
                results["gt_labels"] = results["gt_labels"][mask][keep]
            if "gt_masks" in results and len(results["gt_masks"]):  # the JAX package's assertion
                raise AssertionError("RandomCenterCropPad only supports bbox (mmdet raises the same)")
            return results
        return None


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


_TRANSFORMS = {
    "LoadImageFromFile": LoadImageFromFile,
    "LoadAnnotations": LoadAnnotations,
    "LoadMaskFromFile": LoadMaskFromFile,
    "FilterAnnotations": FilterAnnotations,
    "Resize": Resize,
    "RandomFlip": RandomFlip,
    "Pad": Pad,
    "RandomCrop": RandomCrop,
    "MinIoURandomCrop": MinIoURandomCrop,
    "Expand": Expand,
    "PhotoMetricDistortion": PhotoMetricDistortion,
    "CutOut": CutOut,
    "Albu": Albu,
    "Corrupt": Corrupt,
    "RandomBackground": RandomBackground,
    "CosyPoseAug": color_aug.CosyPoseAug,
    "RandomHSV": RandomHSV,
    "RandomNoise": RandomNoise,
    "RandomSmooth": RandomSmooth,
    "GenerateDistanceMap": GenerateDistanceMap,
    "SampleDistanceAtAnchors": SampleDistanceAtAnchors,
    "SegRescale": SegRescale,
    "RandomCenterCropPad": RandomCenterCropPad,
}

from . import auto_augment as _auto_augment  # noqa: E402  (it imports _generator from here)
from . import instaboost as _instaboost  # noqa: E402

_TRANSFORMS.update(_auto_augment.TRANSFORMS)
_TRANSFORMS["InstaBoost"] = _instaboost.InstaBoost
# formatting entries of reference pipelines: the static numpy collate does their job
_FORMATTING = ("DefaultFormatBundle", "Collect", "ImageToTensor", "ToTensor")


def build_pipeline(
    pipeline_cfg: Sequence[dict],
    *,
    input_size: Tuple[int, int] | None = None,
    anchor_centers: np.ndarray | None = None,
    max_gt: int = 32,
    img_norm: Optional[dict] = None,
) -> Compose:
    """A Compose from pipeline config dicts.

    ``Pad`` pads to the static ``input_size`` (its ``size_divisor`` must
    divide it); ``SampleDistanceAtAnchors`` and a reference
    ``LabelAssignment`` entry become the anchor-center sampler.  Entries
    whose job moved elsewhere are absorbed: ``Normalize`` (run on the
    device; checked against ``img_norm``, and ``to_rgb=False`` is refused
    since images are decoded RGB) and the formatting entries.  A
    ``MultiScaleFlipAug`` with one scale and ``flip=False`` is unwrapped,
    its scale going to the inner ``Resize``; other test-time augmentation
    raises ``ValueError`` pointing to the ``tta`` config section.
    Any other type outside ``_TRANSFORMS`` raises ``KeyError``, as in the
    JAX package; ``CosyPoseAug``'s ops (``PillowBlur``, ...) are among them,
    since they are no pipeline entries of their own."""
    ts = []

    def add(t_cfg):
        t_cfg = dict(t_cfg)
        t_type = t_cfg.pop("type")
        if t_type == "Normalize":
            if img_norm is not None:
                want = (tuple(img_norm["mean"]), tuple(img_norm["std"]))
                got = (tuple(t_cfg.get("mean", want[0])), tuple(t_cfg.get("std", want[1])))
                if not np.allclose(want, got):
                    raise ValueError(f"pipeline Normalize {got} disagrees with img_norm_cfg {want}; "
                                     "normalization on the device uses img_norm_cfg")
            if not t_cfg.get("to_rgb", True):
                raise ValueError("Normalize(to_rgb=False) unsupported: images are decoded RGB")
        elif t_type in _FORMATTING:
            pass
        elif t_type == "MultiScaleFlipAug":
            scales = t_cfg.get("img_scale")
            scales = scales if isinstance(scales, list) else [scales]
            if len(scales) != 1 or t_cfg.get("flip", False):
                raise ValueError(
                    "MultiScaleFlipAug with multiple scales or flip=True is "
                    "test-time augmentation: configure it via the `tta` "
                    "config section (apis/test.py run_tta_inference)"
                )
            for inner in t_cfg.get("transforms", []):
                if inner.get("type") == "RandomFlip":
                    continue  # flip=False: the reference applies it disabled
                if inner.get("type") == "Resize" and "img_scale" not in inner:
                    inner = dict(inner, img_scale=tuple(scales[0]))
                add(inner)
        elif t_type == "Pad" and input_size is not None:
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
        elif t_type in color_aug.OPS:
            raise KeyError(f"unknown transform {t_type}: an op of CosyPoseAug's pipelines")
        else:
            raise KeyError(f"unknown transform {t_type}")

    for t_cfg in pipeline_cfg:
        add(t_cfg)
    return Compose(ts)
