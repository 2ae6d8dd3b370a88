"""Host transforms of the test and training pipelines (port of the
transforms of ``radet_tpu/data/pipeline.py``, without cv2 or PIL): numpy,
with ``CosyPoseAug``'s image operations in host C++ (``color_aug``) and
polygon masks filled by ``poly.fill_poly``, each equal to cv2's output.

Each transform is a callable on a ``results`` dict (keys: img, gt_bboxes,
gt_labels, gt_masks, img_shape, scale_factor, distance_maps, dist_vals,
...).  Images stay uint8 RGB; normalization runs on the device.  The host's
only assignment work is :class:`SampleDistanceAtAnchors`: the distance-map
value of every GT at every anchor center; the assignment itself runs in the
train step.

The random transforms draw as the JAX package's do, from Python's
``random`` (``RandomBackground``, ``CosyPoseAug``, ``RandomFlip``), so that
both packages take the same decisions from the same seed; a ``seed`` gives
a transform a generator of its own.
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

_OTHER = "ROADMAP.md Queue 1 item 12, other transforms and dataset types"


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
    "Resize": Resize,
    "RandomBackground": RandomBackground,
    "CosyPoseAug": color_aug.CosyPoseAug,
    "RandomFlip": RandomFlip,
    "GenerateDistanceMap": GenerateDistanceMap,
}
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
    ``CosyPoseAug``'s ops (``PillowBlur``, ...) are no pipeline entries of
    their own and raise ``KeyError``, as in the JAX package; any other type
    besides these and ``_TRANSFORMS``' raises ``NotImplementedError``."""
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
            raise NotImplementedError(f"transform {t_type!r} is not ported ({_OTHER})")

    for t_cfg in pipeline_cfg:
        add(t_cfg)
    return Compose(ts)
