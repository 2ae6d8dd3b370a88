"""The inference steps: uint8 images in, fixed-size Detections out (port of
``radet_tpu/engine/train_step.py::build_infer_step`` for RADet and
``build_infer_step_anchor`` for the generic anchor heads)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.detector import preprocess_images
from ..models.postprocess import Detections, get_bboxes, get_bboxes_anchor


def build_infer_step(
    model,
    anchors: np.ndarray,
    level_counts,
    *,
    img_norm: Dict[str, Any],
    test_cfg: Dict[str, Any],
    normalizer: float = 1.0 / 8.0,
    rescale: bool = True,
):
    """Returns ``infer(model, images_u8, img_shapes, scale_factors) ->
    Detections`` on the device of ``model``'s parameters.

    ``images_u8`` (B, H, W, 3) uint8 RGB, ``img_shapes`` (B, 2) resized
    (h, w) and ``scale_factors`` (B, 4) may be numpy arrays or tensors on
    any device: they are staged on the model's device without waiting for
    it (from pinned memory, the copies overlap the device's work), the
    images as uint8, and normalised there.  The forward runs in
    ``model.dtype``; decode and vote-NMS in float32."""

    def postprocess(outs, level_anchors, img_shapes, scale_factors):
        return get_bboxes(*outs, level_anchors, img_shapes, scale_factors, test_cfg=test_cfg,
                          normalizer=normalizer, rescale=rescale)

    return _infer_step(model, anchors, level_counts, img_norm, postprocess)


def build_infer_step_anchor(
    model,
    anchors: np.ndarray,
    level_counts,
    *,
    img_norm: Dict[str, Any],
    test_cfg: Dict[str, Any],
    spec: Dict[str, Any],
    rescale: bool = True,
):
    """:func:`build_infer_step` for ATSSHead and AnchorHead models: the
    forward, then per level the top ``nms_pre`` anchor rows, delta decode
    and class-aware NMS (``models.postprocess.get_bboxes_anchor``).
    ``spec``: ``apis.common.anchor_head_spec`` of the config."""
    factors = spec["head_type"] == "ATSSHead"  # the centerness maps weight the scores

    def postprocess(outs, level_anchors, img_shapes, scale_factors):
        return get_bboxes_anchor(outs[0], outs[1], outs[2] if factors else None, level_anchors,
                                 img_shapes, scale_factors, spec["decode_fn"], test_cfg=test_cfg,
                                 rescale=rescale)

    return _infer_step(model, anchors, level_counts, img_norm, postprocess)


def _infer_step(model, anchors, level_counts, img_norm, postprocess):
    device = next(model.parameters()).device
    splits = np.cumsum(level_counts)[:-1]
    level_anchors = [torch.as_tensor(a, device=device) for a in np.split(anchors, splits)]
    mean = torch.tensor(img_norm["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(img_norm["std"], dtype=torch.float32, device=device)

    @torch.inference_mode()
    def infer(model, images_u8, img_shapes, scale_factors) -> Detections:
        images = torch.as_tensor(images_u8).to(device, non_blocking=True)
        if images.dtype != torch.uint8:
            raise TypeError(f"images must be uint8, got {images.dtype}")
        x = preprocess_images(images, mean, std, model.dtype)
        return postprocess(
            model(x),
            level_anchors,
            torch.as_tensor(img_shapes, dtype=torch.float32).to(device, non_blocking=True),
            torch.as_tensor(scale_factors, dtype=torch.float32).to(device, non_blocking=True),
        )

    return infer
