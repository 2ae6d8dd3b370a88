"""The inference steps: uint8 images in, fixed-size Detections out (port of
``radet_tpu/engine/train_step.py::build_infer_step`` for RADet and
``build_infer_step_anchor`` for the generic anchor heads), and the same step
as one ``nn.Module`` (:class:`InferenceModule`) for ``torch.export``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.detector import preprocess_images
from ..models.postprocess import Detections, get_bboxes, get_bboxes_anchor


def radet_postprocess(test_cfg: Dict[str, Any], normalizer: float = 1.0 / 8.0, rescale: bool = True):
    """RADet's decode and vote-NMS (``models.postprocess.get_bboxes``) as
    ``postprocess(head outputs, level anchors, img_shapes, scale_factors)``."""

    def postprocess(outs, level_anchors, img_shapes, scale_factors):
        return get_bboxes(*outs, level_anchors, img_shapes, scale_factors, test_cfg=test_cfg,
                          normalizer=normalizer, rescale=rescale)

    return postprocess


def anchor_postprocess(test_cfg: Dict[str, Any], spec: Dict[str, Any], rescale: bool = True):
    """The generic anchor heads' per-level top ``nms_pre`` rows, delta decode
    and class-aware NMS (``models.postprocess.get_bboxes_anchor``).
    ``spec``: ``apis.common.anchor_head_spec`` of the config."""
    factors = spec["head_type"] == "ATSSHead"  # the centerness maps weight the scores

    def postprocess(outs, level_anchors, img_shapes, scale_factors):
        return get_bboxes_anchor(outs[0], outs[1], outs[2] if factors else None, level_anchors,
                                 img_shapes, scale_factors, spec["decode_fn"], test_cfg=test_cfg,
                                 rescale=rescale)

    return postprocess


class InferenceModule(torch.nn.Module):
    """The whole inference step as one module: uint8 (B, H, W, 3) images,
    (B, 2) resized (h, w) and (B, 4) scale factors, all on the module's
    device, in; (boxes, scores, labels, valid) out.  The anchors and the
    normalisation are buffers, so ``torch.export`` keeps them in the
    exported program (``tools/export_model.py``)."""

    def __init__(self, model, anchors: np.ndarray, level_counts, img_norm: Dict[str, Any], postprocess):
        super().__init__()
        self.model = model
        self.postprocess = postprocess
        device = next(model.parameters()).device
        self.num_levels = len(level_counts)
        for i, a in enumerate(np.split(np.asarray(anchors, np.float32), np.cumsum(level_counts)[:-1])):
            self.register_buffer(f"anchors_{i}", torch.as_tensor(a, device=device))
        self.register_buffer("mean", torch.tensor(img_norm["mean"], dtype=torch.float32, device=device))
        self.register_buffer("std", torch.tensor(img_norm["std"], dtype=torch.float32, device=device))

    def detect(self, model, images_u8, img_shapes, scale_factors) -> Detections:
        """The step through ``model`` (this module's, or another with the
        same head on the same device)."""
        x = preprocess_images(images_u8, self.mean, self.std, model.dtype)
        level_anchors = [getattr(self, f"anchors_{i}") for i in range(self.num_levels)]
        return self.postprocess(model(x), level_anchors, img_shapes, scale_factors)

    def forward(self, images_u8, img_shapes, scale_factors):
        det = self.detect(self.model, images_u8, img_shapes, scale_factors)
        return det.boxes, det.scores, det.labels, det.valid


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
    return infer_step_of(InferenceModule(model, anchors, level_counts, img_norm,
                                         radet_postprocess(test_cfg, normalizer, rescale)))


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
    return infer_step_of(InferenceModule(model, anchors, level_counts, img_norm,
                                         anchor_postprocess(test_cfg, spec, rescale)))


def infer_step_of(module: InferenceModule):
    """``infer(model, images_u8, img_shapes, scale_factors) -> Detections``
    of an :class:`InferenceModule`, staging its inputs on the module's
    device (see :func:`build_infer_step`)."""
    device = module.mean.device

    @torch.inference_mode()
    def infer(model, images_u8, img_shapes, scale_factors) -> Detections:
        images = torch.as_tensor(images_u8).to(device, non_blocking=True)
        if images.dtype != torch.uint8:
            raise TypeError(f"images must be uint8, got {images.dtype}")
        return module.detect(
            model,
            images,
            torch.as_tensor(img_shapes, dtype=torch.float32).to(device, non_blocking=True),
            torch.as_tensor(scale_factors, dtype=torch.float32).to(device, non_blocking=True),
        )

    return infer
