"""Programmatic inference (port of ``radet_tpu/apis/inference.py``'s
``init_detector`` / ``inference_detector``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.pipeline import Compose, LoadImageFromFile, Pad, Resize
from ..utils.config import Config
from .common import build_infer_for_cfg, build_model_and_anchors


class Detector:
    """Bundled (config, model on its device, inference step) handle."""

    def __init__(self, cfg, model, anchors, level_counts, classes=()):
        self.cfg = cfg
        self.model = model
        self.anchors = anchors
        self.level_counts = level_counts
        self.input_size = tuple(cfg.get("input_size", (480, 640)))
        self.classes = tuple(classes)
        self._infer = build_infer_for_cfg(cfg, model, anchors, level_counts)


def init_detector(
    config,
    checkpoint: Optional[str] = None,
    cfg_options=None,
    *,
    device="cuda",
    seed: int = 0,
) -> Detector:
    """Build the detector of ``config`` (a path or a Config) on ``device``.

    ``checkpoint``: a torch ``.pth`` holding an mmdet-named state dict, or
    ``{"state_dict": ...}``, loaded with ``strict=True``; None means a random
    init from ``seed``.  ``device`` is used as given: with no GPU, pass
    ``device="cpu"``.  Convolutions run in the config's ``compute_dtype`` on
    the card and in float32 on the CPU."""
    cfg = config if isinstance(config, Config) else Config.fromfile(config, cfg_options)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    dtype = None if device.type == "cuda" else "float32"
    model, anchors, _, counts = build_model_and_anchors(cfg, dtype=dtype)
    classes = tuple(cfg.data.test.get("classes", ()) or ()) if "data" in cfg else ()
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        state_dict = ckpt.get("state_dict", ckpt)
        model.load_state_dict(state_dict, strict=True)
        classes = classes or tuple((ckpt.get("meta") or {}).get("CLASSES", ()) or ())
    model.to(device).eval()
    return Detector(cfg, model, anchors, counts, classes)


def _prepare_batch(detector: Detector, imgs):
    """Images (RGB uint8 arrays of any size, or file paths) through
    ``LoadImageFromFile``, a keep-ratio ``Resize`` into the input size and
    ``Pad`` to it.  Returns (images (B, H, W, 3) uint8, img_shapes (B, 2),
    scale_factors (B, 4))."""
    h, w = detector.input_size
    resize_pad = Compose([Resize(img_scale=(w, h), keep_ratio=True), Pad(size=(h, w))])
    batch_imgs, shapes, scales = [], [], []
    for im in imgs:
        if isinstance(im, str):
            results = LoadImageFromFile()(dict(img_info=dict(filename=im)))
        elif not isinstance(im, np.ndarray) or im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError("images are RGB uint8 (H, W, 3) arrays or file paths, got "
                             + (f"{im.dtype} {im.shape}" if isinstance(im, np.ndarray) else type(im).__name__))
        else:
            results = dict(img=im, img_shape=im.shape[:2], ori_shape=im.shape[:2],
                           scale_factor=np.ones(4, np.float32))
        results = resize_pad(results)
        batch_imgs.append(results["img"])
        shapes.append(np.asarray(results["img_shape"], np.float32))
        scales.append(results["scale_factor"])
    return np.stack(batch_imgs), np.stack(shapes), np.stack(scales)


def _gather_results(det, n: int) -> List[Dict[str, np.ndarray]]:
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det[:4])
    return [
        dict(boxes=boxes[i][valid[i]], scores=scores[i][valid[i]], labels=labels[i][valid[i]])
        for i in range(n)
    ]


def inference_detector(detector: Detector, imgs):
    """Detect on one image (RGB uint8 ndarray of any size, or a file path)
    or a list of them; boxes are in the original image's coordinates.

    Returns per-image dicts {boxes (M, 4) xyxy, scores (M,), labels (M,)}
    of numpy arrays (one dict for a single image)."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    det = detector._infer(detector.model, *_prepare_batch(detector, imgs))
    out = _gather_results(det, len(imgs))
    return out[0] if single else out
