"""Programmatic inference (port of ``radet_tpu/apis/inference.py``'s
``init_detector``, ``inference_detector``, ``async_inference_detector``,
``show_result`` and ``show_result_pyplot``)."""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.image_io import imread_rgb
from ..data.pipeline import Compose, LoadImageFromFile, Pad, Resize
from ..engine.checkpoint import load_checkpoint
from ..utils.config import Config
from ..utils.visualization import imshow_det_bboxes
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


def show_result(img, result, class_names=None, score_thr=0.3, out_file=None):
    """Draw a detection result dict on an RGB image; returns the drawn BGR
    image (``utils/visualization.py::imshow_det_bboxes``)."""
    return imshow_det_bboxes(
        img,
        result["boxes"],
        result["labels"],
        result.get("scores"),
        class_names=class_names,
        score_thr=score_thr,
        out_file=out_file,
    )


def init_detector(
    config,
    checkpoint: Optional[str] = None,
    cfg_options=None,
    *,
    device="cuda",
    seed: int = 0,
) -> Detector:
    """Build the detector of ``config`` (a path or a Config) on ``device``.

    ``checkpoint``: anything :func:`engine.checkpoint.load_weights` takes
    (a ``.pth`` state dict or ``save_weights`` file, a trainer's checkpoint
    file, step directory, ``checkpoints`` root or work dir), loaded with
    ``strict=True``; None means a random init from ``seed``.  The class
    names are the config's ``data.test.classes``, else the checkpoint's
    (the trainer's ``meta.json``, else the file's ``meta["CLASSES"]``).
    ``device`` is used as given: with no GPU, pass ``device="cpu"``.
    Convolutions run in the config's ``compute_dtype`` on the card and in
    float32 on the CPU."""
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
        state_dict, ckpt_classes = load_checkpoint(checkpoint)
        model.load_state_dict(state_dict, strict=True)
        classes = classes or ckpt_classes
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


def _split_results(boxes, scores, labels, valid, n: int) -> List[Dict[str, np.ndarray]]:
    """Per-image dicts of the first ``n`` rows of numpy Detections fields;
    each array is a copy (boolean indexing)."""
    return [
        dict(boxes=boxes[i][valid[i]], scores=scores[i][valid[i]], labels=labels[i][valid[i]])
        for i in range(n)
    ]


def _gather_results(det, n: int) -> List[Dict[str, np.ndarray]]:
    return _split_results(*(t.cpu().numpy() for t in det[:4]), n)


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


async def async_inference_detector(detector: Detector, imgs):
    """:func:`inference_detector` as a coroutine: reading and resizing the
    images, the step (its launches, and on the CPU its compute) and the
    readback each run in the event loop's default executor, so the loop
    never blocks on a decode, a launch or a copy to the host."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    loop = asyncio.get_running_loop()
    batch = await loop.run_in_executor(None, _prepare_batch, detector, imgs)
    det = await loop.run_in_executor(None, detector._infer, detector.model, *batch)
    out = await loop.run_in_executor(None, _gather_results, det, len(imgs))
    return out[0] if single else out


def show_result_pyplot(
    detector,
    img,
    result,
    score_thr: float = 0.3,
    fig_size: Tuple[int, int] = (15, 10),
    title: str = "result",
    out_file: Optional[str] = None,
):
    """Render a detection result with matplotlib, shown or saved to
    ``out_file``; returns the drawn RGB image.  ``detector`` (or None)
    gives the class names; ``img`` is a path or an RGB array.  matplotlib
    is imported only here, after the drawing: where it is missing, the
    ``ImportError`` stands."""
    if isinstance(img, str):
        img = imread_rgb(img)
    class_names = tuple(getattr(detector, "classes", ()) or ()) or None
    drawn_bgr = imshow_det_bboxes(
        img,
        result["boxes"],
        result["labels"],
        result.get("scores"),
        class_names=class_names,
        score_thr=score_thr,
    )
    drawn = drawn_bgr[..., ::-1]  # BGR -> RGB for pyplot
    import matplotlib

    if out_file is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=fig_size)
    plt.imshow(drawn)
    plt.title(title)
    plt.axis("off")
    if out_file is not None:
        fig.savefig(out_file, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return drawn
