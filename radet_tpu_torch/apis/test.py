"""Batched dataset inference and COCO evaluation on one device (port of
``radet_tpu/apis/test.py``; the engine of the test CLI,
``python -m radet_tpu_torch.tools.test``).

:func:`run_inference` keeps the host and the device busy at once: each
batch's detections are copied to pinned host memory right behind its
compute, and the host converts batch i - 1's detections while the device
runs batch i and the loader's threads decode the next images.  uint8
batches are staged from pinned memory with ``non_blocking``.  Eager PyTorch
needs no static batch, so the final partial batch runs at its own size.

Test-time augmentation (``test_cfg.flip_tta``; ``test_cfg.tta`` with
``scales`` and ``flip``) runs each view's inference step on the card, the
horizontal flip of a batch included, and fuses each batch's views with one
vote-NMS call (``models/postprocess.py::vote_fuse``): the JAX package fuses
them image by image on the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.loader import DataLoader
from ..engine.infer_step import build_infer_step
from ..evaluation.coco_eval import COCOEvaluator
from ..models.postprocess import vote_fuse
from ..ops import int8_conv_cuda, vote_nms_cuda
from ..utils.logging import get_root_logger
from .common import (
    _build_bop,
    _to_dict,
    anchors_from_cfg,
    build_dataset,
    build_infer_for_cfg,
    head_type_from_cfg,
    normalizer_from_cfg,
)

_MULTI_GPU = "ROADMAP.md Queue 1 item 13, multi-GPU eval gather"
LOG_INTERVAL = 50  # batches between progress lines


def strict_eval_overrides(test_cfg: Dict) -> Dict:
    """The reference's candidate semantics for evaluation and export:
    per-level exact top-``nms_pre``, and ``nms_topk`` raised to at least
    2048, a cluster-score cap that binds only on scenes far beyond the BOP
    datasets.  The deploy default is one global top-k straight down to
    ``nms_topk``."""
    out = dict(test_cfg)
    out["candidate_mode"] = "per_level"
    out["approx_topk"] = False
    out["nms_topk"] = max(int(out.get("nms_topk", 1024)), 2048)
    return out


def run_inference(
    model,
    dataset,
    *,
    anchors,
    level_counts,
    img_norm: Dict,
    test_cfg: Dict,
    batch_size: int,
    num_workers: int,
    normalizer: float = 1.0 / 8.0,
    infer_step=None,
    aug_flip: bool = False,
) -> List[dict]:
    """Per-image detection dicts {boxes (M, 4), scores, labels, img_id} of
    ``model`` (on its device; in eval mode for the run, so that live
    BatchNorm uses its running statistics, and back in its mode after it)
    over ``dataset``, loaded by ``num_workers`` threads (the config's
    ``data.workers_per_gpu``).

    ``infer_step``: a step from ``apis.common.build_infer_for_cfg`` to use
    (periodic eval builds it once); without it, RADet's step of
    ``engine.infer_step.build_infer_step``.  ``aug_flip``: horizontal-flip
    test-time augmentation, each batch's detections fused with those of
    its flipped images (:func:`run_tta_inference` with one view)."""
    infer = infer_step or build_infer_step(
        model, anchors, level_counts, img_norm=img_norm, test_cfg=test_cfg, normalizer=normalizer,
    )
    return _run_views(model, [dataset], [infer], test_cfg=test_cfg, batch_size=batch_size,
                      num_workers=num_workers, flip=aug_flip, fuse=aug_flip)


def tta_padded_size(scale_wh, size_divisor: int = 32):
    """Static padded (h, w) for a keep-ratio resize into ``scale_wh=(w, h)``:
    the resize fits within the scale box, so ceil(scale / divisor) bounds
    it.  Each scale's dataset view pads every sample to exactly this size,
    so its anchors and level counts match its samples' shapes."""
    w, h = scale_wh
    d = size_divisor
    return ((h + d - 1) // d * d, (w + d - 1) // d * d)


def run_tta_inference(
    model,
    datasets: Sequence,
    *,
    infer_steps: Sequence,
    test_cfg: Dict,
    batch_size: int,
    num_workers: int,
    flip: bool = False,
) -> List[dict]:
    """Multi-scale (+flip) test-time augmentation (port of the JAX package's
    ``run_tta_inference``): ``datasets`` holds one static-size view of the
    same images per scale, ``infer_steps`` each view's step (its own
    anchors).  The views step through the data in lockstep; with ``flip``
    each view's batch runs flipped too; every view's detections come back
    in original image coordinates, and each batch's are fused by one
    vote-NMS call (``models/postprocess.py::vote_fuse``).  Returns
    :func:`run_inference`'s per-image dicts."""
    return _run_views(model, datasets, infer_steps, test_cfg=test_cfg, batch_size=batch_size,
                      num_workers=num_workers, flip=flip, fuse=True)


def flip_images(images, img_shapes):
    """(B, H, W, C) images, each flipped horizontally within its valid
    (unpadded) width ``img_shapes[:, 1]``; the padding stays where it is."""
    cols = torch.arange(images.shape[2], device=images.device)
    width = img_shapes[:, 1].long()[:, None]
    src = torch.where(cols < width, width - 1 - cols, cols)  # (B, W)
    return torch.gather(images, 2, src[:, None, :, None].expand(images.shape))


def unflip_boxes(boxes, img_shapes, scale_factors):
    """(B, M, 4) boxes of flipped images, in original image coordinates,
    mirrored back: the axis is the original width, ``w_resized / w_scale``."""
    w_ori = (img_shapes[:, 1] / torch.clamp(scale_factors[:, 0], min=1e-12))[:, None]
    return torch.stack([w_ori - boxes[..., 2], boxes[..., 1], w_ori - boxes[..., 0], boxes[..., 3]], dim=-1)


def _run_views(model, datasets, infers, *, test_cfg: Dict, batch_size: int, num_workers: int, flip: bool,
               fuse: bool) -> List[dict]:
    """The inference loop of :func:`run_inference` and
    :func:`run_tta_inference`: one step per view (and per flipped view),
    the views fused when ``fuse``."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(f"evaluation across processes is not ported ({_MULTI_GPU})")
    logger = get_root_logger()
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    loaders = [DataLoader(ds, batch_size=batch_size, shuffle=False, num_workers=num_workers, drop_last=False,
                          infinite=False) for ds in datasets]
    results: List[dict] = []
    n_images = 0
    launches = vote_nms_cuda.LAUNCHES, vote_nms_cuda.NMS_LAUNCHES, int8_conv_cuda.LAUNCHES
    t_start = time.time()

    def drain(host, ready, img_ids):
        nonlocal n_images
        if ready is not None:
            ready.synchronize()  # this batch's copies, not the batch running behind it
        boxes, scores, labels, valid = (t.numpy() for t in host)
        for i, img_id in enumerate(img_ids):
            keep = valid[i]
            results.append(dict(boxes=boxes[i][keep], scores=scores[i][keep], labels=labels[i][keep],
                                img_id=int(img_id)))
        n_images += len(img_ids)

    def views(infer, batch):
        staged = [torch.from_numpy(batch[k]) for k in ("image", "img_shape", "scale_factor")]
        if cuda:
            staged = [t.pin_memory() for t in staged]
        if not flip:
            return [infer(model, *staged)]
        images, shapes, scales = (t.to(device, non_blocking=True) for t in staged)
        det_f = infer(model, flip_images(images, shapes), shapes, scales)
        return [infer(model, images, shapes, scales),
                det_f._replace(boxes=unflip_boxes(det_f.boxes, shapes, scales))]

    pending = None
    training = model.training
    model.eval()
    try:
        for bi, batches in enumerate(zip(*loaders)):
            img_ids = batches[0]["img_id"]
            if any(not np.array_equal(b["img_id"], img_ids) for b in batches[1:]):
                raise RuntimeError("test-time augmentation's dataset views are out of lockstep")
            with torch.inference_mode():
                dets = [d for infer, batch in zip(infers, batches) for d in views(infer, batch)]
                det = vote_fuse(dets, test_cfg) if fuse else dets[0]
            host = [t.to("cpu", non_blocking=True) for t in (det.boxes, det.scores, det.labels, det.valid)]
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
            if pending is not None:
                drain(*pending)
            pending = (host, ready, img_ids)
            if (bi + 1) % LOG_INTERVAL == 0:
                ips = max(n_images, 1) / (time.time() - t_start)
                logger.info(f"inference: {n_images}/{len(datasets[0])} images ({ips:.1f} img/s)")
    finally:
        model.train(training)
    if pending is not None:
        drain(*pending)
    dt = time.time() - t_start
    if n_images:
        aug = f" x {len(datasets)} scales" if len(datasets) > 1 else ""
        aug += " x flip" if flip else ""
        logger.info(f"inference done: {n_images} images{aug} in {dt:.1f}s ({n_images / dt:.1f} img/s), "
                    f"vote_nms kernel launches {vote_nms_cuda.LAUNCHES - launches[0]}, "
                    f"batched_nms kernel launches {vote_nms_cuda.NMS_LAUNCHES - launches[1]}, "
                    f"int8_conv kernel launches {int8_conv_cuda.LAUNCHES - launches[2]}")
    return results


def evaluate_results(dataset, results: List[dict], *, classwise: bool = False) -> Dict[str, float]:
    """COCO bbox metrics of ``results`` on ``dataset`` (keys ``bbox_mAP``,
    ``bbox_mAP_50``, ...); ``classwise`` adds ``bbox_AP_<class>``.

    A dataset with a protocol of its own (``VOCDataset``'s mean AP, keys
    ``AP50`` and ``mAP``; ``LVISV1Dataset``'s federated protocol) evaluates
    through its ``evaluate``; a dataset's ``EVAL_DEFAULTS`` may force
    ``classwise`` (``KittiDataset``)."""
    if hasattr(type(dataset), "evaluate"):
        return dataset.evaluate(results, classwise=classwise)
    classwise = getattr(dataset, "EVAL_DEFAULTS", {}).get("classwise", classwise)
    evaluator = COCOEvaluator(dataset.coco, cat_ids=dataset.cat_ids, img_ids=dataset.img_ids)
    out = {f"bbox_{k}": v for k, v in evaluator.evaluate(dataset.det2json(results)).items()}
    if classwise:
        out.update({f"bbox_AP_{name}": ap for name, ap in evaluator.classwise_ap().items()})
    return out


def test_from_config(
    cfg,
    model,
    *,
    split: str = "test",
    batch_size: Optional[int] = None,
    fmt_only: bool = False,
    strict: bool = True,
    eval_options: Optional[Dict] = None,
):
    """Config-driven test: inference of ``model`` (on its device, in eval
    mode) over ``cfg.data[split]``, then COCO evaluation unless
    ``fmt_only``.  Returns (dataset, results, metrics or None).

    ``strict`` (default) runs the reference's candidate semantics
    (:func:`strict_eval_overrides`); ``strict=False`` the deploy path.  A
    dataset whose images disagree with ``cfg.input_size``'s orientation
    runs as one view per orientation, each at its own static size.

    Test-time augmentation: ``test_cfg.flip_tta`` fuses each image's
    detections with its horizontal flip's, on every head; ``test_cfg.tta``
    with ``scales`` (a list of (w, h)) runs one view of the data per
    scale, each resized into its scale and padded to
    :func:`tta_padded_size`, with ``tta.flip`` each view flipped too, and
    fuses them all (RADet only, as in the JAX package; the orientation
    views do not apply and ``flip_tta`` is not read)."""
    head_type = head_type_from_cfg(cfg)
    batch_size = batch_size or int(cfg.data.get("samples_per_gpu", 8))
    test_cfg = cfg.test_cfg.to_dict()
    if strict:
        test_cfg = strict_eval_overrides(test_cfg)
    num_workers = int(cfg.data.get("workers_per_gpu", 8))

    def infer(anchors, counts):
        return build_infer_for_cfg(cfg, model, anchors, counts, test_cfg=test_cfg)

    def finish(dataset, results):
        if fmt_only:
            return dataset, results, None
        return dataset, results, evaluate_results(
            dataset, results, classwise=bool((eval_options or {}).get("classwise", False))
        )

    tta = test_cfg.get("tta") or {}
    if tta.get("scales"):
        if head_type != "RADetHead":  # the JAX package's assertion, kept under python -O
            raise AssertionError(
                "the `tta` config section drives the RADet vote-fuse TTA path; "
                "ATSSHead/AnchorHead models use single-scale inference "
                "(the reference's aug_test for them is an unreached mixin)"
            )
        data_cfg = _to_dict(cfg.data[split])
        pipe = data_cfg["pipeline"]
        divisor = next((t.get("size_divisor", 32) for t in pipe if t["type"] == "Pad"), 32)
        datasets, steps = [], []
        for scale in tta["scales"]:
            scale = tuple(scale)  # (w, h)
            size = tta_padded_size(scale, divisor)
            pipe_s = [dict(t, img_scale=scale) if t["type"] == "Resize" else dict(t) for t in pipe]
            datasets.append(_build_bop(cfg, dict(data_cfg, pipeline=pipe_s), True, input_size=size))
            anchors, _, counts = anchors_from_cfg(cfg, size)
            steps.append(infer(anchors, counts))
        results = run_tta_inference(model, datasets, infer_steps=steps, test_cfg=test_cfg, batch_size=batch_size,
                                    num_workers=num_workers, flip=bool(tta.get("flip", False)))
        return finish(datasets[0], results)

    dataset = build_dataset(cfg, split)
    common = dict(img_norm=cfg.img_norm_cfg.to_dict(), test_cfg=test_cfg, batch_size=batch_size,
                  num_workers=num_workers, normalizer=normalizer_from_cfg(cfg),
                  aug_flip=bool(cfg.test_cfg.get("flip_tta", False)))

    h0, w0 = tuple(cfg.get("input_size", (480, 640)))
    has_portrait = any(i["height"] > i["width"] for i in dataset.data_infos)
    has_landscape = any(i["height"] < i["width"] for i in dataset.data_infos)
    if (has_portrait and w0 > h0) or (has_landscape and h0 > w0):
        # an image of the other orientation would overflow the static pad
        # target after its keep-ratio resize: one view per orientation
        base = (min(h0, w0), max(h0, w0))
        data_cfg = _to_dict(cfg.data[split])
        results = []
        for orient, size in (("landscape", base), ("portrait", base[::-1])):
            view = _build_bop(cfg, dict(data_cfg, orientation=orient), True, input_size=size)
            if len(view):
                anchors, _, counts = anchors_from_cfg(cfg, size)
                results += run_inference(model, view, anchors=anchors, level_counts=counts,
                                         infer_step=infer(anchors, counts), **common)
    else:
        anchors, _, counts = anchors_from_cfg(cfg)
        results = run_inference(model, dataset, anchors=anchors, level_counts=counts,
                                infer_step=infer(anchors, counts), **common)
    return finish(dataset, results)
