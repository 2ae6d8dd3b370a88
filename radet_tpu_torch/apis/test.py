"""Batched dataset inference and COCO evaluation on one device (port of
``radet_tpu/apis/test.py``; the engine of the test CLI,
``python -m radet_tpu_torch.tools.test``).

:func:`run_inference` keeps the host and the device busy at once: each
batch's detections are copied to pinned host memory right behind its
compute, and the host converts batch i - 1's detections while the device
runs batch i and the loader's threads decode the next images.  uint8
batches are staged from pinned memory with ``non_blocking``.  Eager PyTorch
needs no static batch, so the final partial batch runs at its own size.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..data.loader import DataLoader
from ..engine.infer_step import build_infer_step
from ..evaluation.coco_eval import COCOEvaluator
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

_TTA = "ROADMAP.md Queue 1 item 12, TTA"
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
) -> List[dict]:
    """Per-image detection dicts {boxes (M, 4), scores, labels, img_id} of
    ``model`` (on its device; in eval mode for the run, so that live
    BatchNorm uses its running statistics, and back in its mode after it)
    over ``dataset``, loaded by ``num_workers`` threads (the config's
    ``data.workers_per_gpu``).

    ``infer_step``: a step from ``apis.common.build_infer_for_cfg`` to use
    (periodic eval builds it once); without it, RADet's step of
    ``engine.infer_step.build_infer_step``."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(f"evaluation across processes is not ported ({_MULTI_GPU})")
    logger = get_root_logger()
    infer = infer_step or build_infer_step(
        model, anchors, level_counts, img_norm=img_norm, test_cfg=test_cfg, normalizer=normalizer,
    )
    cuda = next(model.parameters()).device.type == "cuda"
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, num_workers=num_workers,
                        drop_last=False, infinite=False)
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

    pending = None
    training = model.training
    model.eval()
    try:
        for bi, batch in enumerate(loader):
            staged = [torch.from_numpy(batch[k]) for k in ("image", "img_shape", "scale_factor")]
            if cuda:
                staged = [t.pin_memory() for t in staged]
            det = infer(model, *staged)
            host = [t.to("cpu", non_blocking=True) for t in (det.boxes, det.scores, det.labels, det.valid)]
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
            if pending is not None:
                drain(*pending)
            pending = (host, ready, batch["img_id"])
            if (bi + 1) % LOG_INTERVAL == 0:
                ips = max(n_images, 1) / (time.time() - t_start)
                logger.info(f"inference: {n_images}/{len(dataset)} images ({ips:.1f} img/s)")
    finally:
        model.train(training)
    if pending is not None:
        drain(*pending)
    dt = time.time() - t_start
    if n_images:
        logger.info(f"inference done: {n_images} images in {dt:.1f}s ({n_images / dt:.1f} img/s), "
                    f"vote_nms kernel launches {vote_nms_cuda.LAUNCHES - launches[0]}, "
                    f"batched_nms kernel launches {vote_nms_cuda.NMS_LAUNCHES - launches[1]}, "
                    f"int8_conv kernel launches {int8_conv_cuda.LAUNCHES - launches[2]}")
    return results


def evaluate_results(dataset, results: List[dict], *, classwise: bool = False) -> Dict[str, float]:
    """COCO bbox metrics of ``results`` on ``dataset`` (keys ``bbox_mAP``,
    ``bbox_mAP_50``, ...); ``classwise`` adds ``bbox_AP_<class>``."""
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
    ATSSHead and AnchorHead configs run single-scale."""
    head_type_from_cfg(cfg)
    batch_size = batch_size or int(cfg.data.get("samples_per_gpu", 8))
    test_cfg = cfg.test_cfg.to_dict()
    if strict:
        test_cfg = strict_eval_overrides(test_cfg)
    if (test_cfg.get("tta") or {}).get("scales") or test_cfg.get("flip_tta"):
        raise NotImplementedError(f"test_cfg.tta / flip_tta is not ported ({_TTA})")
    dataset = build_dataset(cfg, split)
    common = dict(img_norm=cfg.img_norm_cfg.to_dict(), test_cfg=test_cfg, batch_size=batch_size,
                  num_workers=int(cfg.data.get("workers_per_gpu", 8)), normalizer=normalizer_from_cfg(cfg))

    def infer(anchors, counts):
        return build_infer_for_cfg(cfg, model, anchors, counts, test_cfg=test_cfg)

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
    if fmt_only:
        return dataset, results, None
    return dataset, results, evaluate_results(
        dataset, results, classwise=bool((eval_options or {}).get("classwise", False))
    )
