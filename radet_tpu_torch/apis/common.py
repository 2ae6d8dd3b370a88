"""Assembly helpers shared by the APIs (port of ``radet_tpu/apis/common.py``
for RADet and the generic anchor heads, ATSSHead and AnchorHead)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ..core.anchor_generator import build_anchor_generator, flat_anchors_for_input
from ..core.anchors import AnchorConfig, generate_anchors
from ..core.box_coder import build_bbox_coder
from ..data.bop import BOPDataset
from ..data.datasets_extra import DATASET_TYPES, XMLDataset
from ..data.dataset_wrappers import WRAPPERS, ClassBalancedDataset, ConcatDataset, MixDataset, RepeatDataset
from ..engine.infer_step import InferenceModule, anchor_postprocess, infer_step_of, radet_postprocess
from ..models.anchor_loss import NON_SAMPLING_LOSSES
from ..models.builder import build_detector

SAMPLERS = ("PseudoSampler", "RandomSampler", "OHEMSampler", "IoUBalancedNegSampler", "InstanceBalancedPosSampler",
            "ScoreHLRSampler", "CombinedSampler")
# CombinedSampler's component dicts, by the names core.sampler_cores takes
_COMPONENTS = {"RandomSampler": "random", "InstanceBalancedPosSampler": "instance_balanced",
               "IoUBalancedNegSampler": "iou_balanced", "OHEMSampler": "ohem"}
_SAMPLER_OPTIONS = ("floor_thr", "floor_fraction", "num_bins", "score_thr", "iou_thr", "k", "bias")


def _to_dict(x) -> Dict:
    return x.to_dict() if hasattr(x, "to_dict") else dict(x or {})


def assignment_cfg_from(cfg) -> Dict | None:
    """Label-assignment params: ``cfg.label_assignment`` when present, else
    the params of a reference in-pipeline ``LabelAssignment`` entry of the
    train pipeline (the anchor config may take strides and regress ranges
    from it)."""
    la = cfg.get("label_assignment")
    if la is not None:
        return _to_dict(la)
    try:
        pipe = cfg.data["train"]["pipeline"]
    except (KeyError, TypeError, AttributeError):
        return None
    for t_cfg in pipe or []:
        if isinstance(t_cfg, dict) and t_cfg.get("type") == "LabelAssignment":
            return {k: v for k, v in t_cfg.items() if k != "type"}
    return None


def anchor_cfg_from_model(model_cfg: Dict, label_assignment_cfg: Dict | None = None) -> AnchorConfig:
    """RADet's anchor config; the default for the generic anchor heads,
    whose pipelines place no distance samples at anchor centers."""
    head = model_cfg.get("bbox_head", {})
    if head.get("type", "RADetHead") != "RADetHead":
        return AnchorConfig()
    agen = dict(head.get("anchor_generator", {}))
    if label_assignment_cfg:
        # a reference pipeline LabelAssignment carries its own
        # anchor_generator_cfg: fill in what the head config leaves out
        for k, v in dict(label_assignment_cfg.get("anchor_generator_cfg") or {}).items():
            if k != "type":
                agen.setdefault(k, v)
        if "regress_ranges" in label_assignment_cfg:
            agen["regress_ranges"] = label_assignment_cfg["regress_ranges"]
    return AnchorConfig.from_cfg(agen)


def anchors_from_cfg(cfg, input_size=None) -> Tuple[np.ndarray, np.ndarray, list]:
    """(anchors, aux, level counts) of ``cfg``'s model at ``input_size``
    (default ``cfg.input_size``).  ``aux`` is the per-anchor regress ranges
    for RADet, the per-anchor valid flags for the generic anchor heads
    (whose anchors come from ``bbox_head.anchor_generator``, A per cell)."""
    input_size = tuple(input_size or cfg.get("input_size", (480, 640)))
    model_cfg = _to_dict(cfg.model)
    if head_type_from_cfg(model_cfg) != "RADetHead":
        gen = build_anchor_generator(dict(model_cfg["bbox_head"]["anchor_generator"]))
        return flat_anchors_for_input(gen, input_size)
    anchors, ranges, _, counts = generate_anchors(
        input_size, anchor_cfg_from_model(model_cfg, assignment_cfg_from(cfg))
    )
    return anchors, ranges, counts


def build_model_and_anchors(cfg, dtype: Any = None) -> Tuple[Any, np.ndarray, np.ndarray, list]:
    """(model, anchors, aux, level counts) for ``cfg.input_size``, ``aux``
    as :func:`anchors_from_cfg` gives it.

    ``dtype`` is the compute dtype; None reads ``cfg.compute_dtype``."""
    if dtype is None:
        dtype = cfg.get("compute_dtype", "float32")
    model = build_detector(_to_dict(cfg.model), dtype=dtype)
    return (model, *anchors_from_cfg(cfg))


def head_type_from_cfg(cfg_or_model) -> str:
    """'RADetHead' | 'ATSSHead' | 'AnchorHead' of a full config or a model
    config; other types raise."""
    model = cfg_or_model.get("model", cfg_or_model)
    head_type = model.get("bbox_head", {}).get("type", "RADetHead")
    if head_type not in ("RADetHead", "ATSSHead", "AnchorHead"):
        raise NotImplementedError(
            f"bbox_head type {head_type!r} is not ported (ROADMAP.md Queue 1 item 12, other families)"
        )
    return head_type


def anchor_head_spec(cfg) -> Dict[str, Any]:
    """What the generic anchor heads' train and inference steps need from a
    config: ``head_type``, the bbox coder's ``encode_fn``/``decode_fn``,
    ``loss_kwargs`` (assigner and losses) and ``valid_mask`` (None, or the
    (N,) anchors inside the image by ``train_cfg.allowed_border``).

    The coder and loss dicts are ``bbox_head``'s; the assigner, the
    sampler, ``allowed_border`` and ``pos_weight`` are ``train_cfg``'s
    (:func:`sampler_kwargs`)."""
    from ..ops.losses import BBOX_LOSS_FNS

    model_cfg = _to_dict(cfg.model)
    head = dict(model_cfg.get("bbox_head", {}))
    head_type = head_type_from_cfg(model_cfg)
    if head_type == "RADetHead":
        raise ValueError("anchor_head_spec is for ATSSHead and AnchorHead configs")
    encode_fn, decode_fn = build_bbox_coder(dict(head.get("bbox_coder", {"type": "DeltaXYWHBBoxCoder"})))
    train_cfg = _to_dict(cfg.get("train_cfg") or model_cfg.get("train_cfg"))
    assigner = _to_dict(train_cfg.get("assigner"))
    lcls = _to_dict(head.get("loss_cls"))
    lbox = _to_dict(head.get("loss_bbox"))
    if head_type == "ATSSHead":
        atype = assigner.get("type", "ATSSAssigner")
        if atype != "ATSSAssigner":
            raise ValueError(f"ATSSHead trains with ATSSAssigner, got {atype!r}")
        if lcls.get("type", "FocalLoss") != "FocalLoss" or not lcls.get("use_sigmoid", True):
            raise ValueError(f"ATSSHead is sigmoid-focal, got loss_cls {lcls!r}")
        btype = lbox.get("type", "GIoULoss")
        if btype not in BBOX_LOSS_FNS:
            raise ValueError(f"unsupported loss_bbox type {btype!r} (known: {sorted(BBOX_LOSS_FNS)})")
        lctr = _to_dict(head.get("loss_centerness"))
        loss_kwargs = dict(
            topk=int(assigner.get("topk", 9)),
            quality=str(head.get("quality", "centerness")),
            focal_gamma=float(lcls.get("gamma", 2.0)),
            focal_alpha=float(lcls.get("alpha", 0.25)),
            cls_loss_weight=float(lcls.get("loss_weight", 1.0)),
            bbox_loss_type=btype,
            bbox_loss_weight=float(lbox.get("loss_weight", 2.0)),
            centerness_loss_weight=float(lctr.get("loss_weight", 1.0)),
        )
    else:
        atype = assigner.get("type", "MaxIoUAssigner")
        if atype != "MaxIoUAssigner":
            raise ValueError(f"AnchorHead trains with MaxIoUAssigner, got {atype!r}")
        if float(assigner.get("ignore_iof_thr", -1)) >= 0:
            raise ValueError("MaxIoUAssigner ignore_iof_thr >= 0 (crowd-ignore regions) is not implemented")
        cls_type = lcls.get("type", "FocalLoss")
        loss_kwargs = sampler_kwargs(_to_dict(train_cfg.get("sampler")), cls_type)
        neg_iou_thr = assigner.get("neg_iou_thr", 0.4)
        loss_kwargs.update(
            pos_iou_thr=float(assigner.get("pos_iou_thr", 0.5)),
            neg_iou_thr=tuple(neg_iou_thr) if isinstance(neg_iou_thr, (list, tuple)) else float(neg_iou_thr),
            min_pos_iou=float(assigner.get("min_pos_iou", 0.0)),
            gt_max_assign_all=bool(assigner.get("gt_max_assign_all", True)),
            match_low_quality=bool(assigner.get("match_low_quality", True)),
            cls_loss=cls_type,
            focal_gamma=float(lcls.get("gamma", 2.0)),
            focal_alpha=float(lcls.get("alpha", 0.25)),
            cls_loss_weight=float(lcls.get("loss_weight", 1.0)),
            bbox_loss_type=lbox.get("type", "SmoothL1Loss"),
            bbox_loss_weight=float(lbox.get("loss_weight", 1.0)),
            smooth_l1_beta=float(lbox.get("beta", 1.0 / 9.0)),
            reg_decoded_bbox=bool(head.get("reg_decoded_bbox", False)),
            pos_weight=float(train_cfg.get("pos_weight", -1.0)),
        )

    valid_mask = None
    allowed_border = float(train_cfg.get("allowed_border", -1))
    if allowed_border >= 0:  # anchors leaving the image by more than the allowance do not train
        anchors, flags, _ = anchors_from_cfg(cfg)
        h, w = tuple(cfg.get("input_size", (480, 640)))
        valid_mask = (flags & (anchors[:, 0] >= -allowed_border) & (anchors[:, 1] >= -allowed_border)
                      & (anchors[:, 2] < w + allowed_border) & (anchors[:, 3] < h + allowed_border))
    return dict(head_type=head_type, encode_fn=encode_fn, decode_fn=decode_fn, loss_kwargs=loss_kwargs,
                valid_mask=valid_mask)


def sampler_kwargs(sampler: Dict, cls_type: str) -> Dict[str, Any]:
    """``anchor_head_loss``'s sampler kwargs of a ``train_cfg.sampler``
    dict, with the JAX package's checks (AssertionError): one of
    :data:`SAMPLERS`, PseudoSampler under a focal-family loss whatever the
    config says (mmdet's AnchorHead ignores the sampler there), no
    ``add_gt_as_proposals``; CombinedSampler's ``pos_sampler`` and
    ``neg_sampler`` dicts become component names, their options joining
    the sampler's own.  {} for the PseudoSampler."""
    stype = sampler.get("type", "PseudoSampler")
    if cls_type in NON_SAMPLING_LOSSES:
        stype = "PseudoSampler"
    if stype not in SAMPLERS:
        raise AssertionError(f"sampler {stype!r}: the full reference sampler zoo is implemented "
                             f"({', '.join(SAMPLERS)}) - core/sampler_cores.py")
    if stype == "PseudoSampler":
        return {}
    if sampler.get("add_gt_as_proposals", False):
        raise AssertionError("add_gt_as_proposals injects GT boxes into an RoI proposal list - meaningless for a "
                             "dense anchor head")
    extra = {k: sampler[k] for k in _SAMPLER_OPTIONS if k in sampler}
    for side in ("pos_sampler", "neg_sampler"):
        if side in sampler:
            sub = _to_dict(sampler[side])
            extra[side] = _COMPONENTS[sub.pop("type")]
            extra.update(sub)
    return dict(sampler_num=int(sampler.get("num", 256)), sampler_pos_fraction=float(sampler.get("pos_fraction", 0.5)),
                sampler_neg_pos_ub=float(sampler.get("neg_pos_ub", -1)), sampler_type=stype,
                sampler_extra=tuple(sorted(extra.items())))


def loss_cfg_from(cfg) -> Dict[str, Any]:
    """The ``bbox_head`` loss dicts of a config as the flat kwargs of
    ``engine.train_step.build_train_step``; raises on loss types the RADet
    head cannot honour."""
    from ..ops.losses import BBOX_LOSS_FNS

    head = cfg.model.get("bbox_head", {})
    out: Dict[str, Any] = {}
    lcls = head.get("loss_cls")
    if lcls:
        lcls = _to_dict(lcls)
        if lcls.get("type", "FocalLoss") != "FocalLoss" or not lcls.get("use_sigmoid", True):
            raise ValueError(f"unsupported loss_cls {lcls!r} (the RADet head is sigmoid-focal)")
        out["focal_gamma"] = float(lcls.get("gamma", 2.0))
        out["focal_alpha"] = float(lcls.get("alpha", 0.25))
        out["cls"] = float(lcls.get("loss_weight", 1.0))
    lbox = head.get("loss_bbox")
    if lbox:
        lbox = _to_dict(lbox)
        btype = lbox.get("type", "GIoULoss")
        if btype not in BBOX_LOSS_FNS:
            raise ValueError(f"unsupported loss_bbox type {btype!r} (known: {sorted(BBOX_LOSS_FNS)})")
        out["bbox_type"] = btype
        out["bbox"] = float(lbox.get("loss_weight", 2.0))
        extra = {k: v for k, v in lbox.items() if k not in ("type", "loss_weight", "reduction")}
        out["bbox_extra"] = tuple(sorted(extra.items()))
    liou = head.get("loss_centerness")
    if liou:
        liou = _to_dict(liou)
        if liou.get("type", "CrossEntropyLoss") != "CrossEntropyLoss" or not liou.get("use_sigmoid", True):
            raise ValueError(f"unsupported loss_centerness {liou!r} (binary CE on the IoU branch)")
        out["iou"] = float(liou.get("loss_weight", 1.0))
    return out


def normalizer_from_cfg(cfg) -> float:
    coder = cfg.model.bbox_head.get("bbox_coder")
    if coder is not None and "normalizer" in coder:
        return float(coder["normalizer"])
    return 1.0 / 8.0


def build_infer_for_cfg(cfg, model, anchors, counts, test_cfg=None):
    """The inference step of a config: RADet's (vote-NMS) or the generic
    anchor heads' (delta decode and class-aware NMS).  ``test_cfg``
    defaults to ``cfg.test_cfg``."""
    return infer_step_of(build_infer_module(cfg, model, anchors, counts, test_cfg))


def build_infer_module(cfg, model, anchors, counts, test_cfg=None) -> InferenceModule:
    """:func:`build_infer_for_cfg`'s step as one module (uint8 images,
    img_shapes and scale_factors on ``model``'s device in; boxes, scores,
    labels and valid out), as ``torch.export`` takes it."""
    test_cfg = _to_dict(cfg.test_cfg) if test_cfg is None else test_cfg
    if head_type_from_cfg(cfg) == "RADetHead":
        postprocess = radet_postprocess(test_cfg, normalizer_from_cfg(cfg))
    else:
        postprocess = anchor_postprocess(test_cfg, anchor_head_spec(cfg))
    return InferenceModule(model, anchors, counts, _to_dict(cfg.img_norm_cfg), postprocess)


def build_dataset(cfg, split: str, test_mode: bool | None = None):
    """The dataset of ``cfg.data[split]`` (test mode unless ``split`` is
    'train'): one of ``data.datasets_extra.DATASET_TYPES`` (``BOPDataset``
    by default), or a wrapper of ``data.dataset_wrappers`` over them (a
    ``ConcatDataset`` of a VOC2007 and a VOC2012 ``VOCDataset`` is mmdet's
    VOC0712 layout), whose sub-datasets take ``pipeline``,
    ``classes``, ``min_visib_frac`` and ``seg_prefix`` from the wrapper's
    section where they do not set them."""
    data_cfg = _to_dict(cfg.data[split])
    if test_mode is None:
        test_mode = split != "train"
    ds_type = data_cfg.get("type", "BOPDataset")
    if ds_type not in WRAPPERS:
        return _build_bop(cfg, data_cfg, test_mode)

    def sub(sub_cfg):
        sub_cfg = dict(sub_cfg)
        for key in ("pipeline", "classes", "min_visib_frac", "seg_prefix"):
            if key in data_cfg and key not in sub_cfg:
                sub_cfg[key] = data_cfg[key]
        return _build_bop(cfg, sub_cfg, test_mode)

    if ds_type == "MixDataset":
        return MixDataset([sub(d) for d in data_cfg["datasets"]], data_cfg["ratios"])
    if ds_type == "ConcatDataset":
        return ConcatDataset([sub(d) for d in data_cfg["datasets"]])
    if ds_type == "RepeatDataset":
        return RepeatDataset(sub(data_cfg["dataset"]), data_cfg["times"])
    return ClassBalancedDataset(sub(data_cfg["dataset"]), data_cfg["oversample_thr"])


def _build_bop(cfg, data_cfg: Dict, test_mode: bool, input_size=None) -> BOPDataset:
    """The dataset of one data section, of its ``type`` in ``DATASET_TYPES``
    (an XML dataset also takes ``min_size``); ``input_size`` overrides
    ``cfg.input_size`` (the per-orientation views of ``apis.test``)."""
    ds_type = data_cfg.get("type", "BOPDataset")
    if ds_type not in DATASET_TYPES:
        raise KeyError(f"unknown dataset type {ds_type!r}; available: {sorted(DATASET_TYPES)} plus the wrapper types")
    ds_cls = DATASET_TYPES[ds_type]
    extra = {"min_size": data_cfg["min_size"]} if issubclass(ds_cls, XMLDataset) and "min_size" in data_cfg else {}
    la_cfg = assignment_cfg_from(cfg)
    img_norm = cfg.get("img_norm_cfg")
    return ds_cls(
        ann_file=data_cfg["ann_file"],
        img_prefix=data_cfg.get("img_prefix", ""),
        seg_prefix=data_cfg.get("seg_prefix"),
        classes=data_cfg.get("classes"),
        pipeline=data_cfg["pipeline"],
        test_mode=test_mode,
        min_visib_frac=data_cfg.get("min_visib_frac", 0.0),
        bop_submission=data_cfg.get("bop_submission", False),
        input_size=tuple(input_size or cfg.get("input_size", (480, 640))),
        max_gt=int(la_cfg.get("max_gt", 32)) if la_cfg is not None else 32,
        anchor_cfg=anchor_cfg_from_model(_to_dict(cfg.model), la_cfg),
        img_norm=_to_dict(img_norm) if img_norm is not None else None,
        orientation=data_cfg.get("orientation"),
        **extra,
    )
