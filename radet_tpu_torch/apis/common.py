"""Assembly helpers shared by the APIs (RADet branches of
``radet_tpu/apis/common.py``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ..core.anchors import AnchorConfig, generate_anchors
from ..data.bop import BOPDataset
from ..engine.infer_step import build_infer_step
from ..models.builder import build_detector

_OTHER_DATASETS = "ROADMAP.md Queue 1 item 12, dataset wrappers and other dataset types"


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
    head = model_cfg.get("bbox_head", {})
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
    """(anchors, regress ranges, level counts) of ``cfg``'s model at
    ``input_size`` (default ``cfg.input_size``)."""
    input_size = tuple(input_size or cfg.get("input_size", (480, 640)))
    anchors, ranges, _, counts = generate_anchors(
        input_size, anchor_cfg_from_model(_to_dict(cfg.model), assignment_cfg_from(cfg))
    )
    return anchors, ranges, counts


def build_model_and_anchors(cfg, dtype: Any = None) -> Tuple[Any, np.ndarray, np.ndarray, list]:
    """(model, anchors, regress ranges, level counts) for ``cfg.input_size``.

    ``dtype`` is the compute dtype; None reads ``cfg.compute_dtype``."""
    if dtype is None:
        dtype = cfg.get("compute_dtype", "float32")
    model = build_detector(_to_dict(cfg.model), dtype=dtype)
    return (model, *anchors_from_cfg(cfg))


def head_type_from_cfg(cfg_or_model) -> str:
    """The bbox head type of a full config or a model config; only
    'RADetHead' is ported."""
    model = cfg_or_model.get("model", cfg_or_model)
    head_type = model.get("bbox_head", {}).get("type", "RADetHead")
    if head_type != "RADetHead":
        raise NotImplementedError(
            f"bbox_head type {head_type!r} is not ported (ROADMAP.md Queue 1 item 12, other families)"
        )
    return head_type


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


def build_infer_for_cfg(cfg, model, anchors, counts):
    """The inference step of a RADet config (vote-NMS postprocess)."""
    return build_infer_step(
        model,
        anchors,
        counts,
        img_norm=_to_dict(cfg.img_norm_cfg),
        test_cfg=_to_dict(cfg.test_cfg),
        normalizer=normalizer_from_cfg(cfg),
    )


def build_dataset(cfg, split: str, test_mode: bool | None = None) -> BOPDataset:
    """The dataset of ``cfg.data[split]`` (test mode unless ``split`` is
    'train')."""
    data_cfg = _to_dict(cfg.data[split])
    if test_mode is None:
        test_mode = split != "train"
    return _build_bop(cfg, data_cfg, test_mode)


def _build_bop(cfg, data_cfg: Dict, test_mode: bool, input_size=None) -> BOPDataset:
    """A ``BOPDataset`` from one data section; ``input_size`` overrides
    ``cfg.input_size`` (the per-orientation views of ``apis.test``)."""
    ds_type = data_cfg.get("type", "BOPDataset")
    if ds_type != "BOPDataset":
        raise NotImplementedError(f"dataset type {ds_type!r} is not ported ({_OTHER_DATASETS})")
    la_cfg = assignment_cfg_from(cfg)
    img_norm = cfg.get("img_norm_cfg")
    return BOPDataset(
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
    )
