"""Build the RADet module from a reference-style model config dict (port of
``radet_tpu/models/builder.py::build_detector`` for the float subset the
flagship config uses: RADet + ResNet-50 + FPN + RADetHead)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .detector import RADet
from .fpn import FPN
from .radet_head import RADetHead
from .resnet import ResNet

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}

_OTHER_FAMILIES = "ROADMAP.md Queue 1 item 12, other families"
_INT8 = "ROADMAP.md Queue 1 item 14, int8 deploy family"
_TRAINING = "ROADMAP.md Queue 1 item 18, live BatchNorm and checkpointing"


def _require(ok: bool, what: str, item: str) -> None:
    if not ok:
        raise NotImplementedError(f"{what} is not ported ({item})")


def build_detector(model_cfg: Dict[str, Any], dtype: Any = None) -> RADet:
    """``dtype``: compute dtype (torch dtype or one of ``DTYPES``' names);
    None reads ``model_cfg['dtype']``, default float32."""
    cfg = dict(model_cfg)
    backbone = dict(cfg.get("backbone", {}))
    neck = dict(cfg.get("neck", {}))
    head = dict(cfg.get("bbox_head", {}))
    det_type = cfg.get("type", "RADet")
    btype = backbone.get("type", "ResNet")
    ntype = neck.get("type", "FPN")
    htype = head.get("type", "RADetHead")
    _require(det_type == "RADet", f"detector type {det_type!r}", _OTHER_FAMILIES)
    _require(btype == "ResNet", f"backbone type {btype!r}", _OTHER_FAMILIES)
    _require(ntype == "FPN", f"neck type {ntype!r}", _OTHER_FAMILIES)
    _require(htype == "RADetHead", f"bbox_head type {htype!r}", _OTHER_FAMILIES)
    for key in ("deep_stem", "avg_down", "stem_s2d"):
        _require(not backbone.get(key), f"backbone.{key}", _OTHER_FAMILIES)
    _require(backbone.get("groups", 1) == 1, "ResNeXt (backbone.groups)", _OTHER_FAMILIES)
    for key in ("quant", "qat", "frozen_int8"):
        _require(not backbone.get(key), f"backbone.{key}", _INT8)
    for key in ("quant", "qat"):
        _require(not head.get(key), f"bbox_head.{key}", _INT8)
    _require(not backbone.get("with_cp"), "backbone.with_cp (gradient checkpointing)", _TRAINING)
    if neck.get("act_cfg") is not None or neck.get("norm_cfg") is not None:
        raise ValueError("the FPN takes no act_cfg or norm_cfg")

    if dtype is None:
        dtype = cfg.get("dtype", "float32")
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]

    out_indices = tuple(backbone.get("out_indices", (0, 1, 2, 3)))
    fpn_out = neck.get("out_channels", 256)
    num_outs = neck.get("num_outs", 5)
    return RADet(
        ResNet(
            depth=backbone.get("depth", 50),
            out_indices=out_indices,
            frozen_stages=backbone.get("frozen_stages", 1),
            norm_eval=backbone.get("norm_eval", True),
        ),
        FPN(
            in_channels=neck.get("in_channels", [256 * 2**i for i in out_indices]),
            out_channels=fpn_out,
            num_outs=num_outs,
            start_level=neck.get("start_level", 1),
            add_extra_convs=neck.get("add_extra_convs", "on_output"),
            relu_before_extra_convs=neck.get("relu_before_extra_convs", False),
        ),
        RADetHead(
            num_classes=head["num_classes"],
            in_channels=fpn_out,
            feat_channels=head.get("feat_channels", 256),
            stacked_convs=head.get("stacked_convs", 4),
            num_levels=num_outs,
        ),
        dtype=dtype,
    )
