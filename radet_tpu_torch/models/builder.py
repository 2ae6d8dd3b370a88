"""Build a detector module from a reference-style model config dict (port of
``radet_tpu/models/builder.py`` for its backbone zoo + FPN subset): RADet
with RADetHead, and SingleStageDetector with ATSSHead or AnchorHead, over
ResNet (depths 18-152), ResNetV1d, ResNeXt, Res2Net, ResNeSt or RegNet;
with the int8 deploy options ``backbone.quant`` and ``bbox_head.quant``
and ``qat`` (quantization-aware training), and ``frozen_int8`` (the
frozen stem and stages on the int8 deploy arithmetic in training)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.anchor_generator import build_anchor_generator
from .anchor_heads import AnchorHead, ATSSHead
from .detector import RADet, SingleStageDetector
from .fpn import FPN
from .radet_head import RADetHead
from .resnet import QUANT_LEVELS, RegNet, ResNet

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}

_OTHER_FAMILIES = "ROADMAP.md Queue 1 item 12, other families"


def _require(ok: bool, what: str, item: str) -> None:
    if not ok:
        raise NotImplementedError(f"{what} is not ported ({item})")


def head_spec_from_cfg(head: Dict[str, Any]) -> Dict[str, Any]:
    """(head_type, num_base_anchors, use_sigmoid) of a bbox_head config.

    The generic heads carry their anchor generator in the config, with the
    same number of base anchors on every level."""
    head_type = head.get("type", "RADetHead")
    if head_type == "RADetHead":
        return dict(head_type=head_type, num_base_anchors=1, use_sigmoid=True)
    _require(head_type in ("ATSSHead", "AnchorHead"), f"bbox_head type {head_type!r}", _OTHER_FAMILIES)
    if head.get("anchor_generator") is None:
        raise ValueError(f"{head_type} requires bbox_head.anchor_generator")
    nba = build_anchor_generator(dict(head["anchor_generator"])).num_base_anchors
    if len(set(nba)) != 1:
        raise ValueError(f"per-level anchor counts must be uniform for {head_type}, got {nba}")
    use_sigmoid = bool(dict(head.get("loss_cls") or {}).get("use_sigmoid", True))
    return dict(head_type=head_type, num_base_anchors=nba[0], use_sigmoid=use_sigmoid)


_BACKBONES = ("ResNet", "ResNetV1d", "ResNeXt", "Res2Net", "ResNeSt", "RegNet")


def _backbone_quant(backbone: Dict[str, Any], btype: str):
    """``backbone.quant``, with the JAX builder's conditions (AssertionError):
    one of ``QUANT_LEVELS``, on the ResNet/ResNeXt trunk ('int8_stream':
    not ResNetV1d, whose deep stem and avg-down it cannot carry)."""
    q = backbone.get("quant", None)
    if q is None:
        return None
    if q not in QUANT_LEVELS:
        raise AssertionError(f"backbone.quant: unsupported {q!r} (None | 'int8' | 'int8_conv2' | 'int8_stream')")
    if btype not in ("ResNet", "ResNetV1d", "ResNeXt"):
        raise AssertionError(f"backbone.quant='int8' is implemented for the ResNet/ResNeXt trunk, not {btype}")
    if q == "int8_stream" and btype not in ("ResNet", "ResNeXt"):
        raise AssertionError("backbone.quant='int8_stream' needs the plain 7x7 stem and strided 1x1 downsample "
                             "(V1d's deep_stem/avg_down: use 'int8')")
    return q


def _check_head_qat(head: Dict[str, Any], head_type: str) -> None:
    """The JAX builder's fail-fast conditions on ``bbox_head.qat`` (AssertionError)."""
    if head.get("qat"):
        if head_type != "RADetHead":
            raise AssertionError(f"bbox_head.qat is implemented for RADetHead's tower, not {head_type}")
        if head.get("quant") != "int8":
            raise AssertionError("bbox_head.qat needs quant='int8'")


def _check_backbone_int8(backbone: Dict[str, Any]) -> None:
    """The JAX builder's fail-fast conditions on ``backbone.qat`` and
    ``frozen_int8`` (AssertionError)."""
    if backbone.get("qat") and not backbone.get("quant"):
        raise AssertionError("backbone.qat needs a backbone.quant level")
    if backbone.get("frozen_int8"):
        if backbone.get("quant") is not None or backbone.get("qat"):
            raise AssertionError("backbone.frozen_int8 is the float-training lever; quant/qat configs already "
                                 "quantize their own forward")
        if backbone.get("type", "ResNet") not in ("ResNet", "ResNeXt"):
            raise AssertionError("backbone.frozen_int8 reuses the int8_stream deploy path (plain 7x7-stem "
                                 "Bottleneck trunks only)")
        if backbone.get("frozen_stages", 1) < 0:
            raise AssertionError("backbone.frozen_int8 quantizes the frozen prefix: it needs frozen_stages >= 0")
_EXTRA_BACKBONES = ("Darknet", "HRNet", "SSDVGG", "DetectoRS_ResNet", "DetectoRS_ResNeXt")


def build_backbone(backbone: Dict[str, Any]):
    """The backbone of a ``model.backbone`` config, with the JAX builder's
    defaults: ``deep_stem`` and ``avg_down`` on for ResNetV1d, Res2Net and
    ResNeSt; ``groups`` read for ResNeXt and ResNeSt only; ``base_width``
    26 for Res2Net, else 4; ``scales`` 4 (Res2Net) and ``radix`` 2
    (ResNeSt); RegNet's ``arch`` a named preset (its ``depth`` unread).
    ``norm_eval`` and ``with_cp`` reach every trunk (the JAX package's
    RegNet reads no ``with_cp``: checkpointing changes no number, only
    memory and time); ``quant``, ``qat`` and ``frozen_int8`` the ResNet
    family."""
    btype = backbone.get("type", "ResNet")
    _require(btype not in _EXTRA_BACKBONES, f"backbone type {btype!r}", _OTHER_FAMILIES)
    if btype not in _BACKBONES:
        raise ValueError(f"unknown backbone type {btype!r} (the port builds {_BACKBONES})")
    _require(not backbone.get("stem_s2d"), "backbone.stem_s2d", _OTHER_FAMILIES)
    _check_backbone_int8(backbone)
    quant = _backbone_quant(backbone, btype)
    common = dict(
        out_indices=tuple(backbone.get("out_indices", (0, 1, 2, 3))),
        frozen_stages=backbone.get("frozen_stages", 1),
        norm_eval=backbone.get("norm_eval", True),
        with_cp=bool(backbone.get("with_cp", False)),
    )
    if btype == "RegNet":
        return RegNet(arch=backbone["arch"], **common)
    v1d = btype in ("ResNetV1d", "Res2Net", "ResNeSt")
    return ResNet(
        depth=backbone.get("depth", 50),
        groups=backbone.get("groups", 1) if btype in ("ResNeXt", "ResNeSt") else 1,
        base_width=backbone.get("base_width", 26 if btype == "Res2Net" else 4),
        deep_stem=backbone.get("deep_stem", v1d),
        avg_down=backbone.get("avg_down", v1d),
        scales=backbone.get("scales", 4) if btype == "Res2Net" else 1,
        radix=backbone.get("radix", 2) if btype == "ResNeSt" else 0,
        reduction_factor=backbone.get("reduction_factor", 4),
        avg_down_stride=backbone.get("avg_down_stride", True),
        quant=quant,
        qat=bool(backbone.get("qat", False)),
        frozen_int8=bool(backbone.get("frozen_int8", False)),
        **common,
    )


def build_detector(model_cfg: Dict[str, Any], dtype: Any = None) -> SingleStageDetector:
    """``dtype``: compute dtype (torch dtype or one of ``DTYPES``' names);
    None reads ``model_cfg['dtype']``, default float32."""
    cfg = dict(model_cfg)
    backbone = dict(cfg.get("backbone", {}))
    neck = dict(cfg.get("neck", {}))
    head = dict(cfg.get("bbox_head", {}))
    det_type = cfg.get("type", "RADet")
    ntype = neck.get("type", "FPN")
    _require(det_type in ("RADet", "SingleStageDetector"), f"detector type {det_type!r}", _OTHER_FAMILIES)
    _require(ntype == "FPN", f"neck type {ntype!r}", _OTHER_FAMILIES)
    spec = head_spec_from_cfg(head)
    htype = spec["head_type"]
    if det_type == "RADet" and htype != "RADetHead":
        raise ValueError("detector type 'RADet' pairs with RADetHead; use type='SingleStageDetector' "
                         f"for {htype}")
    _require(spec["use_sigmoid"], f"{htype} with a softmax loss_cls (use_sigmoid=False)", _OTHER_FAMILIES)
    _check_head_qat(head, htype)
    if neck.get("act_cfg") is not None or neck.get("norm_cfg") is not None:
        raise ValueError("the FPN takes no act_cfg or norm_cfg")

    if dtype is None:
        dtype = cfg.get("dtype", "float32")
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]

    trunk = build_backbone(backbone)
    fpn_out = neck.get("out_channels", 256)
    num_outs = neck.get("num_outs", 5)
    num_classes = head["num_classes"]
    if htype == "AnchorHead":
        # no tower to quantize: the JAX package's AnchorHead takes no quant either
        bbox_head = AnchorHead(num_classes, in_channels=fpn_out, num_levels=num_outs,
                               num_anchors=spec["num_base_anchors"])
    else:
        bbox_head = (ATSSHead if htype == "ATSSHead" else RADetHead)(
            num_classes=num_classes,
            in_channels=fpn_out,
            feat_channels=head.get("feat_channels", 256),
            stacked_convs=head.get("stacked_convs", 4),
            num_levels=num_outs,
            num_anchors=spec["num_base_anchors"],
            quant=head.get("quant", None),
            qat=bool(head.get("qat", False)),
        )
    return (RADet if det_type == "RADet" else SingleStageDetector)(
        trunk,
        # the backbone's widths, not neck.in_channels: the JAX package's FPN
        # infers them, and configs/bop/regnetx32_ycbv_pbr.py inherits the
        # flagship's [256, 512, 1024, 2048] beside a RegNet of [96, 192, 432, 1008]
        FPN(
            in_channels=trunk.out_channels,
            out_channels=fpn_out,
            num_outs=num_outs,
            start_level=neck.get("start_level", 1),
            add_extra_convs=neck.get("add_extra_convs", "on_output"),
            relu_before_extra_convs=neck.get("relu_before_extra_convs", False),
        ),
        bbox_head,
        dtype=dtype,
    )
