"""Convert the JAX package's detector variables into the port's state dict.

:func:`state_dict_from_flax` takes the ``{params, batch_stats}`` tree as
nested dicts of numpy arrays and returns mmdet-named tensors
(``backbone.layer1.0.conv1.weight``, ``neck.lateral_convs.0.conv.weight``,
``bbox_head.scales.0.scale``, ...) that the port's detector loads with
``strict=True``.  For RADet it is the exact inverse of
``tools/convert_torch_weights.py::convert_mmdet_detector`` over the whole
backbone zoo: the deep stem (``stem.{0,1,3,4,6,7}``), the BasicBlock's
``conv1``/``conv2``, Res2Net's ``convs.i``/``bns.i``, ResNeSt's
``conv2.{conv,bn0,fc1,bn1,fc2}`` and the avg-down residual path
(``downsample.{1,2}`` behind the pool); and of ``convert_darknet``,
``convert_hrnet``, ``convert_ssd_vgg`` and ``convert_detectors_resnet``
over the extra families (``models/backbones_extra.py``: Darknet's
ConvModules ``conv1.{conv,bn}``, HRNet's ``transition``/``stage``
Sequentials, SSD-VGG's ``features.{i}``/``extra.{i}``/``l2_norm``,
DetectoRS's SAC ``conv2`` and ``rfp_conv``).  The neck's names are the FPN's
or the ChannelMapper's (``neck.convs.{i}.conv``).  The ATSSHead
(``cls_convs``, ``atss_cls``, ``atss_reg``, ``atss_centerness``,
``scales``) and AnchorHead (``conv_cls``, ``conv_reg``) names are mmdet's
too.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernel(x) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(3, 2, 0, 1)))


def state_dict_from_flax(variables: Dict[str, Any], avg_down: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """``{params, batch_stats}`` (nested dicts of numpy arrays) -> state dict.

    The head is told apart by its variables: ``atss_cls`` (ATSSHead),
    ``conv_iou`` (RADetHead), else AnchorHead; a tree without a neck or a
    head (a backbone alone) gives the entries it has.  The blocks' kinds
    show in their variables too; whether a plain or basic block's
    downsample is avg-down does not: ``avg_down`` says so, and None takes
    it from the deep stem (ResNetV1d pairs them).  Res2Net's and
    ResNeSt's downsamples are always avg-down.  Raises ValueError on any
    entry the float backbone/FPN/head layouts do not have, so an unported
    variant fails loudly."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    used = set()

    def take(col, path):
        node = params if col == "params" else stats
        for p in path:
            node = node[p]
        used.add((col,) + tuple(path))
        return node

    def bn(prefix, path):
        sd[prefix + ".weight"] = _t(take("params", path + ("BatchNorm_0", "scale")))
        sd[prefix + ".bias"] = _t(take("params", path + ("BatchNorm_0", "bias")))
        sd[prefix + ".running_mean"] = _t(take("batch_stats", path + ("BatchNorm_0", "mean")))
        sd[prefix + ".running_var"] = _t(take("batch_stats", path + ("BatchNorm_0", "var")))

    def conv(prefix, path, bias=False):
        sd[prefix + ".weight"] = _kernel(take("params", path + ("kernel",)))
        if bias:
            sd[prefix + ".bias"] = _t(take("params", path + ("bias",)))

    bb = ("backbone",)
    backbone = params.get("backbone", {})
    if "crb1_conv" in backbone:  # Darknet: mmcv ConvModules (conv, bn)
        conv("backbone.conv1.conv", bb + ("conv1",))
        bn("backbone.conv1.bn", bb + ("bn1",))
        for name in backbone:
            m = re.fullmatch(r"crb(\d+)(?:_res(\d+))?_conv(\d?)", name)
            if m:
                i, j, c = m.groups()
                tp = f"backbone.conv_res_block{i}." + ("conv" if j is None else f"res{j}.conv{c}")
                conv(tp + ".conv", bb + (name,))
                bn(tp + ".bn", bb + (name[: -len("conv" + c)] + "bn" + c,))
    elif "features_0" in backbone:  # SSD-VGG: biased convs, no BatchNorm
        for name in backbone:
            m = re.fullmatch(r"(features|extra)_(\d+)", name)
            if m:
                conv(f"backbone.{m.group(1)}.{m.group(2)}", bb + (name,), bias=True)
        sd["backbone.l2_norm.weight"] = _t(take("params", bb + ("l2_norm_weight",)))
    elif "stem_conv1" in backbone:  # deep stem: Sequential(conv, bn, relu) x 3
        for i, idx in enumerate((0, 3, 6), start=1):
            conv(f"backbone.stem.{idx}", bb + (f"stem_conv{i}",))
            bn(f"backbone.stem.{idx + 1}", bb + (f"stem_bn{i}",))
    elif "conv1" in backbone:
        conv("backbone.conv1", bb + ("conv1",))
        bn("backbone.bn1", bb + ("bn1",))
        if "conv2" in backbone:  # HRNet's second stem conv
            conv("backbone.conv2", bb + ("conv2",))
            bn("backbone.bn2", bb + ("bn2",))
    for name in backbone:  # HRNet's Sequential(conv, bn[, ReLU]) units, chains of them by index
        m = (re.fullmatch(r"(transition\d+)_([\d_]+)_conv", name)
             or re.fullmatch(r"s(\d+m\d+)_fuse([\d_]+)_conv", name))
        if m:
            unit, index = m.groups()
            unit = unit if unit.startswith("transition") else "stage{}.{}.fuse_layers".format(*unit.split("m"))
            conv(f"backbone.{unit}.{index.replace('_', '.')}.0", bb + (name,))
            bn(f"backbone.{unit}.{index.replace('_', '.')}.1", bb + (name[: -len("conv")] + "bn",))
    if avg_down is None:
        avg_down = "stem_conv1" in backbone
    for name in sorted(backbone):
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        branch = re.fullmatch(r"s(\d+)m(\d+)_branch(\d+)_block(\d+)", name)  # HRNet's BasicBlocks
        if m:
            tp = f"backbone.layer{m.group(1)}.{m.group(2)}."
        elif branch:
            tp = "backbone.stage{}.{}.branches.{}.{}.".format(*branch.groups())
        else:
            continue
        fp = bb + (name,)
        block = backbone[name]
        for ci in (1, 2, 3):
            if "kernel" in block.get(f"conv{ci}", {}):
                conv(tp + f"conv{ci}", fp + (f"conv{ci}",))
                bn(tp + f"bn{ci}", fp + (f"bn{ci}",))
        if "weight_diff" in block.get("conv2", {}):  # DetectoRS's SAC conv2
            sac = fp + ("conv2",)
            for w in ("weight", "weight_diff"):
                sd[tp + f"conv2.{w}"] = _kernel(take("params", sac + (w,)))
            for w in ("weight_gamma", "weight_beta"):
                sd[tp + f"conv2.{w}"] = _t(take("params", sac + (w,))).reshape(-1, 1, 1, 1)
            for sub in ("pre_context", "switch", "post_context"):
                conv(tp + f"conv2.{sub}", sac + (sub,), bias=True)
            bn(tp + "bn2", fp + ("bn2",))
        if "rfp_conv" in block:
            conv(tp + "rfp_conv", fp + ("rfp_conv",), bias=True)
        split_attention = "conv" in block.get("conv2", {})
        if split_attention:
            conv(tp + "conv2.conv", fp + ("conv2", "conv"))
            for b in ("bn0", "bn1"):
                bn(tp + f"conv2.{b}", fp + ("conv2", b))
            for fc in ("fc1", "fc2"):
                conv(tp + f"conv2.{fc}", fp + ("conv2", fc), bias=True)
        i = 0
        while f"convs_{i}" in block:  # Res2Net's per-scale 3x3s
            conv(tp + f"convs.{i}", fp + (f"convs_{i}",))
            bn(tp + f"bns.{i}", fp + (f"bns_{i}",))
            i += 1
        if "downsample_conv" in block:
            j = int(avg_down or split_attention or i > 0)  # behind the avg-pool
            conv(tp + f"downsample.{j}", fp + ("downsample_conv",))
            bn(tp + f"downsample.{j + 1}", fp + ("downsample_bn",))

    neck = params.get("neck", {})
    n_lateral = sum(1 for k in neck if re.fullmatch(r"fpn_\d+", k))
    for name in neck:
        m = re.fullmatch(r"(lateral|fpn|fpn_extra|map)_(\d+)", name)
        if not m:
            continue
        kind, i = m.group(1), int(m.group(2))
        prefix = {
            "lateral": f"neck.lateral_convs.{i}.conv",
            "fpn": f"neck.fpn_convs.{i}.conv",
            "fpn_extra": f"neck.fpn_convs.{n_lateral + i}.conv",
            "map": f"neck.convs.{i}.conv",  # ChannelMapper
        }[kind]
        sd[prefix + ".weight"] = _kernel(take("params", ("neck", name, "kernel")))
        sd[prefix + ".bias"] = _t(take("params", ("neck", name, "bias")))

    head = params.get("bbox_head", {})
    for name in head:
        m = re.fullmatch(r"(cls|reg)_conv_(\d+)", name)
        if not m:
            continue
        prefix = f"bbox_head.{m.group(1)}_convs.{m.group(2)}"
        hp = ("bbox_head", name)
        sd[prefix + ".conv.weight"] = _kernel(take("params", hp + ("conv", "kernel")))
        sd[prefix + ".gn.weight"] = _t(take("params", hp + ("gn", "scale")))
        sd[prefix + ".gn.bias"] = _t(take("params", hp + ("gn", "bias")))
    if not head:
        convs = {}
    elif "atss_cls" in head:  # ATSSHead: mmdet's names already
        convs = {n: n for n in ("atss_cls", "atss_reg", "atss_centerness")}
    elif "conv_iou" in head:  # RADetHead
        convs = {"conv_cls": "atss_cls", "conv_reg": "atss_reg", "conv_iou": "atss_centerness"}
    else:  # AnchorHead
        convs = {"conv_cls": "conv_cls", "conv_reg": "conv_reg"}
    for fname, tname in convs.items():
        sd[f"bbox_head.{tname}.weight"] = _kernel(take("params", ("bbox_head", fname, "kernel")))
        sd[f"bbox_head.{tname}.bias"] = _t(take("params", ("bbox_head", fname, "bias")))
    if "scales" in head:
        for i, s in enumerate(np.asarray(take("params", ("bbox_head", "scales")), np.float32)):
            sd[f"bbox_head.scales.{i}.scale"] = torch.tensor(float(s), dtype=torch.float32)

    leftover = [
        "/".join((col,) + path)
        for col, tree in (("params", params), ("batch_stats", stats))
        for path in _leaf_paths(tree)
        if (col,) + path not in used
    ]
    if leftover:
        raise ValueError(f"variables the port has no place for: {sorted(leftover)[:8]}")
    return sd


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)
