"""Convert the JAX package's RADet variables into the port's state dict.

:func:`state_dict_from_flax` is the exact inverse of
``tools/convert_torch_weights.py::convert_mmdet_detector``: it takes the
``{params, batch_stats}`` tree as nested dicts of numpy arrays and returns
mmdet-named tensors (``backbone.layer1.0.conv1.weight``,
``neck.lateral_convs.0.conv.weight``, ``bbox_head.scales.0.scale``, ...)
that the port's RADet loads with ``strict=True``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernel(x) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(3, 2, 0, 1)))


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{params, batch_stats}`` (nested dicts of numpy arrays) -> state dict.

    Raises ValueError on any entry the float RADet/ResNet/FPN/RADetHead
    layout does not have, so an unported variant fails loudly."""
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

    bb = ("backbone",)
    sd["backbone.conv1.weight"] = _kernel(take("params", bb + ("conv1", "kernel")))
    bn("backbone.bn1", bb + ("bn1",))
    for name in sorted(params["backbone"]):
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if not m:
            continue
        tp = f"backbone.layer{m.group(1)}.{m.group(2)}."
        fp = bb + (name,)
        for ci in (1, 2, 3):
            sd[tp + f"conv{ci}.weight"] = _kernel(take("params", fp + (f"conv{ci}", "kernel")))
            bn(tp + f"bn{ci}", fp + (f"bn{ci}",))
        if "downsample_conv" in params["backbone"][name]:
            sd[tp + "downsample.0.weight"] = _kernel(
                take("params", fp + ("downsample_conv", "kernel"))
            )
            bn(tp + "downsample.1", fp + ("downsample_bn",))

    neck = params["neck"]
    n_lateral = sum(1 for k in neck if re.fullmatch(r"fpn_\d+", k))
    for name in neck:
        m = re.fullmatch(r"(lateral|fpn|fpn_extra)_(\d+)", name)
        if not m:
            continue
        kind, i = m.group(1), int(m.group(2))
        prefix = {
            "lateral": f"neck.lateral_convs.{i}.conv",
            "fpn": f"neck.fpn_convs.{i}.conv",
            "fpn_extra": f"neck.fpn_convs.{n_lateral + i}.conv",
        }[kind]
        sd[prefix + ".weight"] = _kernel(take("params", ("neck", name, "kernel")))
        sd[prefix + ".bias"] = _t(take("params", ("neck", name, "bias")))

    head = params["bbox_head"]
    for name in head:
        m = re.fullmatch(r"(cls|reg)_conv_(\d+)", name)
        if not m:
            continue
        prefix = f"bbox_head.{m.group(1)}_convs.{m.group(2)}"
        hp = ("bbox_head", name)
        sd[prefix + ".conv.weight"] = _kernel(take("params", hp + ("conv", "kernel")))
        sd[prefix + ".gn.weight"] = _t(take("params", hp + ("gn", "scale")))
        sd[prefix + ".gn.bias"] = _t(take("params", hp + ("gn", "bias")))
    for fname, tname in (("conv_cls", "atss_cls"), ("conv_reg", "atss_reg"), ("conv_iou", "atss_centerness")):
        sd[f"bbox_head.{tname}.weight"] = _kernel(take("params", ("bbox_head", fname, "kernel")))
        sd[f"bbox_head.{tname}.bias"] = _t(take("params", ("bbox_head", fname, "bias")))
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
