"""Fold frozen BatchNorms into the preceding convolution's weights (port of
``radet_tpu/models/fuse.py``; the test CLI's ``--fuse-conv-bn``).

Every BatchNorm of the port's trunks applies its running statistics at eval
(``models/resnet.py::BatchNorm``), so the fold is exact:

    BN(z) = (z - mean) * gamma / sqrt(var + eps) + beta = z * s + (beta - s * mean)
    with s = gamma / sqrt(var + eps)

The conv's output channels are scaled by ``s`` (and its bias, where it has
one), and the BatchNorm becomes a pure shift: mean 0, var ``1 - eps``,
weight 1, bias ``beta - s * mean``.  The module graph is unchanged, so the
fused state dict loads with ``strict=True`` into the same model.

Conv and BatchNorm pair by the mmdet names of the port's trunks: ``convN``
/ ``bnN`` (ResNet, ResNeXt, RegNet, HRNet, DetectoRS, the stems'
``conv1``/``bn1``), a ConvModule's ``conv`` / ``bn`` (Darknet), the
Sequentials' ``i - 1`` / ``i`` (the deep stem ``stem.{0,1,3,4,6,7}``, the
downsample ``downsample.{0,1}`` or, behind the avg-down pool,
``downsample.{1,2}``, HRNet's transition and fuse units), Res2Net's
``convs.i`` / ``bns.i`` and ResNeSt's split-attention ``conv`` / ``bn0`` and
``fc1`` / ``bn1``.  A BatchNorm whose partner is not a plain conv (a 4-D
``weight`` and an optional ``bias``, nothing else) stays in place, as in
the JAX package; leaving it is exact.  DetectoRS's SAC conv, which
standardises its weight at every call, is such a partner: its ``bn2``
stays.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

BN_EPS = 1e-5  # every BatchNorm of the port's trunks
_BN_LEAVES = {"weight", "bias", "running_mean", "running_var"}


def _modules(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """module prefix -> {leaf name: tensor}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        out.setdefault(prefix, {})[leaf] = value
    return out


def _is_bn(leaves) -> bool:
    return _BN_LEAVES <= set(leaves) <= _BN_LEAVES | {"num_batches_tracked"}


def _is_plain_conv(leaves) -> bool:
    return set(leaves) in ({"weight"}, {"weight", "bias"}) and leaves["weight"].dim() == 4


def _conv_candidates(bn_prefix: str, modules) -> List[str]:
    """Possible conv prefixes for the BatchNorm at ``bn_prefix`` (ordered)."""
    parent, _, key = bn_prefix.rpartition(".")

    def sibling(name):
        return f"{parent}.{name}" if parent else name

    cands: List[str] = []
    if key.isdigit():
        grand, _, container = parent.rpartition(".")
        if container == "bns":  # Res2Net: bns.i after convs.i
            cands.append(f"{grand}.convs.{key}" if grand else f"convs.{key}")
        elif int(key) > 0:  # a Sequential's (conv, bn) pair
            cands.append(sibling(str(int(key) - 1)))
    m = re.fullmatch(r"(.*)bn(\d*)", key)
    if m:
        cands.append(sibling(f"{m.group(1)}conv{m.group(2)}"))
    # ResNeSt's SplitAttentionConv: pairs are (conv, bn0) and (fc1, bn1)
    if key == "bn0" and sibling("conv") in modules:
        cands.append(sibling("conv"))
    if key == "bn1" and sibling("conv1") not in modules and sibling("fc1") in modules:
        cands.append(sibling("fc1"))
    return [c for c in cands if c in modules]


def fuse_conv_bn(state_dict: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Return ``(fused state dict, report)``.

    ``state_dict`` is a detector's (or a trunk's) mmdet-named state dict; it
    is not modified.  ``report`` counts the ``fused`` and ``skipped``
    BatchNorms and lists the skipped ones' prefixes (``skipped_paths``)."""
    out = dict(state_dict)
    modules = _modules(state_dict)
    report = {"fused": 0, "skipped": 0, "skipped_paths": []}
    for prefix, leaves in modules.items():
        if not _is_bn(leaves):
            continue
        convs = [c for c in _conv_candidates(prefix, modules) if _is_plain_conv(modules[c])]
        if not convs:
            report["skipped"] += 1
            report["skipped_paths"].append(prefix)
            continue
        conv = modules[convs[0]]
        mean, var = leaves["running_mean"].float(), leaves["running_var"].float()
        gamma, beta = leaves["weight"].float(), leaves["bias"].float()
        # the square root correctly rounded, as the JAX package's: torch's
        # vectorised float32 sqrt on the CPU is an ulp off on ~1% of inputs
        s = gamma / torch.sqrt((var + BN_EPS).double()).float()
        weight = conv["weight"]
        out[f"{convs[0]}.weight"] = (weight.float() * s[:, None, None, None]).to(weight.dtype)  # OIHW
        if "bias" in conv:
            out[f"{convs[0]}.bias"] = (conv["bias"].float() * s).to(conv["bias"].dtype)
        out[f"{prefix}.weight"] = torch.ones_like(leaves["weight"])
        out[f"{prefix}.bias"] = (beta - s * mean).to(leaves["bias"].dtype)
        out[f"{prefix}.running_mean"] = torch.zeros_like(leaves["running_mean"])
        # var = 1 - eps, so that the BatchNorm divides by sqrt((1 - eps) + eps) == 1
        out[f"{prefix}.running_var"] = torch.full_like(
            leaves["running_var"], float(np.float32(1.0) - np.float32(BN_EPS)))
        report["fused"] += 1
    return out, report
