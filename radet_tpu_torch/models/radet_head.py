"""RADet dense head (port of ``radet_tpu/models/radet_head.py``).

- ``stacked_convs`` blocks of 3x3 conv + GroupNorm(32) + ReLU on each of the
  cls and reg branches, shared across the pyramid levels;
- heads: cls (``num_classes`` channels), reg (4 channels, times a
  per-level learnable Scale, then ReLU) and an IoU-quality channel on the
  reg branch;
- cls bias initialised to -log((1-p)/p), p = 0.01.

With ``quant='int8'`` the towers' 3x3 convs run the int8 deploy arithmetic
(``ops/quant.py``), in training mode too, as in the JAX package: the first
conv of a tower quantizes its FPN level with the level tensor's dynamic
absmax (over the whole batch, so one image's result depends on the others
in its batch), and each block but the last hands the next its ReLU'd
GroupNorm output as int8 with static per-channel scales
``affine_act_scale(gamma, beta, 8)``.  With ``qat`` as well, training runs
the same arithmetic as straight-through fake quantization on float tensors
(``ops/quant.py::qat_conv_forward``), the scales taking the GroupNorm
affines' gradient; at eval a QAT head is the deploy head.  The output
convs stay float.

mmdet names: ``cls_convs.{i}.conv/.gn``, ``atss_cls``, ``atss_reg``,
``atss_centerness``, ``scales.{i}.scale``.  Outputs are float32 and NHWC per
level, as in the JAX package, so that flattening them follows the anchor
order (x fastest).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import affine_act_scale, fake_quant_ste, int8_conv_forward, qat_conv_forward, quantize_int8
from .layers import Conv2d, normal_


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when wider (a float64 model)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


HEAD_QUANT = (None, "int8")
_GN_BOUND_K = 8.0  # k of the static GroupNorm activation bound


class ConvGNBlock(nn.Module):
    """3x3 conv (compute dtype) + GroupNorm(32) in float32 + ReLU; its int8
    form is :meth:`forward_int8`."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, padding=1, bias=False)
        self.gn = nn.GroupNorm(32, channels, eps=1e-5)

    def forward(self, x):
        # GroupNorm in float32 on the upcast conv output, as the JAX package
        # does under bf16 compute
        return F.relu(self.gn(_wide(self.conv(x)))).to(x.dtype)

    def forward_int8(self, x, x_scale, emit_int8: bool, dtype, qat: bool = False):
        """The int8 block: ``x`` float (``x_scale`` None: dynamic absmax) or
        int8 with its scales.  Returns the output in ``dtype``, or with
        ``emit_int8`` (the int8 output, its per-channel scales).  With
        ``qat`` the same grid in float, with gradients: ``x`` is float and
        the emitted output the fake-quantized float32 one."""
        conv = qat_conv_forward if qat else int8_conv_forward
        y = F.relu(self.gn(conv(self.conv, x, x_scale).float()))
        if not emit_int8:
            return y.to(dtype)
        if qat:
            s = affine_act_scale(self.gn.weight, self.gn.bias, _GN_BOUND_K)
            return fake_quant_ste(y, s[:, None, None]), s
        s = affine_act_scale(self.gn.weight.detach(), self.gn.bias.detach(), _GN_BOUND_K)
        return quantize_int8(y, s), s


def _run_tower(blocks, x, quant, qat: bool = False):
    """A stacked ConvGNBlock tower; under int8 every block but the last hands
    the next an int8 tensor (under ``qat``, its fake-quantized float) and
    its static scales."""
    if quant != "int8":
        for blk in blocks:
            x = blk(x)
        return x
    dtype, scale = x.dtype, None
    for i, blk in enumerate(blocks):
        if i == len(blocks) - 1:
            return blk.forward_int8(x, scale, False, dtype, qat)
        x, scale = blk.forward_int8(x, scale, True, dtype, qat)
    return x


class Scale(nn.Module):
    """mmcv ``Scale``: one learnable scalar."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x):
        return x * self.scale


class RADetHead(nn.Module):
    #: ReLU on the scaled regression (RADet's addition to the ATSS head)
    reg_relu = True

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 256,
        feat_channels: int = 256,
        stacked_convs: int = 4,
        num_levels: int = 5,
        num_anchors: int = 1,
        quant: Optional[str] = None,
        qat: bool = False,
    ):
        super().__init__()
        if quant not in HEAD_QUANT:
            raise ValueError(f"{type(self).__name__}.quant: unsupported {quant!r} (None | 'int8')")
        if qat and quant != "int8":
            raise AssertionError(f"{type(self).__name__}.qat needs quant='int8'")
        self.quant, self.qat = quant, qat
        chans = [in_channels] + [feat_channels] * (stacked_convs - 1)
        self.cls_convs = nn.ModuleList(ConvGNBlock(c, feat_channels) for c in chans)
        self.reg_convs = nn.ModuleList(ConvGNBlock(c, feat_channels) for c in chans)
        self.atss_cls = Conv2d(feat_channels, num_anchors * num_classes, 3, padding=1)
        self.atss_reg = Conv2d(feat_channels, num_anchors * 4, 3, padding=1)
        self.atss_centerness = Conv2d(feat_channels, num_anchors, 3, padding=1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in range(num_levels))

    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.01) kernels, zero bias except cls at -log(99), identity GN,
        unit scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv2d):
                    normal_(m.weight, 0.01, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, Scale):
                    m.scale.fill_(1.0)
            self.atss_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(
        self, feats: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        if len(feats) != len(self.scales):
            raise ValueError(f"expected {len(self.scales)} pyramid levels, got {len(feats)}")
        qat = self.qat and self.training
        cls_out, reg_out, iou_out = [], [], []
        for scale, x in zip(self.scales, feats):
            cls_feat = _run_tower(self.cls_convs, x, self.quant, qat)
            reg_feat = _run_tower(self.reg_convs, x, self.quant, qat)
            cls_score = _wide(self.atss_cls(cls_feat))
            bbox_pred = scale(_wide(self.atss_reg(reg_feat)))
            if self.reg_relu:
                bbox_pred = F.relu(bbox_pred)
            iou_pred = _wide(self.atss_centerness(reg_feat))
            cls_out.append(cls_score.permute(0, 2, 3, 1))
            reg_out.append(bbox_pred.permute(0, 2, 3, 1))
            iou_out.append(iou_pred.permute(0, 2, 3, 1))
        return cls_out, reg_out, iou_out
