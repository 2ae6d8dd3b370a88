"""The necks (port of ``radet_tpu/models/fpn.py``), NCHW.

:class:`FPN` -- RADet's wiring: start_level=1 over (C2..C5) -> 1x1
laterals on C3..C5, nearest top-down upsample, 3x3 output convs, and two
extra stride-2 convs producing P6, P7.  ``add_extra_convs`` picks their
source: 'on_output' (RADet: the last output), 'on_input' (the ATSS and
RetinaNet configs: the last backbone map) or 'on_lateral' (the last
lateral, after the top-down sum); ``relu_before_extra_convs`` puts a ReLU
before every extra conv but the first.  No norm layers; convs keep their
bias.  mmdet names: ``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``
(the extra convs continue the ``fpn_convs`` index).

:class:`ChannelMapper` -- one conv (and a ReLU, mmcv's default act_cfg)
per input level, no top-down path: as many outputs as inputs.  mmdet
names: ``convs.{i}.conv``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvModule, uniform_

EXTRA_CONV_SOURCES = ("on_output", "on_input", "on_lateral")


def upsample_nearest_to(x, target_hw):
    """2x nearest upsample by repeat, then crop to the target size.

    Not ``F.interpolate(size=...)``: that picks other source rows whenever
    a level is not exactly twice the one above, and the JAX package (and so
    the anchor grid) repeats then crops."""
    th, tw = target_hw
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :th, :tw]


def _xavier_init(module: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform kernels and zero biases of ``module``'s ConvModules."""
    for m in module.modules():
        if isinstance(m, ConvModule):
            w = m.conv.weight
            rf = w.shape[2] * w.shape[3]
            uniform_(w, math.sqrt(6.0 / (w.shape[0] * rf + w.shape[1] * rf)), generator)
            with torch.no_grad():
                m.conv.bias.zero_()


class FPN(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int] = (256, 512, 1024, 2048),
        out_channels: int = 256,
        num_outs: int = 5,
        start_level: int = 1,
        add_extra_convs: str = "on_output",
        relu_before_extra_convs: bool = False,
    ):
        super().__init__()
        if add_extra_convs not in EXTRA_CONV_SOURCES:
            raise ValueError(f"unsupported add_extra_convs={add_extra_convs!r} (expected one of "
                             f"{EXTRA_CONV_SOURCES})")
        used = list(in_channels)[start_level:]
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in used)
        fpn = [ConvModule(out_channels, out_channels, 3, padding=1) for _ in used]
        for i in range(num_outs - len(used)):
            # 'on_input': the first extra conv reads the last backbone map (C5)
            cin = in_channels[-1] if i == 0 and add_extra_convs == "on_input" else out_channels
            fpn.append(ConvModule(cin, out_channels, 3, stride=2, padding=1))
        self.fpn_convs = nn.ModuleList(fpn)

    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform kernels, zero bias."""
        _xavier_init(self, generator)

    def forward(self, inputs):
        used = list(inputs[self.start_level :])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_to(
                laterals[i], laterals[i - 1].shape[2:]
            )
        outs = [self.fpn_convs[i](lat) for i, lat in enumerate(laterals)]
        source = {"on_output": outs[-1], "on_input": inputs[-1], "on_lateral": laterals[-1]}[self.add_extra_convs]
        for i, conv in enumerate(self.fpn_convs[len(laterals) :]):
            if i > 0 and self.relu_before_extra_convs:
                source = F.relu(source)
            source = conv(source)
            outs.append(source)
        return tuple(outs)


class ChannelMapper(nn.Module):
    """A ``kernel_size`` conv to ``out_channels`` on each input level, with
    a ReLU after it unless ``with_relu`` is False (mmdet's ``act_cfg=None``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, kernel_size: int = 3,
                 with_relu: bool = True):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.with_relu = with_relu
        self.convs = nn.ModuleList(ConvModule(c, out_channels, kernel_size, padding=pad) for c in in_channels)

    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform kernels, zero bias."""
        _xavier_init(self, generator)

    def forward(self, inputs):
        outs = [conv(x) for conv, x in zip(self.convs, inputs)]
        return tuple(F.relu(y) if self.with_relu else y for y in outs)
