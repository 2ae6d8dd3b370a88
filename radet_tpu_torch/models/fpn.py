"""Feature Pyramid Network (port of ``radet_tpu/models/fpn.py``), NCHW.

RADet's wiring: start_level=1 over (C2..C5) -> 1x1 laterals on C3..C5,
nearest top-down upsample, 3x3 output convs, and two extra stride-2 convs
'on_output' producing P6, P7 with no ReLU between them; 'on_input' (the
ATSS and RetinaNet configs) starts the extra convs from C5 instead.  No norm layers;
convs keep their bias.  mmdet names: ``lateral_convs.{i}.conv``,
``fpn_convs.{i}.conv`` (the extra convs continue the ``fpn_convs`` index).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvModule, uniform_


def upsample_nearest_to(x, target_hw):
    """2x nearest upsample by repeat, then crop to the target size.

    Not ``F.interpolate(size=...)``: that picks other source rows whenever
    a level is not exactly twice the one above, and the JAX package (and so
    the anchor grid) repeats then crops."""
    th, tw = target_hw
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :th, :tw]


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
        if add_extra_convs not in ("on_output", "on_input") or relu_before_extra_convs:
            raise NotImplementedError(
                f"FPN add_extra_convs={add_extra_convs!r}, relu_before_extra_convs="
                f"{relu_before_extra_convs}: only 'on_output' and 'on_input' without ReLU "
                "are ported (ROADMAP.md Queue 1 item 12, other families)"
            )
        used = list(in_channels)[start_level:]
        self.start_level = start_level
        self.on_input = add_extra_convs == "on_input"
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in used)
        fpn = [ConvModule(out_channels, out_channels, 3, padding=1) for _ in used]
        for i in range(num_outs - len(used)):
            # 'on_input': the first extra conv reads the last backbone map (C5)
            cin = in_channels[-1] if i == 0 and self.on_input else out_channels
            fpn.append(ConvModule(cin, out_channels, 3, stride=2, padding=1))
        self.fpn_convs = nn.ModuleList(fpn)

    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform kernels, zero bias."""
        for m in self.modules():
            if isinstance(m, ConvModule):
                w = m.conv.weight
                rf = w.shape[2] * w.shape[3]
                uniform_(w, math.sqrt(6.0 / (w.shape[0] * rf + w.shape[1] * rf)), generator)
                with torch.no_grad():
                    m.conv.bias.zero_()

    def forward(self, inputs):
        used = list(inputs[self.start_level :])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_to(
                laterals[i], laterals[i - 1].shape[2:]
            )
        outs = [self.fpn_convs[i](lat) for i, lat in enumerate(laterals)]
        source = inputs[-1] if self.on_input else outs[-1]
        for conv in self.fpn_convs[len(laterals) :]:
            source = conv(source)
            outs.append(source)
        return tuple(outs)
