"""ResNet-50 backbone, float and eval-only (port of ``radet_tpu/models/resnet.py``).

'pytorch' style (stride on the 3x3 conv), plain 7x7/2 stem with padding 3,
``MaxPool2d(3, 2, 1)``, and BatchNorm frozen to its running statistics
(mmcv ``norm_eval=True``; the reference never updates BN while training a
detector).  Parameter names follow torchvision/mmdet
(``layer1.0.conv1.weight``, ``layer1.0.downsample.1.running_var``), so a
released checkpoint loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, normal_

STAGE_BLOCKS = (3, 4, 6, 3)  # ResNet-50


class FrozenBatchNorm(nn.Module):
    """BatchNorm applying its running statistics as a fixed affine, eps 1e-5
    (counterpart of ``FrozenAwareBN``).  ``weight``/``bias`` stay parameters
    (trainable under norm_eval); mean and variance are buffers."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # mmdet checkpoints carry BatchNorm's step counter; frozen statistics
        # never use it
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, out, 1, stride=stride, bias=False), FrozenBatchNorm(out))
            if downsample
            else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-50 returning the maps selected by ``out_indices``:
    (0, 1, 2, 3) -> (C2, C3, C4, C5) at strides (4, 8, 16, 32), NCHW."""

    def __init__(
        self,
        depth: int = 50,
        out_indices: Sequence[int] = (0, 1, 2, 3),
        frozen_stages: int = 1,
        norm_eval: bool = True,
    ):
        super().__init__()
        if depth != 50:
            raise NotImplementedError(
                f"ResNet depth {depth}: only depth 50 is ported "
                "(ROADMAP.md Queue 1 item 12, other families)"
            )
        if not norm_eval:
            raise NotImplementedError(
                "norm_eval=False updates BatchNorm statistics while training "
                "(ROADMAP.md Queue 1 item 18, live BatchNorm and checkpointing)"
            )
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, n in enumerate(STAGE_BLOCKS):
            planes = 64 * 2**i
            blocks = [Bottleneck(inplanes, planes, 1 if i == 0 else 2, downsample=True)]
            blocks += [Bottleneck(planes * 4, planes) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = planes * 4
        # mmdet _freeze_stages: the stem and the first ``frozen_stages``
        # stages take no gradient
        frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
        frozen += [getattr(self, f"layer{i}") for i in range(1, frozen_stages + 1)]
        for m in frozen:
            m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming normal (fan_out) convs, identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                normal_(m.weight, math.sqrt(2.0 / fan_out), generator)
            elif isinstance(m, FrozenBatchNorm):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(len(STAGE_BLOCKS)):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
