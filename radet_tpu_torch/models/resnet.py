"""The ResNet backbone zoo, float (port of ``radet_tpu/models/resnet.py``).

ResNet at depths 18, 34, 50, 101 and 152, with ResNetV1d's deep stem and
avg-down residual path, ResNeXt's grouped 3x3, Res2Net's ``Bottle2neck``
and ResNeSt's split-attention bottleneck; and RegNetX
(:class:`RegNet`).  'pytorch' style (stride on the 3x3 conv), BatchNorm
frozen to its running statistics (mmcv ``norm_eval=True``; the reference
never updates BN while training a detector).  Parameter names follow
mmdet (``layer1.0.conv1.weight``, ``stem.3.weight``,
``layer2.0.convs.1.weight``, ``layer1.0.conv2.fc1.bias``,
``layer1.0.downsample.1.running_var``), so a released checkpoint loads
with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, normal_, trunc_normal_

# (block kind, blocks per stage) by depth
ARCH = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

# RegNetX quantized-linear width parameters (mmdet regnet.py arch_settings)
REGNET_ARCH = {
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22, bot_mul=1.0),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16, bot_mul=1.0),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18, bot_mul=1.0),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25, bot_mul=1.0),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23, bot_mul=1.0),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17, bot_mul=1.0),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23, bot_mul=1.0),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19, bot_mul=1.0),
}


def regnet_stage_params(arch: dict, divisor: int = 8):
    """Per-stage (output widths, blocks, bottleneck widths, groups) of a
    RegNet: the quantized linear widths, contiguous equal widths grouped
    into stages, each bottleneck width rounded to a multiple of its group
    width (mmdet's generate_regnet, adjust_width_group and
    get_stages_from_blocks)."""
    w0, wa, wm, depth = arch["w0"], arch["wa"], arch["wm"], arch["depth"]
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, ks) / divisor) * divisor).astype(int).tolist()
    stage_widths, stage_blocks = [], []
    for w in widths:
        if stage_widths and stage_widths[-1] == w:
            stage_blocks[-1] += 1
        else:
            stage_widths.append(w)
            stage_blocks.append(1)
    bot_mul, group_w = arch["bot_mul"], arch["group_w"]
    bot_widths, groups, out_widths = [], [], []
    for w in stage_widths:
        wb = int(w * bot_mul)
        g = min(group_w, wb)
        wb = int(round(wb / g) * g)
        bot_widths.append(wb)
        groups.append(wb // g)
        out_widths.append(int(wb / bot_mul))
    return out_widths, stage_blocks, bot_widths, groups


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


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1) -> Conv2d:
    """Bias-free conv with symmetric padding (kernel - 1) // 2."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, groups=groups, bias=False)


class Downsample(nn.Sequential):
    """The residual path's projection: 1x1 conv (at the block's stride) and
    BN as ``downsample.{0,1}``; with ``avg_down``, mmdet's
    ``AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False)``
    in front of a stride-1 conv as ``downsample.{0,1,2}`` at every stride,
    as mmdet's ResLayer and Res2Layer build it (at stride 1 that pool is
    the identity, held here as ``nn.Identity``)."""

    def __init__(self, cin: int, cout: int, stride: int, avg_down: bool = False):
        mods = [_conv(cin, cout, 1, 1 if avg_down else stride), FrozenBatchNorm(cout)]
        if avg_down:
            pool = nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False)
            mods.insert(0, pool if stride > 1 else nn.Identity())
        super().__init__(*mods)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a stride-1 avg-down path saved without its identity pool (mmcls's
        # ResLayer adds the pool at stride > 1 only): conv and BN move up one
        if isinstance(self[0], nn.Identity) and prefix + "0.weight" in state_dict:
            for i in (1, 0):
                for key in [k for k in state_dict if k.startswith(f"{prefix}{i}.")]:
                    state_dict[f"{prefix}{i + 1}.{key[len(prefix) + 2:]}"] = state_dict.pop(key)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _residual(block: nn.Module, out, x):
    identity = x if block.downsample is None else block.downsample(x)
    return F.relu(out + identity)


class BasicBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34), stride on the first."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return _residual(self, self.bn2(self.conv2(out)), x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, ``groups``) -> 1x1 to ``planes * expansion``;
    ``width`` is the mid width (0: ``planes``).  ResNeXt passes its groups
    and width, RegNet expansion 1 and its stage's groups and width."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None,
                 groups: int = 1, width: int = 0, expansion: int = 4):
        super().__init__()
        width = width or planes
        out = planes * expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return _residual(self, self.bn3(self.conv3(out)), x)


class Bottle2neck(nn.Module):
    """Res2Net's block: the 3x3 stage splits into ``scales`` groups of
    ``planes * base_width // 64`` channels.  Group 0 goes through
    ``convs.0``; each later one adds the previous group's output first
    ('normal' blocks) or starts fresh ('stage' blocks: the first of each
    layer, those with a downsample); the last passes through, 3x3
    avg-pooled (``count_include_pad=True``) when a stage block strides."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None,
                 scales: int = 4, base_width: int = 26):
        super().__init__()
        width = planes * base_width // 64
        self.width, self.stage = width, downsample is not None
        self.conv1 = _conv(inplanes, width * scales, 1)
        self.bn1 = FrozenBatchNorm(width * scales)
        self.convs = nn.ModuleList(_conv(width, width, 3, stride) for _ in range(scales - 1))
        self.bns = nn.ModuleList(FrozenBatchNorm(width) for _ in range(scales - 1))
        self.pool = nn.AvgPool2d(3, stride, 1) if self.stage and stride != 1 else None
        self.conv3 = _conv(width * scales, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        spx = torch.split(F.relu(self.bn1(self.conv1(x))), self.width, 1)
        sps = []
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            inp = spx[i] if self.stage or i == 0 else sps[-1] + spx[i]
            sps.append(F.relu(bn(conv(inp))))
        # pooled as an NCHW-contiguous copy: on the card (torch 2.11, CUDA
        # 12.8) avg_pool2d's backward with padding is wrong on a
        # channels-last map, such as a channel slice of the trunk's
        # (its forward is right)
        sps.append(spx[-1] if self.pool is None else self.pool(spx[-1].contiguous()))
        return _residual(self, self.bn3(self.conv3(torch.cat(sps, 1))), x)


class SplitAttentionConv(nn.Module):
    """ResNeSt's split-attention 3x3: a conv in ``groups * radix`` groups
    gives ``radix`` branches (branch-major channels, as torch's
    ``view(b, radix, channels, H, W)``); their sum's global mean goes
    through the grouped ``fc1`` -> ``bn1`` -> ReLU -> ``fc2`` (both with a
    bias), whose group-major output is a softmax over the branches (a
    sigmoid when ``radix`` is 1) that weights them."""

    def __init__(self, channels: int, stride: int = 1, groups: int = 1, radix: int = 2,
                 reduction_factor: int = 4):
        super().__init__()
        inter = max(channels * radix // reduction_factor, 32)
        self.radix, self.groups = radix, groups
        self.conv = _conv(channels, channels * radix, 3, stride, groups * radix)
        self.bn0 = FrozenBatchNorm(channels * radix)
        self.fc1 = Conv2d(channels, inter, 1, groups=groups)
        self.bn1 = FrozenBatchNorm(inter)
        self.fc2 = Conv2d(inter, channels * radix, 1, groups=groups)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv(x)))
        b, c, h, w = x.shape
        splits = x.reshape(b, self.radix, c // self.radix, h, w)
        gap = splits.sum(1).mean((2, 3), keepdim=True)
        atten = self.fc2(F.relu(self.bn1(self.fc1(gap)))).reshape(b, self.groups, self.radix, -1)
        atten = atten.softmax(2) if self.radix > 1 else atten.sigmoid()
        atten = atten.transpose(1, 2).reshape(b, self.radix, -1, 1, 1)
        return (atten.to(splits.dtype) * splits).sum(1)


class SplitAttentionBottleneck(nn.Module):
    """ResNeSt's bottleneck: 1x1 -> split-attention 3x3 -> 1x1, the stride
    moved to a 3x3 avg-pool after the attention (``avg_down_stride``); its
    downsample is always avg-down."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None,
                 groups: int = 1, base_width: int = 4, radix: int = 2, reduction_factor: int = 4,
                 avg_down_stride: bool = True):
        super().__init__()
        width = planes if groups == 1 else (planes * base_width // 64) * groups
        avd = avg_down_stride and stride > 1
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = SplitAttentionConv(width, 1 if avd else stride, groups, radix, reduction_factor)
        self.avd_layer = nn.AvgPool2d(3, stride, 1) if avd else None
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.avd_layer is not None:
            out = self.avd_layer(out.contiguous())  # see Bottle2neck.forward
        return _residual(self, self.bn3(self.conv3(out)), x)


class _Backbone(nn.Module):
    """Stages ``layer1..layer4`` after a stem; returns the maps selected by
    ``out_indices``: (0, 1, 2, 3) -> (C2, C3, C4, C5) at strides (4, 8, 16,
    32), NCHW, their widths in ``out_channels``."""

    def _finish(self, stage_widths: Sequence[int], out_indices, frozen_stages: int, norm_eval: bool,
                stem: Sequence[nn.Module]) -> None:
        if not norm_eval:
            raise NotImplementedError(
                "norm_eval=False updates BatchNorm statistics while training "
                "(ROADMAP.md Queue 1 item 18, live BatchNorm and checkpointing)"
            )
        self.num_stages = len(stage_widths)
        self.out_indices = tuple(out_indices)
        self.out_channels = [stage_widths[i] for i in self.out_indices]
        # mmdet _freeze_stages: the stem and the first ``frozen_stages``
        # stages take no gradient
        frozen = list(stem) if frozen_stages >= 0 else []
        frozen += [getattr(self, f"layer{i}") for i in range(1, frozen_stages + 1)]
        for m in frozen:
            m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> None:
        """He normal (fan_out) convs; ResNeSt's gate convs ``fc1``/``fc2``,
        the trunk's only convs with a bias, flax's default LeCun normal
        (truncated at 2 std) and a zero bias; identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                rf = m.kernel_size[0] * m.kernel_size[1]
                if m.bias is None:
                    normal_(m.weight, math.sqrt(2.0 / (m.out_channels * rf)), generator)
                else:
                    trunc_normal_(m.weight, math.sqrt(1.0 / (m.weight.shape[1] * rf)) / 0.87962566103423978,
                                  generator)
                    with torch.no_grad():
                        m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

    def forward(self, x):
        x = self.forward_stem(x)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class ResNet(_Backbone):
    """ResNet by ``depth``, and its variants: ``deep_stem`` (three 3x3 convs
    of 32, 32, 64 as ``stem``) and ``avg_down`` (ResNetV1d), ``groups`` and
    ``base_width`` (ResNeXt: mid width ``planes * base_width // 64 *
    groups``), ``scales`` > 1 (Res2Net's ``Bottle2neck``, avg-down
    always), ``radix`` > 0 (ResNeSt's split attention, avg-down always)."""

    def __init__(
        self,
        depth: int = 50,
        out_indices: Sequence[int] = (0, 1, 2, 3),
        frozen_stages: int = 1,
        norm_eval: bool = True,
        groups: int = 1,
        base_width: int = 4,
        deep_stem: bool = False,
        avg_down: bool = False,
        scales: int = 1,
        radix: int = 0,
        reduction_factor: int = 4,
        avg_down_stride: bool = True,
    ):
        super().__init__()
        if depth not in ARCH:
            raise ValueError(f"ResNet depth {depth}: one of {sorted(ARCH)}")
        kind, stage_blocks = ARCH[depth]
        if kind == "basic" and (scales > 1 or radix > 0):
            raise ValueError(f"{'Res2Net' if scales > 1 else 'ResNeSt'} needs depth >= 50")
        self.deep_stem = deep_stem
        if deep_stem:
            stem = []
            for cin, cout, stride in ((3, 32, 2), (32, 32, 1), (32, 64, 1)):
                stem += [_conv(cin, cout, 3, stride), FrozenBatchNorm(cout), nn.ReLU()]
            self.stem = nn.Sequential(*stem)
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = FrozenBatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        expansion = 1 if kind == "basic" else 4

        def block(cin, planes, stride, downsample):
            if radix > 0:
                return SplitAttentionBottleneck(cin, planes, stride, downsample, groups, base_width, radix,
                                                reduction_factor, avg_down_stride)
            if scales > 1:
                return Bottle2neck(cin, planes, stride, downsample, scales, base_width)
            if kind == "basic":
                return BasicBlock(cin, planes, stride, downsample)
            width = planes * base_width // 64 * groups if groups > 1 else 0
            return Bottleneck(cin, planes, stride, downsample, groups, width)

        inplanes, widths = 64, []
        for i, n in enumerate(stage_blocks):
            planes, stride = 64 * 2**i, 1 if i == 0 else 2
            out = planes * expansion
            downsample = None
            if stride != 1 or inplanes != out:
                downsample = Downsample(inplanes, out, stride, avg_down or scales > 1 or radix > 0)
            blocks = [block(inplanes, planes, stride, downsample)]
            blocks += [block(out, planes, 1, None) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = out
            widths.append(out)
        self._finish(widths, out_indices, frozen_stages, norm_eval,
                     [self.stem] if deep_stem else [self.conv1, self.bn1])

    def forward_stem(self, x):
        x = self.stem(x) if self.deep_stem else F.relu(self.bn1(self.conv1(x)))
        return self.maxpool(x)


class RegNet(_Backbone):
    """RegNetX by preset name (``REGNET_ARCH``): a bare 3x3/2 stem conv of
    ``stem_channels`` and no max-pool, then stages that each stride 2, of
    expansion-1 bottlenecks with the stage's bottleneck width and groups."""

    def __init__(
        self,
        arch: str = "regnetx_3.2gf",
        out_indices: Sequence[int] = (0, 1, 2, 3),
        frozen_stages: int = 1,
        norm_eval: bool = True,
        stem_channels: int = 32,
    ):
        super().__init__()
        if not isinstance(arch, str) or arch not in REGNET_ARCH:
            raise ValueError(f"RegNet arch must be a named preset, one of {sorted(REGNET_ARCH)}; got {arch!r}")
        widths, stage_blocks, bot_widths, groups = regnet_stage_params(REGNET_ARCH[arch])
        self.conv1 = _conv(3, stem_channels, 3, 2)
        self.bn1 = FrozenBatchNorm(stem_channels)
        inplanes = stem_channels
        for i, (w, n, wb, g) in enumerate(zip(widths, stage_blocks, bot_widths, groups)):
            blocks = [Bottleneck(inplanes, w, 2, Downsample(inplanes, w, 2), g, wb, expansion=1)]
            blocks += [Bottleneck(w, w, 1, None, g, wb, expansion=1) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = w
        self._finish(widths, out_indices, frozen_stages, norm_eval, [self.conv1, self.bn1])

    def forward_stem(self, x):
        return F.relu(self.bn1(self.conv1(x)))
