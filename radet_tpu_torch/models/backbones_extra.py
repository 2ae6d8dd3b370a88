"""The extra backbone families that compose with a neck (port of
``radet_tpu/models/backbones_extra.py``), NCHW: Darknet-53, HRNet, SSD-VGG
and DetectoRS ResNet / ResNeXt with Switchable Atrous Convolution.

Each trunk returns a tuple of maps and names their widths in
``out_channels``; its parameters carry mmdet's names, so that a released
checkpoint loads with ``strict=True``:

- :class:`Darknet`: ``conv1.{conv,bn}``, ``conv_res_block{i}.conv.{conv,bn}``,
  ``conv_res_block{i}.res{j}.conv{1,2}.{conv,bn}`` (mmcv ConvModules);
- :class:`HRNet`: ``conv1``/``bn1``/``conv2``/``bn2``, ``layer1.{b}``,
  ``transition{t}.{i}.{0,1}`` (or ``.{j}.{0,1}`` for a new branch),
  ``stage{s}.{m}.branches.{b}.{k}``, ``stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}``
  (or ``.{k}.{0,1}`` down a chain of strided convs);
- :class:`SSDVGG`: ``features.{i}`` at mmcv VGG's indices, ``extra.{i}``,
  ``l2_norm.weight``;
- :class:`DetectoRSResNet`: ResNet's names, a SAC conv2 as
  ``conv2.{weight,weight_diff,weight_gamma,weight_beta}`` and
  ``conv2.{pre_context,switch,post_context}``, ``layer{s}.0.rfp_conv``.

The standalone ``HourglassNet`` and ``TridentResNet`` of the JAX module
are not ported (ROADMAP item 12e).  Every BatchNorm is
``resnet.BatchNorm``; convolutions run in the input's dtype; L2Norm and
SAC's weight standardisation run in float32.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, normal_
from .resnet import ARCH, BasicBlock, BatchNorm, Bottleneck, Downsample, _Backbone, _conv, init_trunk_weights

DARKNET_ARCH = {
    # (res-block repeats per stage, (in, out) channels per stage)
    53: ((1, 2, 8, 8, 4), ((32, 64), (64, 128), (128, 256), (256, 512), (512, 1024))),
}

HRNET_W18 = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(4, 4), num_channels=(18, 36)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC", num_blocks=(4, 4, 4), num_channels=(18, 36, 72)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC", num_blocks=(4, 4, 4, 4),
                num_channels=(18, 36, 72, 144)),
)
HRNET_W32 = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(4, 4), num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC", num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC", num_blocks=(4, 4, 4, 4),
                num_channels=(32, 64, 128, 144 * 2)),
)
HRNET_PRESETS = {"hrnet_w18": HRNET_W18, "hrnet_w32": HRNET_W32}

VGG_STAGE_CONVS = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2), 16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
VGG_STAGE_CHANNELS = (64, 128, 256, 512, 512)
SSD_EXTRA_SETTING = {
    300: (256, "S", 512, 128, "S", 256, 128, 256, 128, 256),
    512: (256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256, 128),
}


def vgg_feature_layout(depth: int, with_last_pool: bool = False):
    """mmcv VGG's ``features`` sequence (a list index is its torch index)
    and SSD's additions: ``("conv", channels, kernel, pad, dilation)``,
    ``("relu",)``, ``("pool", kernel, stride, ceil_mode)``."""
    layout = []
    for stage, n_convs in enumerate(VGG_STAGE_CONVS[depth]):
        for _ in range(n_convs):
            layout.append(("conv", VGG_STAGE_CHANNELS[stage], 3, 1, 1))
            layout.append(("relu",))
        layout.append(("pool", 2, 2, True))
    if not with_last_pool:
        layout.pop()
    # SSD: pool 3x3 stride 1 pad 1, conv6 (1024, 3x3, dilation 6), conv7 (1024, 1x1)
    layout += [("pool", 3, 1, False), ("conv", 1024, 3, 6, 6), ("relu",), ("conv", 1024, 1, 0, 1), ("relu",)]
    return layout


def ssd_extra_layout(input_size: int):
    """(out channels, kernel, stride, pad) of each SSD extra conv: an 'S'
    entry is a stride-2 conv to the next entry's channels (that entry is
    consumed); kernels alternate 1 and 3 in build order."""
    planes = SSD_EXTRA_SETTING[input_size]
    layers, skip = [], False
    for i, p in enumerate(planes):
        if skip:
            skip = False
            continue
        k = (1, 3)[len(layers) % 2]
        if p == "S":
            layers.append((planes[i + 1], k, 2, 1))
            skip = True
        else:
            layers.append((p, k, 1, 0))
    if input_size == 512:
        layers.append((256, 4, 1, 1))
    return layers


def _conv_bias(cin: int, cout: int, kernel: int, stride: int = 1, pad: Optional[int] = None,
               dilation: int = 1) -> Conv2d:
    """Conv with a bias and explicit symmetric padding (default (k - 1) // 2)."""
    pad = (kernel - 1) // 2 if pad is None else pad
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad, dilation=dilation)


def _maxpool_ceil(x, kernel: int, stride: int):
    """``MaxPool2d(kernel, stride, ceil_mode=True)``: the bottom and right
    edges padded with -inf, so that a padded cell never wins."""
    h, w = x.shape[2:]
    ph = (-(h - kernel)) % stride if h > kernel else kernel - h
    pw = (-(w - kernel)) % stride if w > kernel else kernel - w
    return F.max_pool2d(F.pad(x, (0, pw, 0, ph), value=float("-inf")), kernel, stride)


def _upsample_nearest(x, factor: int):
    """Each pixel repeated ``factor`` times down and across."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of ``n`` rows reflect-padded by ``pad`` on both sides
    (numpy's 'reflect', which reflects again where ``pad >= n``)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i > n - 1, period - i, i)


def _reflect_pad(x, pad: int):
    """``jnp.pad(mode='reflect')`` of the two spatial axes, at any size
    (``F.pad``'s reflect refuses a pad as large as the map)."""
    h, w = x.shape[2:]
    x = x.index_select(2, _reflect_index(h, pad, x.device))
    return x.index_select(3, _reflect_index(w, pad, x.device))


class ConvBNLeaky(nn.Module):
    """Darknet's mmcv ConvModule: a bias-free conv as ``conv``, BatchNorm as
    ``bn``, then LeakyReLU(0.1)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


def _set_norm_eval(trunk: nn.Module, norm_eval: bool) -> None:
    for m in trunk.modules():
        if isinstance(m, BatchNorm):
            m.norm_eval = norm_eval


# ---------------------------------------------------------------------------
# Darknet-53
# ---------------------------------------------------------------------------


class _DarknetRes(nn.Module):
    """1x1 to half the width, 3x3 back, added to the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvBNLeaky(channels, channels // 2, 1)
        self.conv2 = ConvBNLeaky(channels // 2, channels, 3)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class Darknet(nn.Module):
    """Darknet-53: a 3x3 stem of 32, then five stages of a 3x3/2 conv and
    residual blocks, every conv BN + LeakyReLU(0.1).  ``out_indices`` index
    [stem, stage1..stage5]: (3, 4, 5) gives C3-C5 at strides 8, 16, 32.
    ``frozen_stages`` freezes the first that many entries of that list."""

    def __init__(self, depth: int = 53, out_indices: Sequence[int] = (3, 4, 5), frozen_stages: int = -1,
                 norm_eval: bool = True):
        super().__init__()
        layers, channels = DARKNET_ARCH[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = ConvBNLeaky(3, 32, 3)
        for i, (n_res, (cin, cout)) in enumerate(zip(layers, channels), start=1):
            stage = [("conv", ConvBNLeaky(cin, cout, 3, 2))]
            stage += [(f"res{j}", _DarknetRes(cout)) for j in range(n_res)]
            self.add_module(f"conv_res_block{i}", nn.Sequential(OrderedDict(stage)))
        widths = [32] + [c for _, c in channels]
        self.out_channels = [widths[i] for i in self.out_indices]
        self.num_stages = len(layers)
        _set_norm_eval(self, norm_eval)
        frozen = [self.conv1] if frozen_stages >= 1 else []
        frozen += [getattr(self, f"conv_res_block{i}") for i in range(1, min(frozen_stages, self.num_stages + 1))]
        for m in frozen:
            m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> None:
        init_trunk_weights(self, generator)

    def forward(self, x):
        x = self.conv1(x)
        outs = [x] if 0 in self.out_indices else []
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"conv_res_block{i}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


# ---------------------------------------------------------------------------
# HRNet
# ---------------------------------------------------------------------------


def _conv_bn_seq(cin: int, cout: int, kernel: int, stride: int, relu: bool) -> nn.Sequential:
    """``Sequential(conv, bn[, ReLU])``: mmdet HRNet's transition and fuse units."""
    mods = [_conv(cin, cout, kernel, stride), BatchNorm(cout)]
    return nn.Sequential(*mods, nn.ReLU()) if relu else nn.Sequential(*mods)


class HRModule(nn.Module):
    """Parallel branches of BasicBlocks, then every branch i takes the sum
    of all branches brought to its resolution and width (j > i: 1x1 conv +
    BN, nearest upsample, cropped; j < i: a chain of 3x3/2 conv + BN, ReLU
    between them), ReLU'd."""

    def __init__(self, num_blocks: Sequence[int], channels: Sequence[int]):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(nn.Sequential(*[BasicBlock(c, c) for _ in range(blocks)])
                                      for blocks, c in zip(num_blocks, channels))
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn_seq(channels[j], channels[i], 1, 1, relu=False))
                elif j < i:
                    chain = [_conv_bn_seq(channels[j], channels[i] if k == i - j - 1 else channels[j], 3, 2,
                                          relu=k != i - j - 1) for k in range(i - j)]
                    row.append(nn.Sequential(*chain))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = xs[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                y = layer(xs[j])
                if j > i:
                    y = _upsample_nearest(y, 2 ** (j - i))[:, :, : acc.shape[2], : acc.shape[3]]
                acc = acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNet: two 3x3/2 stem convs, a Bottleneck stage 1, then stages of
    parallel multi-resolution branches exchanged by fuse layers in each
    HRModule.  Returns stage 4's branches at strides 4, 8, 16, 32.
    ``extra``: a preset name (``HRNET_PRESETS``) or a dict of ``stage1`` to
    ``stage4``.  As in the JAX package (and mmdet), every transition that
    is not None reads the previous stage's last branch."""

    def __init__(self, extra="hrnet_w18", norm_eval: bool = True):
        super().__init__()
        cfg = HRNET_PRESETS[extra] if isinstance(extra, str) else extra
        self.conv1 = _conv(3, 64, 3, 2)
        self.bn1 = BatchNorm(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = BatchNorm(64)
        s1 = cfg["stage1"]
        if s1["block"] != "BOTTLENECK":
            raise AssertionError("HRNet stage1 is a BOTTLENECK stage")
        planes, cin, blocks = s1["num_channels"][0], 64, []
        for b in range(s1["num_blocks"][0]):
            down = Downsample(cin, planes * 4, 1) if b == 0 and cin != planes * 4 else None
            blocks.append(Bottleneck(cin, planes, 1, down))
            cin = planes * 4
        self.layer1 = nn.Sequential(*blocks)
        pre = [cin]
        for s in (2, 3, 4):
            scfg = cfg[f"stage{s}"]
            if scfg["block"] != "BASIC":
                raise AssertionError("post-stage1 HRNet blocks are BASIC")
            cur = list(scfg["num_channels"])
            trans = []
            for i in range(scfg["num_branches"]):
                if i < len(pre):
                    trans.append(_conv_bn_seq(pre[-1], cur[i], 3, 1, relu=True) if cur[i] != pre[i] else None)
                else:
                    n_down = i + 1 - len(pre)
                    trans.append(nn.Sequential(*[
                        _conv_bn_seq(pre[-1], cur[i] if j == n_down - 1 else pre[-1], 3, 2, relu=True)
                        for j in range(n_down)]))
            # every branch enters the stage at its own width: no block needs a downsample
            self.add_module(f"transition{s - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{s}", nn.Sequential(*[HRModule(scfg["num_blocks"], cur)
                                                        for _ in range(scfg["num_modules"])]))
            pre = cur
        self.out_channels = list(pre)
        _set_norm_eval(self, norm_eval)

    def init_weights(self, generator: torch.Generator) -> None:
        init_trunk_weights(self, generator)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for s in (2, 3, 4):
            xs = [ys[i] if t is None else t(ys[-1]) for i, t in enumerate(getattr(self, f"transition{s - 1}"))]
            for module in getattr(self, f"stage{s}"):
                xs = module(xs)
            ys = xs
        return tuple(ys)


# ---------------------------------------------------------------------------
# SSD-VGG
# ---------------------------------------------------------------------------


class _Pool(nn.Module):
    """A ``features`` pool: 2x2/2 in ceil mode, or SSD's 3x3/1 pad 1."""

    def __init__(self, kernel: int, stride: int, ceil: bool):
        super().__init__()
        self.kernel, self.stride, self.ceil = kernel, stride, ceil

    def forward(self, x):
        if self.ceil:
            return _maxpool_ceil(x, self.kernel, self.stride)
        return F.max_pool2d(x, self.kernel, self.stride, 1)


class L2Norm(nn.Module):
    """Each pixel's channel vector over its L2 norm (+1e-10), times a
    per-channel ``weight``, in float32; the result in the input's dtype."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x):
        x0 = x.float()
        norm = torch.sqrt((x0 * x0).sum(1, keepdim=True)) + 1e-10
        return (self.weight[:, None, None] * x0 / norm).to(x.dtype)


class SSDVGG(nn.Module):
    """SSD's VGG trunk: mmcv VGG features with ceil-mode pools and no last
    pool, SSD's 3x3/1 pool, dilation-6 conv6 and 1x1 conv7, the extra convs
    (an output after every second one) and L2Norm on the first output.
    Convs carry biases; there is no BatchNorm."""

    def __init__(self, input_size: int = 300, depth: int = 16, out_feature_indices: Sequence[int] = (22, 34),
                 l2_norm_scale: float = 20.0):
        super().__init__()
        self.out_feature_indices = tuple(out_feature_indices)
        features, cin, widths = [], 3, []
        for spec in vgg_feature_layout(depth):
            if spec[0] == "conv":
                _, c, k, pad, dil = spec
                features.append(_conv_bias(cin, c, k, 1, pad, dil))
                cin = c
            elif spec[0] == "relu":
                features.append(nn.ReLU())
            else:
                features.append(_Pool(*spec[1:]))
            widths.append(cin)
        self.features = nn.ModuleList(features)
        self.out_channels = [widths[i] for i in self.out_feature_indices]
        extra = []
        for i, (c, k, stride, pad) in enumerate(ssd_extra_layout(input_size)):
            extra.append(_conv_bias(cin, c, k, stride, pad))
            cin = c
            if i % 2 == 1:
                self.out_channels.append(c)
        self.extra = nn.ModuleList(extra)
        self.l2_norm = L2Norm(self.out_channels[0], l2_norm_scale)

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun normal convs (flax's default), zero biases; L2Norm at its scale."""
        init_trunk_weights(self, generator)
        with torch.no_grad():
            self.l2_norm.weight.fill_(self.l2_norm.scale)

    def forward(self, x):
        outs = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.out_feature_indices:
                outs.append(x)
        for i, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if i % 2 == 1:
                outs.append(x)
        outs[0] = self.l2_norm(outs[0])
        return tuple(outs)


# ---------------------------------------------------------------------------
# DetectoRS: SAC, its bottleneck and trunk
# ---------------------------------------------------------------------------


class SAConv(nn.Module):
    """Switchable Atrous Convolution (mmcv's SAConv2d, ConvAWS2d's weight
    standardisation): the weight standardised per output channel with the
    unbiased variance, in float32, then ``gamma * w + beta``; a global-mean
    pre-context (1x1 conv with bias) added to the input; the switch, a 1x1
    conv at the conv's stride on a 5x5 mean of the reflect-padded input;
    ``switch * conv(w, d) + (1 - switch) * conv(w + weight_diff, 3d)``; a
    global-mean post-context added."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.kernel, self.stride, self.dilation, self.groups = kernel, stride, dilation, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kernel, kernel))
        self.weight_diff = nn.Parameter(torch.zeros(cout, cin // groups, kernel, kernel))
        self.weight_gamma = nn.Parameter(torch.ones(cout, 1, 1, 1))
        self.weight_beta = nn.Parameter(torch.zeros(cout, 1, 1, 1))
        self.pre_context = _conv_bias(cin, cin, 1)
        self.switch = _conv_bias(cin, 1, 1, stride, 0)
        self.post_context = _conv_bias(cout, cout, 1)

    def _standardized_weight(self) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean((1, 2, 3), keepdim=True)
        var = ((w - mean) ** 2).sum((1, 2, 3), keepdim=True) / (w[0].numel() - 1)
        return self.weight_gamma * ((w - mean) / torch.sqrt(var + 1e-5)) + self.weight_beta

    def _dilated(self, x, w, d: int):
        return F.conv2d(x, w.to(x.dtype), None, self.stride, d * (self.kernel - 1) // 2, d, self.groups)

    def forward(self, x):
        x = x + self.pre_context(x.mean((2, 3), keepdim=True))
        switch = self.switch(F.avg_pool2d(_reflect_pad(x, 2), 5, 1))
        w = self._standardized_weight()
        out = switch * self._dilated(x, w, self.dilation) + (1 - switch) * self._dilated(
            x, w + self.weight_diff, 3 * self.dilation)
        return out + self.post_context(out.mean((2, 3), keepdim=True))


class DetectoRSBottleneck(nn.Module):
    """ResNet's bottleneck whose 3x3 is a SAC conv with ``sac``, and with
    ``rfp_inplanes`` a 1x1 ``rfp_conv`` (with bias) that adds a recursive
    feature pyramid's map before the last ReLU.  ``width``: the mid width
    (0: ``planes``; DetectoRS_ResNeXt sets it and ``groups``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None,
                 sac: bool = False, rfp_inplanes: int = 0, width: int = 0, groups: int = 1):
        super().__init__()
        width = width or planes
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = SAConv(width, width, 3, stride, groups=groups) if sac else _conv(width, width, 3, stride,
                                                                                      groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample
        self.rfp_conv = _conv_bias(rfp_inplanes, planes * 4, 1) if rfp_inplanes else None

    def forward(self, x, rfp_feat=None):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        out = out + (x if self.downsample is None else self.downsample(x))
        if self.rfp_conv is not None and rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


class DetectoRSResNet(_Backbone):
    """DetectoRS ResNet (and ResNeXt with ``groups`` > 1): ResNet's 7x7 stem
    and stages, SAC 3x3s in the stages ``stage_with_sac`` selects, with
    ``rfp_inplanes`` an ``rfp_conv`` in the first block of stages 2-4 (fed
    by ``forward(x, rfp_feats)``: one map per stage), and ``output_img``
    putting the input image first among the outputs."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (0, 1, 2, 3),
                 stage_with_sac: Sequence[bool] = (False, False, False, False), rfp_inplanes: int = 0,
                 output_img: bool = False, groups: int = 1, base_width: int = 4, frozen_stages: int = 1,
                 norm_eval: bool = True):
        super().__init__()
        kind, stage_blocks = ARCH[depth]
        if kind != "bottleneck":
            raise AssertionError("DetectoRS needs depth >= 50")
        self.rfp_inplanes, self.output_img = rfp_inplanes, output_img
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, widths = 64, []
        for i, n in enumerate(stage_blocks):
            planes, stride = 64 * 2**i, 1 if i == 0 else 2
            width = planes * base_width // 64 * groups if groups > 1 else 0
            rfp = rfp_inplanes if i > 0 else 0
            blocks = []
            for b in range(n):
                down = Downsample(inplanes, planes * 4, stride) if b == 0 and (stride != 1 or inplanes != planes * 4) \
                    else None
                blocks.append(DetectoRSBottleneck(inplanes, planes, stride if b == 0 else 1, down,
                                                  bool(stage_with_sac[i]), rfp if b == 0 else 0, width, groups))
                inplanes = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            widths.append(inplanes)
        self._finish(widths, out_indices, frozen_stages, norm_eval, False, [self.conv1, self.bn1])
        if output_img:
            self.out_channels = [3] + self.out_channels

    def init_weights(self, generator: torch.Generator) -> None:
        """:func:`init_trunk_weights`, and SAC's weights as the JAX package's:
        ``weight`` He normal (fan_out), ``weight_diff`` and ``weight_beta``
        0, ``weight_gamma`` 1."""
        init_trunk_weights(self, generator)
        for m in self.modules():
            if isinstance(m, SAConv):
                k = m.weight.shape
                normal_(m.weight, (2.0 / (k[0] * k[2] * k[3])) ** 0.5, generator)
                with torch.no_grad():
                    m.weight_diff.zero_()
                    m.weight_gamma.fill_(1.0)
                    m.weight_beta.zero_()

    def forward(self, x, rfp_feats=None):
        outs = [x] if self.output_img else []
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            rfp = rfp_feats[i] if rfp_feats is not None and self.rfp_inplanes and i > 0 else None
            for b, block in enumerate(getattr(self, f"layer{i + 1}")):
                x = block(x, rfp if b == 0 else None)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


def make_backbone(btype: str, opts: Dict[str, Any], norm_eval: bool, frozen_stages: int) -> nn.Module:
    """One of the families from a ``model.backbone`` config dict (the keys
    each mmdet class takes), as the JAX package's ``make_backbone``."""
    opts = dict(opts)
    if btype == "Darknet":
        return Darknet(opts.get("depth", 53), tuple(opts.get("out_indices", (3, 4, 5))), frozen_stages, norm_eval)
    if btype == "HRNet":
        return HRNet(opts.get("extra", "hrnet_w18"), norm_eval)
    if btype == "SSDVGG":
        return SSDVGG(opts.get("input_size", 300), opts.get("depth", 16),
                      tuple(opts.get("out_feature_indices", (22, 34))), opts.get("l2_norm_scale", 20.0))
    if btype in ("DetectoRS_ResNet", "DetectoRS_ResNeXt"):
        default_sac = (False, True, True, True) if opts.get("sac") is not None else (False,) * 4
        return DetectoRSResNet(
            depth=opts.get("depth", 50),
            out_indices=tuple(opts.get("out_indices", (0, 1, 2, 3))),
            stage_with_sac=tuple(opts.get("stage_with_sac", default_sac)),
            rfp_inplanes=opts.get("rfp_inplanes") or 0,
            output_img=opts.get("output_img", False),
            groups=opts.get("groups", 32 if btype == "DetectoRS_ResNeXt" else 1),
            base_width=opts.get("base_width", 4),
            frozen_stages=frozen_stages,
            norm_eval=norm_eval,
        )
    raise ValueError(f"unknown extra backbone type {btype!r}")
