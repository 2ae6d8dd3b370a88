"""The ResNet backbone zoo, float (port of ``radet_tpu/models/resnet.py``).

ResNet at depths 18, 34, 50, 101 and 152, with ResNetV1d's deep stem and
avg-down residual path, ResNeXt's grouped 3x3, Res2Net's ``Bottle2neck``
and ResNeSt's split-attention bottleneck; and RegNetX
(:class:`RegNet`).  'pytorch' style (stride on the 3x3 conv).  BatchNorm
is frozen to its running statistics by default (mmcv ``norm_eval=True``;
the reference never updates BN while training a detector); with
``norm_eval=False`` it normalizes with batch statistics in training mode
and updates its running statistics, in every stage, frozen or not, as the
JAX package does.  ``with_cp`` checkpoints every residual block (flax's
``nn.remat``).  Parameter names follow
mmdet (``layer1.0.conv1.weight``, ``stem.3.weight``,
``layer2.0.convs.1.weight``, ``layer1.0.conv2.fc1.bias``,
``layer1.0.downsample.1.running_var``), so a released checkpoint loads
with ``strict=True``.  ``quant`` gives the plain and ResNeXt trunks the
JAX package's int8 deploy arithmetic at eval (``QUANT_LEVELS``; the
parameters stay the float convs'), and with ``qat`` its quantization-aware
training: the same arithmetic, fake-quantized, in training mode.
``frozen_int8`` runs the frozen stem and stages of a float trunk on the
'int8_stream' deploy arithmetic in training mode.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.quant import (
    INV127,
    affine_act_scale,
    fake_quant_ste,
    int8_conv_forward,
    qat_conv_forward,
    quantize_int8,
)
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


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    """The context of a checkpointed block's recompute in backward: its
    BatchNorms leave their running statistics alone, so that a step updates
    them once (flax's ``nn.remat`` keeps the primal forward's mutation only)."""
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = False


def _checkpoint_contexts():
    return contextlib.nullcontext(), _recomputing()


class BatchNorm(nn.Module):
    """BatchNorm with eps 1e-5 (counterpart of ``FrozenAwareBN``).

    With ``norm_eval`` (mmcv's default, set by the backbone) it applies its
    running statistics as a fixed affine in training and eval alike.
    Without it, in training mode, it normalizes with the batch's statistics
    over (N, H, W) in float32 at least (mean and E[x^2] - mean^2 clipped at
    0, as flax's ``_compute_stats``) and updates ``running = 0.9 running +
    0.1 batch`` with the biased variance (flax's ``momentum=0.9``; not
    ``torch.nn.BatchNorm2d``'s unbiased one).  ``weight``/``bias`` are
    parameters; mean and variance are buffers."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.norm_eval = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # mmdet checkpoints carry BatchNorm's step counter; flax keeps none
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        if self.norm_eval or not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        if not getattr(_RECOMPUTE, "active", False):
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


# Deploy-time int8 (eval only; the JAX package's ``quant`` levels):
# 'int8' runs every bottleneck's conv2 and conv3 (a BasicBlock's conv2) in
# int8 with static per-channel activation scales from the preceding frozen
# BatchNorm's affine; 'int8_conv2' only the 3x3; 'int8_stream' also carries
# the residual stream between blocks as int8, its per-channel bound
# accumulated across blocks (means add linearly, variances in quadrature),
# so that conv1 and the downsample consume it directly.  With ``qat``,
# training runs the same grid as fake quantization: the scales are taken
# with their gradient (they reach the BatchNorm affines through the folds).
QUANT_LEVELS = ("int8", "int8_conv2", "int8_stream")
_STREAM_K = 4.0  # k of every static k-sigma bound in the trunk


def _bn_affine_stats(bn: BatchNorm):
    """(|mean| bound, variance) per channel of a frozen BatchNorm's output:
    (|beta|, gamma^2)."""
    return bn.bias.abs(), bn.weight ** 2


def _stream_scale(stats):
    """(mean bound, variance) -> per-channel int8 scale of the stream,
    ``max(mean + 4 sqrt(var), 1e-6) / 127``."""
    mean_b, var_b = stats
    return (mean_b + _STREAM_K * torch.sqrt(var_b)).clamp(min=1e-6) * INV127


def _max_pool_int8(x):
    """``MaxPool2d(3, stride=2, padding=1)`` on int8 NCHW, padded with -128
    as the JAX package's ``reduce_window``; max commutes with the monotone
    quantization, so this equals quantizing the float pool."""
    h, w = x.shape[2:]
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (1, 1, 1, 1), value=-128)
    out = None
    for r in range(3):
        for c in range(3):
            tap = xp[:, :, r:r + 2 * ho - 1:2, c:c + 2 * wo - 1:2]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def _bn_act_scale(bn: BatchNorm):
    """Static per-channel int8 scales of a frozen BatchNorm + ReLU output
    (the affine's k-sigma bound, k = 4)."""
    return affine_act_scale(bn.weight, bn.bias, _STREAM_K)


def _q8_conv(conv: nn.Module, x, x_scale, dtype, qat: bool = False):
    """``conv`` run as the JAX package's ``Int8Conv`` (bfloat16 output),
    handed on in the trunk's compute ``dtype`` (the JAX BatchNorm that
    follows computes from the bfloat16 values in its own dtype): the deploy
    arithmetic on an int8 ``x`` (a float one is quantized here at
    ``x_scale``), or with ``qat`` its fake-quantized float form."""
    if qat:
        return qat_conv_forward(conv, x, x_scale).to(dtype)
    if x.dtype != torch.int8:
        x = quantize_int8(x, x_scale)
    return int8_conv_forward(conv, x, x_scale).to(dtype)


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
        mods = [_conv(cin, cout, 1, 1 if avg_down else stride), BatchNorm(cout)]
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


def _quant_live(block: nn.Module) -> bool:
    """Whether ``block``'s quantized arithmetic runs: at eval with a
    ``quant`` level, and in training with ``qat`` as well."""
    return block.quant is not None and (block.qat or not block.training)


class BasicBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34), stride on the first; ``quant`` 'int8'
    or 'int8_conv2' runs conv2 in int8 at eval (``qat``: fake-quantized in
    training)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None,
                 quant: Optional[str] = None, qat: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = downsample
        self.quant, self.qat = quant, qat

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if _quant_live(self):
            out = _q8_conv(self.conv2, out, _bn_act_scale(self.bn1), x.dtype, self.training)
        else:
            out = self.conv2(out)
        return _residual(self, self.bn2(out), x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, ``groups``) -> 1x1 to ``planes * expansion``;
    ``width`` is the mid width (0: ``planes``).  ResNeXt passes its groups
    and width, RegNet expansion 1 and its stage's groups and width.  At
    eval, ``quant`` (one of ``QUANT_LEVELS``) runs conv2 in int8, and conv3
    too unless it is 'int8_conv2' (:meth:`forward_int8`); with ``qat``,
    training runs them fake-quantized."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: Optional[nn.Module] = None,
                 groups: int = 1, width: int = 0, expansion: int = 4, quant: Optional[str] = None,
                 qat: bool = False):
        super().__init__()
        self.quant, self.qat = quant, qat
        width = width or planes
        out = planes * expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = downsample

    def forward(self, x, stream=None, dtype=None):
        """``stream`` and ``dtype``: see :meth:`forward_int8` ('int8_stream')."""
        if _quant_live(self):
            return self.forward_int8(x, x.dtype if dtype is None else dtype, stream, self.training)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return _residual(self, self.bn3(self.conv3(out)), x)

    def forward_int8(self, x, dtype, stream=None, qat: bool = False):
        """The int8 deploy arithmetic in the trunk's compute ``dtype`` (with
        ``qat``, its fake-quantized float form).  With ``stream`` (the (mean
        bound, variance) of the int8 input ``x``, as 'int8_stream' carries
        it; under ``qat`` ``x`` is the fake-quantized stream), conv1 and the
        downsample conv consume ``x`` with the per-channel scales folded
        into their weights, and the block returns (its int8 output, the
        stats of that output).  A block carrying a stream runs the
        'int8_stream' level whatever its ``quant`` (a frozen_int8 trunk's
        float blocks carry one)."""
        if stream is not None:
            s_in = _stream_scale(stream)
            out = _q8_conv(self.conv1, x, s_in, dtype, qat)
        else:
            out = self.conv1(x)
        out = F.relu(self.bn1(out))
        out = F.relu(self.bn2(_q8_conv(self.conv2, out, _bn_act_scale(self.bn1), dtype, qat)))
        if stream is None and self.quant == "int8_conv2":
            out = self.conv3(out)
        else:
            out = _q8_conv(self.conv3, out, _bn_act_scale(self.bn2), dtype, qat)
        out = self.bn3(out)
        if stream is None:
            return _residual(self, out, x)
        # XLA contracts a product that feeds an add into one fused
        # multiply-add (``torch.addcmul``, rounded once): the dequantized
        # stream's add, and bn3's gamma^2 into the variance bound
        if self.downsample is not None:
            ds_conv, ds_bn = self.downsample
            y = F.relu(out + ds_bn(_q8_conv(ds_conv, x, s_in, dtype, qat)))
            id_stats = _bn_affine_stats(ds_bn)
        elif qat:
            y = F.relu(out + x)  # the fake-quantized stream is its own dequantization
            id_stats = stream
        else:
            # the stream dequantized for the add, in float32 (the JAX add's promotion)
            y = F.relu(torch.addcmul(out.float(), x.float(), s_in[:, None, None]))
            id_stats = stream
        gamma3 = self.bn3.weight
        stats = (self.bn3.bias.abs() + id_stats[0], torch.addcmul(id_stats[1], gamma3, gamma3))
        s_out = _stream_scale(stats)
        if qat:
            return fake_quant_ste(y, s_out[:, None, None]), stats
        return quantize_int8(y, s_out), stats


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
        self.bn1 = BatchNorm(width * scales)
        self.convs = nn.ModuleList(_conv(width, width, 3, stride) for _ in range(scales - 1))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(scales - 1))
        self.pool = nn.AvgPool2d(3, stride, 1) if self.stage and stride != 1 else None
        self.conv3 = _conv(width * scales, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
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
        self.bn0 = BatchNorm(channels * radix)
        self.fc1 = Conv2d(channels, inter, 1, groups=groups)
        self.bn1 = BatchNorm(inter)
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
        self.bn1 = BatchNorm(width)
        self.conv2 = SplitAttentionConv(width, 1 if avd else stride, groups, radix, reduction_factor)
        self.avd_layer = nn.AvgPool2d(3, stride, 1) if avd else None
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.avd_layer is not None:
            out = self.avd_layer(out.contiguous())  # see Bottle2neck.forward
        return _residual(self, self.bn3(self.conv3(out)), x)


def init_trunk_weights(trunk: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's trunk initialisers on every conv and BatchNorm of
    ``trunk``: He normal (fan_out) bias-free convs; convs with a bias
    (ResNeSt's gate convs ``fc1``/``fc2``, SSD-VGG's, SAC's context and
    switch convs) flax's default LeCun normal (truncated at 2 std) and a
    zero bias; identity BatchNorm."""
    for m in trunk.modules():
        if isinstance(m, Conv2d):
            rf = m.kernel_size[0] * m.kernel_size[1]
            if m.bias is None:
                normal_(m.weight, math.sqrt(2.0 / (m.out_channels * rf)), generator)
            else:
                trunc_normal_(m.weight, math.sqrt(1.0 / (m.weight.shape[1] * rf)) / 0.87962566103423978,
                              generator)
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


class _Backbone(nn.Module):
    """Stages ``layer1..layer4`` after a stem; returns the maps selected by
    ``out_indices``: (0, 1, 2, 3) -> (C2, C3, C4, C5) at strides (4, 8, 16,
    32), NCHW, their widths in ``out_channels``."""

    def _finish(self, stage_widths: Sequence[int], out_indices, frozen_stages: int, norm_eval: bool,
                with_cp: bool, stem: Sequence[nn.Module]) -> None:
        self.num_stages = len(stage_widths)
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.out_channels = [stage_widths[i] for i in self.out_indices]
        self.with_cp = with_cp
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.norm_eval = norm_eval
        # the stem and the first ``frozen_stages`` stages take no gradient;
        # their BatchNorms follow the module's mode all the same (the JAX
        # package's stop_gradient and optimizer mask, not mmdet's eval())
        frozen = list(stem) if frozen_stages >= 0 else []
        frozen += [getattr(self, f"layer{i}") for i in range(1, frozen_stages + 1)]
        for m in frozen:
            m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> None:
        """:func:`init_trunk_weights`."""
        init_trunk_weights(self, generator)

    def forward(self, x):
        return self.forward_stages(self.forward_stem(x))

    def forward_stages(self, x, first: int = 0, outs=()):
        """Stages ``first`` onwards on ``x``; their taps follow ``outs``."""
        # with_cp: each block's activations are recomputed in backward
        cp = self.with_cp and self.training and torch.is_grad_enabled()
        outs = list(outs)
        for i in range(first, self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = checkpoint(block, x, use_reentrant=False, context_fn=_checkpoint_contexts) if cp else block(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class ResNet(_Backbone):
    """ResNet by ``depth``, and its variants: ``deep_stem`` (three 3x3 convs
    of 32, 32, 64 as ``stem``) and ``avg_down`` (ResNetV1d), ``groups`` and
    ``base_width`` (ResNeXt: mid width ``planes * base_width // 64 *
    groups``), ``scales`` > 1 (Res2Net's ``Bottle2neck``, avg-down
    always), ``radix`` > 0 (ResNeSt's split attention, avg-down always).

    ``quant`` (one of ``QUANT_LEVELS``, plain and ResNeXt blocks only) is
    the int8 deploy arithmetic at eval; in training mode the trunk is the
    float one, as in the JAX package.  With 'int8_stream' (plain 7x7 stem
    and strided 1x1 downsample only) the stem's BN + ReLU output is
    quantized, max-pooled in int8, carried through every block as int8 and
    dequantized at the taps.  ``qat`` and ``frozen_int8`` are accepted with
    the JAX package's conditions; at eval a QAT trunk runs the deploy
    arithmetic, in training its fake-quantized form (the stem's output
    fake-quantized before a float max-pool under 'int8_stream', the float
    stream handed out at the taps; ``with_cp`` checkpoints the
    stream-carrying blocks too).  A ``frozen_int8`` trunk runs the float
    path at eval; in training (``frozen_stages >= 0``) its frozen stem and
    first ``frozen_stages`` stages run the 'int8_stream' arithmetic
    (:meth:`forward_frozen_int8`) and the stages after them the float one."""

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
        with_cp: bool = False,
        quant: Optional[str] = None,
        qat: bool = False,
        frozen_int8: bool = False,
    ):
        super().__init__()
        if depth not in ARCH:
            raise ValueError(f"ResNet depth {depth}: one of {sorted(ARCH)}")
        kind, stage_blocks = ARCH[depth]
        if kind == "basic" and (scales > 1 or radix > 0):
            raise ValueError(f"{'Res2Net' if scales > 1 else 'ResNeSt'} needs depth >= 50")
        _check_quant(kind, quant, qat, frozen_int8, norm_eval, deep_stem, avg_down, scales, radix)
        self.quant, self.qat, self.frozen_int8 = quant, qat, frozen_int8
        self.deep_stem = deep_stem
        if deep_stem:
            stem = []
            for cin, cout, stride in ((3, 32, 2), (32, 32, 1), (32, 64, 1)):
                stem += [_conv(cin, cout, 3, stride), BatchNorm(cout), nn.ReLU()]
            self.stem = nn.Sequential(*stem)
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        expansion = 1 if kind == "basic" else 4

        def block(cin, planes, stride, downsample):
            if radix > 0:
                return SplitAttentionBottleneck(cin, planes, stride, downsample, groups, base_width, radix,
                                                reduction_factor, avg_down_stride)
            if scales > 1:
                return Bottle2neck(cin, planes, stride, downsample, scales, base_width)
            if kind == "basic":
                return BasicBlock(cin, planes, stride, downsample, quant, qat)
            width = planes * base_width // 64 * groups if groups > 1 else 0
            return Bottleneck(cin, planes, stride, downsample, groups, width, quant=quant, qat=qat)

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
        self._finish(widths, out_indices, frozen_stages, norm_eval, with_cp,
                     [self.stem] if deep_stem else [self.conv1, self.bn1])

    def forward_stem(self, x):
        x = self.stem(x) if self.deep_stem else F.relu(self.bn1(self.conv1(x)))
        return self.maxpool(x)

    def forward(self, x):
        if self.frozen_int8 and self.training and self.frozen_stages >= 0:
            return self.forward_frozen_int8(x)
        qat = self.qat and self.training
        if self.quant != "int8_stream" or (self.training and not qat):
            return super().forward(x)
        if not qat:
            return tuple(self._stream_prefix(x, self.num_stages)[2])
        dtype = x.dtype
        x = F.relu(self.bn1(self.conv1(x)))
        stream = _bn_affine_stats(self.bn1)
        # max commutes with the fake quantization as with the int8 one
        x = self.maxpool(fake_quant_ste(x, _stream_scale(stream)[:, None, None]))
        cp = self.with_cp and torch.is_grad_enabled()
        outs = []
        for i in range(self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                if cp:
                    x, stream = checkpoint(block, x, stream, dtype, use_reentrant=False,
                                           context_fn=_checkpoint_contexts)
                else:
                    x, stream = block(x, stream, dtype)
            if i in self.out_indices:
                outs.append(x.to(dtype))
        return tuple(outs)

    def _stream_prefix(self, x, n_stages: int):
        """The 'int8_stream' deploy arithmetic of the stem and the first
        ``n_stages`` stages: the stem's BN + ReLU output quantized and
        max-pooled in int8, each block carrying the stream.  Returns (the
        int8 stream, its stats, the taps among those stages dequantized)."""
        dtype = x.dtype
        x = F.relu(self.bn1(self.conv1(x)))
        stream = _bn_affine_stats(self.bn1)
        x = _max_pool_int8(quantize_int8(x, _stream_scale(stream)))
        outs = []
        for i in range(n_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x, stream = block.forward_int8(x, dtype, stream)
            if i in self.out_indices:
                outs.append(_dequantized(x, stream, dtype))
        return x, stream, outs

    def forward_frozen_int8(self, x):
        """The training forward of ``frozen_int8``, as the JAX package's: the
        stem and the first ``frozen_stages`` stages on the 'int8_stream'
        deploy arithmetic (:meth:`_stream_prefix`), the last frozen stage's
        stream (the stem's, at ``frozen_stages`` 0) dequantized for the
        first trainable stage, which runs on as the float trunk does
        (checkpointed with ``with_cp``).  The frozen prefix runs without
        autograd: it takes no gradient, and the int8 convolution has none."""
        dtype = x.dtype
        frozen = min(self.frozen_stages, self.num_stages)
        with torch.no_grad():
            x, stream, outs = self._stream_prefix(x, frozen)
            # the last frozen stage's tap is its dequantized output
            x = outs[-1] if frozen - 1 in self.out_indices else _dequantized(x, stream, dtype)
        return self.forward_stages(x, frozen, outs)


def _dequantized(x, stream, dtype):
    """The int8 stream ``x`` with its stats ``stream`` in float32, cast to ``dtype``."""
    return (x.float() * _stream_scale(stream)[:, None, None]).to(dtype)


def _check_quant(kind, quant, qat, frozen_int8, norm_eval, deep_stem, avg_down, scales, radix) -> None:
    """The JAX ResNet's conditions on ``quant``, ``qat`` and ``frozen_int8``,
    as AssertionErrors (its asserts)."""
    if qat and (quant is None or not norm_eval):
        raise AssertionError("ResNet.qat needs a quant level and norm_eval=True (the static scales read frozen "
                             "running stats)")
    if quant is not None:
        if quant not in QUANT_LEVELS:
            raise AssertionError(f"ResNet.quant: {quant!r}")
        if scales != 1 or radix != 0:
            raise AssertionError("int8 trunk quantization is implemented for the plain/ResNeXt Bottleneck and "
                                 "BasicBlock; Res2Net/ResNeSt blocks are not wired")
        if quant == "int8_stream" and (kind != "bottleneck" or deep_stem or avg_down):
            raise AssertionError("int8_stream carries the residual stream as int8 and is wired for the "
                                 "plain/ResNeXt Bottleneck stem+trunk only (deep_stem/avg_down variants: use "
                                 "quant='int8')")
    if frozen_int8:
        if quant is not None or qat:
            raise AssertionError("ResNet.frozen_int8 is the float-training lever; quant/qat configs already "
                                 "define their own quantized arithmetic")
        if kind != "bottleneck" or deep_stem or avg_down or scales != 1 or radix != 0:
            raise AssertionError("frozen_int8 reuses the int8_stream deploy path and is wired for the "
                                 "plain/ResNeXt Bottleneck stem+trunk only")
        if not norm_eval:
            raise AssertionError("frozen_int8 derives static scales from frozen BN running stats "
                                 "(norm_eval=True required)")


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
        with_cp: bool = False,
    ):
        super().__init__()
        if not isinstance(arch, str) or arch not in REGNET_ARCH:
            raise ValueError(f"RegNet arch must be a named preset, one of {sorted(REGNET_ARCH)}; got {arch!r}")
        widths, stage_blocks, bot_widths, groups = regnet_stage_params(REGNET_ARCH[arch])
        self.conv1 = _conv(3, stem_channels, 3, 2)
        self.bn1 = BatchNorm(stem_channels)
        inplanes = stem_channels
        for i, (w, n, wb, g) in enumerate(zip(widths, stage_blocks, bot_widths, groups)):
            blocks = [Bottleneck(inplanes, w, 2, Downsample(inplanes, w, 2), g, wb, expansion=1)]
            blocks += [Bottleneck(w, w, 1, None, g, wb, expansion=1) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = w
        self._finish(widths, out_indices, frozen_stages, norm_eval, with_cp, [self.conv1, self.bn1])

    def forward_stem(self, x):
        return F.relu(self.bn1(self.conv1(x)))
