"""Deploy-time int8 quantization (port of ``radet_tpu/ops/quant.py``, the
deploy branch; quantization-aware training is ROADMAP item 14b).

Weights are quantized per output channel, symmetrically, from the live
float32 kernel at every call; activations symmetrically with a static
scale (per channel, from the preceding normalization layer's affine, see
:func:`affine_act_scale`) or, for an unbounded float input, the tensor's
dynamic absmax.  The convolution accumulates exactly in int32 and the
dequantized output ``float(acc) * (s_x * s_w) (+ bias)`` is stored in
``out_dtype``, bfloat16 by default even in a float32 model, as the JAX
package's ``Int8Conv`` does.  :func:`int8_conv_forward` runs on a float
conv's own parameters (``weight``, and ``bias`` when it has one), so every
checkpoint loads unchanged: int8 is a switch at deploy time.

:func:`int8_conv` is the convolution's entry point: the hand-written kernel
(``ops/int8_conv_cuda.py``, ``csrc/int8_conv.cu``) for CUDA tensors,
:func:`int8_conv_plain` for CPU tensors, through the PyTorch operator
``torch.ops.radet_tpu_torch.int8_conv`` (``torch.library``: CPU = the plain
version, CUDA = the kernel, fake = the output shape), so that
``torch.export`` carries the kernel.  A CUDA tensor launches the kernel or
raises.

Arithmetic order, as the JAX package's compiled program has it:
``round(x / s)`` as a true division, rounding half to even, clipped to
[-127, 127]; every division by the constant 127 a multiplication by its
float32 reciprocal (XLA rewrites ``a / 127.0`` so: :data:`INV127`); the
product ``s_x * s_w`` first, then the int32 sum (converted to float32) times
it, then the cast; with a bias, ``float(acc) * (s_x * s_w) + bias`` is one
fused multiply-add, rounded once (XLA contracts the multiply and the add).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from .int8_conv_cuda import conv_output_hw, int8_conv_cuda

# float32(1 / 127): XLA compiles ``a / 127.0`` to ``a * INV127``
INV127 = float(np.float32(1.0) / np.float32(127.0))
QAT_TRAINING = "ROADMAP.md Queue 1 item 14b, int8 training"


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization of an NCHW tensor; ``scale`` is a scalar
    (per tensor) or a (C,) vector (per channel)."""
    if torch.is_tensor(scale) and scale.dim() == 1:
        scale = scale[:, None, None]
    return torch.round(x.float() / scale).clamp_(-127, 127).to(torch.int8)


def affine_act_scale(gamma: torch.Tensor, beta: torch.Tensor, k: float = 8.0) -> torch.Tensor:
    """Static per-channel activation scales from a norm layer's affine:
    ``max(k |gamma_c| + |beta_c|, 1e-6) / 127``."""
    return (k * gamma.abs() + beta.abs()).clamp(min=1e-6) * INV127


def _scale_fold(x_scale: torch.Tensor, cin: int, groups: int, features: int) -> torch.Tensor:
    """The per-input-channel activation scales as a broadcastable fold of an
    OIHW kernel: (1, cin, 1, 1), or (features, cin, 1, 1) for a grouped
    conv, whose ``weight[o, i]`` consumes input channel ``g(o) * cin + i``."""
    if groups == 1:
        return x_scale[None, :, None, None]
    return x_scale.reshape(groups, cin).repeat_interleave(features // groups, dim=0)[:, :, None, None]


def quantize_weight(kernel: torch.Tensor):
    """Per-output-channel symmetric weights of an OIHW float32 kernel:
    (int8 weights, s_w (Cout,)) with ``s_w = max(max |kernel| / 127, 1e-12)``."""
    s_w = (kernel.abs().amax(dim=(1, 2, 3)) * INV127).clamp(min=1e-12)
    return torch.round(kernel / s_w[:, None, None, None]).clamp_(-127, 127).to(torch.int8), s_w


def int8_conv(x, weight, mult, bias=None, stride=(1, 1), padding=(0, 0), groups: int = 1,
              out_dtype=torch.bfloat16):
    """``float(conv(x, weight)) * mult (+ bias)`` in ``out_dtype`` (or the
    int32 sums for ``torch.int32``): ``x`` (N, C, H, W) int8, ``weight``
    (Cout, C / groups, kh, kw) int8, ``mult`` and ``bias`` (Cout,) float32.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_conv has no implementation for device {x.device}")
    return _int8_conv_op(x, weight, mult, bias, [int(s) for s in stride], [int(p) for p in padding], int(groups),
                         out_dtype)


def int8_conv_plain(x, weight, mult, bias=None, stride=(1, 1), padding=(0, 0), groups: int = 1,
                    out_dtype=torch.bfloat16):
    """Plain PyTorch twin of the kernel, any device: the convolution in
    float64 over the int8 values is exact (|sum| <= 127^2 * 9 * 2048, far
    below 2^53), then the same epilogue (the fused multiply-add through
    float64, where the product is exact).  Channels-last output, as the
    kernel's."""
    acc = F.conv2d(x.double(), weight.double(), None, tuple(stride), tuple(padding), 1, groups).to(torch.int32)
    if out_dtype == torch.int32:
        out = acc
    elif bias is None:
        out = (acc.float() * mult[:, None, None]).to(out_dtype)
    else:
        y = acc.float().double() * mult.double()[:, None, None] + bias.double()[:, None, None]
        out = y.float().to(out_dtype)
    return out.contiguous(memory_format=torch.channels_last)


def _int8_conv_fake(x, weight, mult, bias, stride, padding, groups, out_dtype):
    n, _, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ho, wo = conv_output_hw(h, w, (kh, kw), stride, padding)
    return x.new_empty((n, ho, wo, cout), dtype=out_dtype).permute(0, 3, 1, 2)


# the operator, through torch.library's low-level API (no Python autograd
# wrapper: the int8 arithmetic carries no gradient), in the namespace
# ops/vote_nms.py defines
_LIB = torch.library.Library("radet_tpu_torch", "FRAGMENT")
_LIB.define("int8_conv(Tensor x, Tensor weight, Tensor mult, Tensor? bias, int[] stride, int[] padding, "
            "int groups, ScalarType out_dtype) -> Tensor")
_LIB.impl("int8_conv", int8_conv_plain, "CPU")
_LIB.impl("int8_conv", int8_conv_cuda, "CUDA")
torch.library.register_fake("radet_tpu_torch::int8_conv", _int8_conv_fake, lib=_LIB)
_int8_conv_op = torch.ops.radet_tpu_torch.int8_conv.default


@register_flop_formula(torch.ops.radet_tpu_torch.int8_conv)
def _int8_conv_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """FlopCounterMode's count of the operator: 2 operations per multiply-add."""
    return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)


def int8_conv_forward(conv, x, x_scale=None):
    """The JAX package's ``Int8Conv`` deploy branch over the float32
    ``weight`` (and ``bias``, stride, padding and groups) of ``conv``:
    - an int8 ``x`` with a (C,) ``x_scale``: the scales are folded into the
      float kernel before it is quantized (``s_x`` = 1);
    - an int8 ``x`` with a scalar ``x_scale``: ``s_x = max(x_scale, 1e-12)``;
    - a float ``x``: quantized here with ``x_scale`` or, when it is None,
      the whole tensor's absmax / 127 (across the batch), at least 1e-12.
    The output is bfloat16, as the JAX package's ``Int8Conv`` default,
    which no caller there changes.  No gradient flows through it."""
    kernel = conv.weight.detach()
    if x_scale is not None:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device).detach()
    if x_scale is not None and x_scale.dim() == 1:
        if x.dtype != torch.int8:
            raise AssertionError("per-channel scales require int8 input")
        kernel = kernel * _scale_fold(x_scale, x.shape[1] // conv.groups, conv.groups, conv.out_channels)
        s_x, x_q = None, x
    elif x.dtype == torch.int8:
        if x_scale is None:
            raise AssertionError("int8 input requires its scale")
        s_x, x_q = x_scale.clamp(min=1e-12), x
    else:
        x_f = x.float()
        s_x = (x_f.abs().amax() * INV127 if x_scale is None else x_scale).clamp(min=1e-12)
        x_q = quantize_int8(x_f, s_x)
    w_q, s_w = quantize_weight(kernel)
    mult = s_w if s_x is None else s_x * s_w
    bias = None if conv.bias is None else conv.bias.detach()
    return int8_conv(x_q, w_q, mult, bias, conv.stride, conv.padding, conv.groups)
