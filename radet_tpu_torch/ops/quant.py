"""Int8 quantization (port of ``radet_tpu/ops/quant.py``): the deploy
arithmetic, and quantization-aware training (QAT) on the same grid.

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

QAT (:func:`qat_conv_forward`, :func:`fake_quant_ste`) trains a float
model whose forward sees the deploy grid: straight-through fake
quantization of the conv input and of its per-output-channel weights at
the scales the deploy path uses, a float32 convolution (cuDNN's TF32 off:
:func:`qat_precision`), its output stored in bfloat16 as the deploy
conv's.  Every level is decided by :func:`quant_levels`, the one function
that two runs replace to share their decisions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from .int8_conv_cuda import conv_output_hw, int8_conv_cuda

# float32(1 / 127): XLA compiles ``a / 127.0`` to ``a * INV127``
INV127 = float(np.float32(1.0) / np.float32(127.0))
# the dtype a QAT conv stores its float32 output in, as the deploy conv's
QAT_OUT_DTYPE = torch.bfloat16


def quant_levels(x: torch.Tensor, scale) -> torch.Tensor:
    """The int8 levels ``clamp(round(x / scale), -127, 127)`` of float32
    ``x``, as float32 (``x / scale`` a true division).  Every quantization,
    deployed or fake, decides its levels here: a test or the smoke replaces
    this function to record them in one run and hand them to another."""
    return torch.round(x / scale).clamp_(-127.0, 127.0)


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization of an NCHW tensor; ``scale`` is a scalar
    (per tensor) or a (C,) vector (per channel)."""
    if torch.is_tensor(scale) and scale.dim() == 1:
        scale = scale[:, None, None]
    return quant_levels(x.float(), scale).to(torch.int8)


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


def weight_scale(kernel: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scales of an OIHW float32 kernel,
    ``max(max |kernel| / 127, 1e-12)`` (Cout,)."""
    return (kernel.abs().amax(dim=(1, 2, 3)) * INV127).clamp(min=1e-12)


def quantize_weight(kernel: torch.Tensor):
    """Per-output-channel symmetric weights of an OIHW float32 kernel:
    (int8 weights, s_w (Cout,)), ``s_w`` the :func:`weight_scale`."""
    s_w = weight_scale(kernel)
    return quant_levels(kernel, s_w[:, None, None, None]).to(torch.int8), s_w


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


def fake_quant_ste(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize and dequantize in float with a straight-through gradient:
    the value is ``x + (levels * scale - x)`` in ``x``'s dtype, the
    correction a constant of autograd, so the gradient reaches ``x`` as the
    identity and ``scale`` none.  ``scale`` broadcasts against ``x`` (a
    scalar, or per channel ``s[:, None, None]``).  As the JAX package's
    compiled ``xf + stop_gradient(q - xf)``: the product and the
    subtraction are one fused multiply-add (``torch.addcmul``), then the
    sum."""
    xf = x.float()
    with torch.no_grad():
        scale = torch.as_tensor(scale, dtype=torch.float32, device=xf.device)
        step = torch.addcmul(-xf, quant_levels(xf, scale), scale)
    return (xf + step).to(x.dtype)


def fake_quant_weight_ste(kernel: torch.Tensor) -> torch.Tensor:
    """:func:`fake_quant_ste` of an OIHW kernel at its per-output-channel
    :func:`weight_scale`, taken without a gradient."""
    with torch.no_grad():
        s_w = weight_scale(kernel)
    return fake_quant_ste(kernel, s_w[:, None, None, None])


@contextlib.contextmanager
def qat_precision():
    """cuDNN's TF32 off within the block (its float32 convolutions round
    their inputs to 10 mantissa bits by default), so that a QAT conv, and
    its backward, sum the on-grid products in float32.  The train step
    (``engine/train_step.py``) holds a QAT model's forward and backward in
    it; cuDNN reads the setting when each conv and its backward run."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def qat_conv_forward(conv, x, x_scale=None):
    """The JAX package's ``Int8Conv`` QAT branch over ``conv``'s float32
    ``weight`` (and ``bias``, stride, padding, groups): the float ``x``
    fake-quantized at ``x_scale`` (per tensor, or (C,) per channel) or,
    when it is None, at its dynamic absmax / 127 taken without a gradient;
    the kernel fake-quantized per output channel, after a per-channel
    ``x_scale`` is folded into it as the deploy path folds it
    (``fake_quant_weight_ste(kernel * fold) / fold``: the fold keeps its
    gradient, so the norm affines the scales come from learn through it);
    the convolution in float32 (under :func:`qat_precision` when the train
    step runs it), then ``+ bias``, stored in :data:`QAT_OUT_DTYPE`."""
    if x.dtype == torch.int8:
        raise AssertionError("QAT fake-quant consumes float inputs")
    xf = x.float()
    if x_scale is None:
        s_x = xf.detach().abs().amax() * INV127
    else:
        s_x = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    per_channel = s_x.dim() == 1
    s_q = s_x.detach().clamp(min=1e-12)
    x_fq = fake_quant_ste(xf, s_q[:, None, None] if per_channel else s_q)
    if per_channel:
        fold = _scale_fold(s_x, x.shape[1] // conv.groups, conv.groups, conv.out_channels)
        k_fq = fake_quant_weight_ste(conv.weight * fold) / fold
    else:
        k_fq = fake_quant_weight_ste(conv.weight)
    out = F.conv2d(x_fq, k_fq, None, conv.stride, conv.padding, 1, conv.groups)
    if conv.bias is not None:
        out = out + conv.bias[:, None, None]
    return out.to(QAT_OUT_DTYPE)
