"""Wrapper of the hand-written int8 convolution kernel (``csrc/int8_conv.cu``).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
repository's source only, into ``radet_tpu_torch/_build/``
(``utils/native.py``), and loaded with ``ctypes`` through a plain C entry
point.  Nothing is built when the module is imported.  One call launches
one CUDA kernel (``CUDA_KERNELS``) on PyTorch's current stream and never
synchronises.

The kernel takes NHWC int8 activations and OHWI int8 weights.  The wrapper
takes the port's NCHW tensors (activations) and OIHW tensors (weights) and
converts them explicitly: ``x.permute(0, 2, 3, 1).contiguous()`` costs
nothing for a channels-last tensor (the trunk's layout on the card, since
``preprocess_images`` hands cuDNN NHWC bytes, and the layout this kernel
writes) and one copy otherwise; the weights are copied once per call.  The
output is (N, Cout, Ho, Wo) in channels-last memory.  ``LAUNCHES`` counts
the calls that launched the kernel, one per call, and nothing else.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import torch

from ..utils.native import CSRC, build_library, find_tool

SOURCE = CSRC / "int8_conv.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
CUDA_KERNELS = ("int8_conv_kernel",)
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}  # int32: the raw sums

LAUNCHES = 0

_lib = None
# nvcc's stderr (ptxas' register and shared-memory report) of the build this
# process made; None when it loaded an existing library
BUILD_LOG = None


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    nvcc = find_tool(["nvcc"], Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    path, BUILD_LOG = build_library(SOURCE, nvcc, NVCC_FLAGS)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.radet_int8_conv.argtypes = [p] * 5 + [i] * 14 + [p]
    lib.radet_int8_conv.restype = ctypes.c_int
    lib.radet_int8_conv_error_string.argtypes = [i]
    lib.radet_int8_conv_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def conv_output_hw(h: int, w: int, kernel, stride, padding):
    """(Ho, Wo) of a convolution without dilation."""
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1, (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


def int8_conv_cuda(x, weight, mult, bias, stride, padding, groups: int, out_dtype):
    """The int8 convolution on the card; same contract and values as
    ``ops.quant.int8_conv_plain``: ``x`` (N, C, H, W) int8, ``weight``
    (Cout, C / groups, kh, kw) int8, ``mult`` (Cout,) float32 (``s_x *
    s_w``), ``bias`` (Cout,) float32 or None; returns (N, Cout, Ho, Wo) of
    ``out_dtype`` (float32, bfloat16, or int32 for the sums themselves)."""
    global LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"the int8_conv kernel takes CUDA tensors, got {device}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"x and weight must be 4-D, got {tuple(x.shape)} and {tuple(weight.shape)}")
    n, c, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    if groups < 1 or c % groups or cout % groups or cin_g != c // groups:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit {c} input channels in {groups} groups")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be one of {list(OUT_KINDS)}, got {out_dtype}")
    for name, t, dtype in (("x", x, torch.int8), ("weight", weight, torch.int8), ("mult", mult, torch.float32)) + (
            () if bias is None else (("bias", bias, torch.float32),)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in (("mult", mult),) + (() if bias is None else (("bias", bias),)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must have shape ({cout},), got {tuple(t.shape)}")
    ho, wo = conv_output_hw(h, w, (kh, kw), stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho}x{wo} for input {h}x{w}, kernel {kh}x{kw}")
    if max(n * h * w * c, n * ho * wo * cout) >= 2**31:
        raise ValueError("the int8_conv kernel takes tensors of fewer than 2^31 elements")

    lib = build()
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    w_ohwi = weight.permute(0, 2, 3, 1).contiguous()
    mult = mult.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device)
    vec = int(cin_g % 16 == 0 and x_nhwc.data_ptr() % 16 == 0 and w_ohwi.data_ptr() % 16 == 0)
    with torch.cuda.device(device):
        err = lib.radet_int8_conv(
            x_nhwc.data_ptr(), w_ohwi.data_ptr(), mult.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), n, h, w, c, cout, kh, kw, stride[0], stride[1], padding[0], padding[1], groups,
            OUT_KINDS[out_dtype], vec, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: {lib.radet_int8_conv_error_string(err).decode()}")
    LAUNCHES += 1
    return out.permute(0, 3, 1, 2)
