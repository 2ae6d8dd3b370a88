"""Wrapper of the hand-written int8 convolution kernels (``csrc/int8_conv.cu``).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
repository's source only, into ``radet_tpu_torch/_build/``
(``utils/native.py``), and loaded with ``ctypes`` through plain C entry
points.  Nothing is built when the module is imported.  One call launches
one CUDA kernel on PyTorch's current stream and never synchronises.

Two kernels, chosen by :func:`plan`, a static rule on shape and alignment
(never a fallback on a failed build or launch):
- ``wgmma`` (``int8_conv_wgmma_kernel``): ``wgmma`` products fed by TMA
  loads through an mbarrier ring, a swizzled shared-memory epilogue and TMA
  stores, persistent blocks; for ``groups == 1``, ``Cin % 16 == 0``,
  ``Cout`` a multiple of 8 (bf16 out) or 4 (4-byte out) and 16-byte aligned
  tensors: every int8 conv of ``configs/bop``'s int8 configs;
- ``mma`` (``int8_conv_kernel``, the first, simpler ``mma.sync`` kernel):
  every other shape (grouped convs, ResNeXt's 4 or 8 channels a group).

The kernels take NHWC int8 activations and OHWI int8 weights.  The wrapper
takes the port's NCHW tensors (activations) and OIHW tensors (weights) and
converts them explicitly: ``x.permute(0, 2, 3, 1).contiguous()`` costs
nothing for a channels-last tensor (the trunk's layout on the card, since
``preprocess_images`` hands cuDNN NHWC bytes, and the layout both kernels
write) and one copy otherwise; the weights are copied once per call.  The
output is (N, Cout, Ho, Wo) in channels-last memory.  ``LAUNCHES`` counts
the calls that launched a kernel, one per call, and nothing else;
``PATH_LAUNCHES`` the same calls by path.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from pathlib import Path

import torch

from ..utils.native import CSRC, build_library, find_tool

SOURCE = CSRC / "int8_conv.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
CUDA_KERNELS = ("int8_conv_wgmma_kernel", "int8_conv_kernel")  # the wgmma path's, the mma path's
PATHS = ("wgmma", "mma")
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}  # int32: the raw sums

LAUNCHES = 0
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)

# the wgmma kernel's tile and shared memory (csrc/int8_conv.cu, namespace wg)
WGMMA_BM = 128  # output pixels per tile: two consumer warpgroups of 64 rows
WGMMA_MAX_STAGES = 8
SMEM_LIMIT = 232448  # bytes a block may opt into on the H100 (227 KB)
EPILOGUE_BYTES = 4 * 8192  # two store buffers of 64 rows x 128 bytes per consumer warpgroup
BARRIER_BYTES = 2 * WGMMA_MAX_STAGES * 8
TMA_BOX_MAX = 256  # elements per box dimension
H100_SMS = 132
PERSISTENT = True  # one block per SM over a static tile order; False: one block per tile
# the launch configuration the C entry point reads, in the order of wg::Cfg
WGMMA_CFG = ("c", "a_w", "a_h", "a_n", "o_w", "o_h", "cout", "kh", "kw", "sh", "sw", "pad_h", "pad_w",
             "patch_w", "patch_h", "patch_n", "tiles_w", "tiles_h", "tiles_n", "tiles_o", "split", "bk", "bn",
             "stages", "out_kind", "grid", "smem")

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
    lib.radet_int8_conv_wgmma.argtypes = [p] * 5 + [ctypes.POINTER(i), p]
    lib.radet_int8_conv_wgmma.restype = ctypes.c_int
    lib.radet_int8_conv_error_string.argtypes = [i]
    lib.radet_int8_conv_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def conv_output_hw(h: int, w: int, kernel, stride, padding):
    """(Ho, Wo) of a convolution without dilation."""
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1, (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


def _patch(n: int, ho: int, wo: int, sh: int, sw: int):
    """(pw, ph, pn): the output patch of one tile, powers of two with
    pw * ph * pn = 128, each box dimension (pw sw, ph sh) within the TMA's
    256, that covers (n, ho, wo) with the fewest tiles (wasted rows), then
    the widest rows (the longest contiguous copies)."""
    best = None
    for lw in range(8):
        for lh in range(8 - lw):
            pw, ph = 1 << lw, 1 << lh
            pn = WGMMA_BM // (pw * ph)
            if pw * sw > TMA_BOX_MAX or ph * sh > TMA_BOX_MAX:
                continue
            tiles = -(-wo // pw) * -(-ho // ph) * -(-n // pn)
            key = (tiles, -pw, -ph)
            if best is None or key < best[0]:
                best = (key, (pw, ph, pn))
    return best[1]


def plan(x_shape, w_shape, stride, padding, groups: int, alignment: int, out_bytes: int = 2,
         sms: int = H100_SMS, persistent: bool = PERSISTENT) -> dict:
    """Which kernel takes a convolution, and the wgmma kernel's launch: a
    pure function of the NCHW input shape, the OIHW weight shape, stride,
    padding, groups, the largest power of two dividing the input's and the
    weight's addresses (``alignment``), the output element's bytes and the
    card's SM count.  Returns {"path": "mma"} or {"path": "wgmma", ...} with
    the keys of ``WGMMA_CFG`` (less ``out_kind``) and the TMA boxes
    ("a_box", "b_box", "o_box", in elements, innermost first), the
    bytes of one ring stage ("stage_bytes") and the tile count."""
    n, c, h, w = x_shape
    cout, cin_g, kh, kw = w_shape
    sh, sw = stride
    pad_h, pad_w = padding
    ho, wo = conv_output_hw(h, w, (kh, kw), stride, padding)
    if groups != 1 or c % 16 or (cout * out_bytes) % 16 or alignment % 16:
        return {"path": "mma"}
    if (kh, kw, sh, sw, pad_h, pad_w) == (1, 1, 1, 1, 0, 0):
        # a plain GEMM: the input as one row of n h w pixels
        a_w, a_h, a_n, o_w, o_h = n * h * w, 1, 1, n * h * w, 1
        pw, ph, pn = WGMMA_BM, 1, 1
    else:
        a_w, a_h, a_n, o_w, o_h = w, h, n, wo, ho
        pw, ph, pn = _patch(n, ho, wo, sh, sw)
    tiles_w, tiles_h, tiles_n = -(-o_w // pw), -(-o_h // ph), -(-a_n // pn)
    m_tiles = tiles_w * tiles_h * tiles_n
    # output channels per tile: 256 over a deep reduction (kh kw Cin >= 2048:
    # the 3x3s at 256 channels and up, each A tile read once), else 128
    # (a shallow reduction gains more from the 6-stage ring than from
    # reading A once), 64 for Cout <= 64; 128 where 256 would leave SMs idle
    bn = 64 if cout <= 64 else 256 if cout > 128 and kh * kw * c >= 2048 else 128
    if bn == 256 and m_tiles * -(-cout // 256) < sms:
        bn = 128
    # K bytes per stage: 128 (128-byte swizzle); 64 for Cin = 64 and for a
    # 64-wide tile (twice the stages); 32 otherwise
    bk = 128 if c % 128 == 0 and bn > 64 else 64 if c % 64 == 0 else 32
    tiles_o = -(-cout // bn)
    stage_bytes = (WGMMA_BM + bn) * bk
    fixed = 1024 + EPILOGUE_BYTES + BARRIER_BYTES  # 1024: the ring's alignment to the swizzle's repeat
    stages = min(WGMMA_MAX_STAGES, (SMEM_LIMIT - fixed) // stage_bytes)
    tiles = m_tiles * tiles_o
    split = 2 if pn > 1 else 1 if ph > 1 else 0  # the outermost patch dimension halves between the consumers
    half = [pw, ph, pn]
    half[split] //= 2
    return dict(
        path="wgmma", c=c, a_w=a_w, a_h=a_h, a_n=a_n, o_w=o_w, o_h=o_h, cout=cout, kh=kh, kw=kw, sh=sh, sw=sw,
        pad_h=pad_h, pad_w=pad_w, patch_w=pw, patch_h=ph, patch_n=pn, tiles_w=tiles_w, tiles_h=tiles_h,
        tiles_n=tiles_n, tiles_o=tiles_o, split=split, bk=bk, bn=bn, stages=stages,
        grid=min(tiles, sms) if persistent else tiles, smem=fixed + stages * stage_bytes, stage_bytes=stage_bytes,
        tiles=tiles, a_box=(bk, pw * sw, ph * sh, pn), b_box=(bk, bn), o_box=(128 // out_bytes, *half),
        a_strides=(c, a_w * c, a_h * a_w * c), b_strides=(kh * kw * c,),
        o_strides=(cout * out_bytes, o_w * cout * out_bytes, o_h * o_w * cout * out_bytes))


def _alignment(*tensors) -> int:
    """The largest power of two (up to 256) dividing every tensor's address."""
    return math.gcd(256, *(t.data_ptr() for t in tensors))


@functools.lru_cache(maxsize=4096)
def _launch_plan(x_shape, w_shape, stride, padding, groups: int, alignment: int, out_kind: int, out_bytes: int,
                 sms: int, persistent: bool):
    """:func:`plan` of one call, cached (a call is host-paced at batch 8):
    ("mma", None) or ("wgmma", the C entry point's int array)."""
    cfg = plan(x_shape, w_shape, stride, padding, groups, alignment, out_bytes, sms, persistent)
    if cfg["path"] != "wgmma":
        return "mma", None
    cfg["out_kind"] = out_kind
    return "wgmma", (ctypes.c_int * len(WGMMA_CFG))(*(cfg[k] for k in WGMMA_CFG))


_SMS = {}


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def int8_conv_cuda(x, weight, mult, bias, stride, padding, groups: int, out_dtype, path=None, persistent=None):
    """The int8 convolution on the card; same contract and values as
    ``ops.quant.int8_conv_plain``: ``x`` (N, C, H, W) int8, ``weight``
    (Cout, C / groups, kh, kw) int8, ``mult`` (Cout,) float32 (``s_x *
    s_w``), ``bias`` (Cout,) float32 or None; returns (N, Cout, Ho, Wo) of
    ``out_dtype`` (float32, bfloat16, or int32 for the sums themselves).
    ``path`` ("wgmma" or "mma") and ``persistent`` override :func:`plan`'s
    choice, so that tests and the smoke can hold both kernels to the same
    inputs; the operator never passes them.  Forcing "wgmma" on a shape
    outside its domain raises."""
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

    if path not in (None,) + PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")

    lib = build()
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    w_ohwi = weight.permute(0, 2, 3, 1).contiguous()
    mult = mult.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device)
    planned, cfg = _launch_plan(x.shape, weight.shape, tuple(stride), tuple(padding), groups,
                                _alignment(x_nhwc, w_ohwi), OUT_KINDS[out_dtype], out.element_size(),
                                _sm_count(device), PERSISTENT if persistent is None else persistent)
    if path == "wgmma" and planned != "wgmma":
        raise ValueError(f"the wgmma kernel does not take x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"groups {groups}, {out_dtype}")
    chosen = path or planned
    args = (x_nhwc.data_ptr(), w_ohwi.data_ptr(), mult.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if chosen == "wgmma":
            err = lib.radet_int8_conv_wgmma(*args, cfg, stream)
        else:
            vec = int(cin_g % 16 == 0 and x_nhwc.data_ptr() % 16 == 0 and w_ohwi.data_ptr() % 16 == 0)
            err = lib.radet_int8_conv(*args, n, h, w, c, cout, kh, kw, stride[0], stride[1], padding[0],
                                      padding[1], groups, OUT_KINDS[out_dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"int8_conv {chosen} kernel launch failed: "
                           f"{lib.radet_int8_conv_error_string(err).decode()}")
    LAUNCHES += 1
    PATH_LAUNCHES[chosen] += 1
    return out.permute(0, 3, 1, 2)
