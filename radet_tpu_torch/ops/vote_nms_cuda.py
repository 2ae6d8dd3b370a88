"""Wrappers of the hand-written vote-NMS kernel (``csrc/vote_nms.cu``).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
repository's source only, into ``radet_tpu_torch/_build/``
(``utils/native.py``), and loaded with ``ctypes`` through a plain C entry
point.  Nothing is built when the module is imported.  One call launches
the source's three CUDA kernels (``CUDA_KERNELS``: overlap bitmask, greedy
sweep, voting or, in the no-vote mode, the kept boxes' copy) on PyTorch's
current stream and never synchronises.

:func:`vote_nms_cuda` runs the vote mode; :func:`batched_nms_cuda` the
no-vote mode (plain class-aware greedy NMS).  ``LAUNCHES`` and
``NMS_LAUNCHES`` count the calls that launched the kernel in each mode, one
per call, and nothing else.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import torch

from ..utils.native import CSRC, build_library, find_tool

SOURCE = CSRC / "vote_nms.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# kMaxK of vote_nms.cu: one code path for every 1 <= K <= MAX_K, with the
# bitmask in a global scratch of B * ~(K^2 / 8 + 8 K) bytes.  8192 covers the
# strict eval's K = 2048 and the flagship's largest per-level candidate set
# (4 x 1000 + 420 = 4420 at 480 x 640).
MAX_K = 8192
# the __global__ functions of one call, in launch order
CUDA_KERNELS = ("overlap_kernel", "sweep_kernel", "vote_kernel")
MAX_B = 65535  # images go on a grid dimension of at most 65535 blocks

LAUNCHES = 0  # vote mode
NMS_LAUNCHES = 0  # no-vote mode

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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.radet_vote_nms.argtypes = [p] * 10 + [i, i, i, f, i, f, i, i, p]
    lib.radet_vote_nms.restype = ctypes.c_int
    lib.radet_vote_nms_scratch_bytes.argtypes = [i, i]
    lib.radet_vote_nms_scratch_bytes.restype = ctypes.c_size_t
    lib.radet_cuda_error_string.argtypes = [i]
    lib.radet_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_sizes(b: int, k: int, max_out: int) -> None:
    """Raise ValueError unless the kernel takes a batch of ``b`` images of
    ``k`` candidates each into ``max_out`` slots."""
    if not 1 <= k <= MAX_K or not 1 <= b <= MAX_B:
        raise ValueError(
            f"vote_nms_cuda takes 1 <= K <= {MAX_K} (MAX_K) and 1 <= B <= {MAX_B}, got B={b}, K={k}"
        )
    if max_out < 0:
        raise ValueError(f"max_out must be >= 0, got {max_out}")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vote_nms_cuda(
    boxes,
    cluster_scores,
    vote_scores,
    labels,
    valid,
    *,
    iou_threshold: float = 0.65,
    max_out: int = 100,
    iou_enable: bool = False,
    sigma: float = 0.025,
    global_mode: bool = False,
):
    """Batched vote-NMS on the card; same contract and outputs as
    ``ops.vote_nms.vote_nms_plain``: (boxes (B, M, 4), labels (B, M) int32,
    scores (B, M), valid (B, M) bool)."""
    global LAUNCHES
    out = _launch(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold, max_out,
                  iou_enable, sigma, global_mode, vote=True)
    LAUNCHES += 1
    return out


def batched_nms_cuda(boxes, scores, labels, valid, *, iou_threshold: float = 0.6, max_out: int = 100):
    """Class-aware greedy NMS on the card (the kernel's no-vote mode): each
    slot is a kept box with its own coordinates, score and label.  Inputs
    sorted by score descending, ties in index order, invalid slots last;
    same outputs as ``ops.vote_nms.batched_nms_plain`` on them."""
    global NMS_LAUNCHES
    out = _launch(boxes, scores, scores, labels, valid, iou_threshold, max_out, False, 0.025, False,
                  vote=False)
    NMS_LAUNCHES += 1
    return out


def _launch(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold, max_out, iou_enable,
            sigma, global_mode, *, vote: bool):
    device = boxes.device
    if device.type != "cuda":
        raise ValueError(f"the vote_nms kernel takes CUDA tensors, got {device}")
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    check_sizes(b, k, max_out)
    _check("boxes", boxes, torch.float32, (b, k, 4), device)
    _check("cluster_scores", cluster_scores, torch.float32, (b, k), device)
    _check("vote_scores", vote_scores, torch.float32, (b, k), device)
    _check("labels", labels, torch.int32, (b, k), device)
    _check("valid", valid, torch.bool, (b, k), device)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")

    lib = build()
    out_boxes = torch.empty((b, max_out, 4), dtype=torch.float32, device=device)
    out_labels = torch.empty((b, max_out), dtype=torch.int32, device=device)
    out_scores = torch.empty((b, max_out), dtype=torch.float32, device=device)
    out_valid = torch.empty((b, max_out), dtype=torch.bool, device=device)
    # the bitmask and the member lists (the caching allocator aligns to 512 bytes)
    scratch = torch.empty(lib.radet_vote_nms_scratch_bytes(b, k), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        err = lib.radet_vote_nms(
            boxes.data_ptr(), cluster_scores.data_ptr(), vote_scores.data_ptr(),
            labels.data_ptr(), valid.data_ptr(), scratch.data_ptr(), out_boxes.data_ptr(),
            out_labels.data_ptr(), out_scores.data_ptr(), out_valid.data_ptr(),
            b, k, max_out, float(iou_threshold), int(bool(iou_enable)), float(sigma),
            int(bool(global_mode)), int(vote), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"vote_nms kernel launch failed: {lib.radet_cuda_error_string(err).decode()}"
        )
    return out_boxes, out_labels, out_scores, out_valid
