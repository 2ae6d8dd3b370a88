"""Wrapper of the hand-written vote-NMS kernel (``csrc/vote_nms.cu``).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
repository's source only, into ``radet_tpu_torch/_build/`` (named by the
source's hash, so an edited source is rebuilt), and loaded with ``ctypes``
through a plain C entry point.  Nothing is built when the module is
imported.  The kernel launches on PyTorch's current stream and never
synchronises.

``LAUNCHES`` counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "vote_nms.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
MAX_K = 1024  # kMaxK of vote_nms.cu: its shared-memory bitmask holds K <= 1024

LAUNCHES = 0

_lib = None
# nvcc's stderr (ptxas' register and shared-memory report) of the build this
# process made; None when it loaded an existing library
BUILD_LOG = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return str(cand)


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libvote_nms_{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
        BUILD_LOG = proc.stderr
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.radet_vote_nms.argtypes = [p] * 9 + [i, i, i, f, i, f, i, p]
    lib.radet_vote_nms.restype = ctypes.c_int
    lib.radet_cuda_error_string.argtypes = [i]
    lib.radet_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


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
    device = boxes.device
    if device.type != "cuda":
        raise ValueError(f"vote_nms_cuda takes CUDA tensors, got {device}")
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if not 1 <= k <= MAX_K or b < 1:
        raise ValueError(f"vote_nms_cuda takes 1 <= K <= {MAX_K} and B >= 1, got B={b}, K={k}")
    if max_out < 0:
        raise ValueError(f"max_out must be >= 0, got {max_out}")
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
    with torch.cuda.device(device):
        err = lib.radet_vote_nms(
            boxes.data_ptr(), cluster_scores.data_ptr(), vote_scores.data_ptr(),
            labels.data_ptr(), valid.data_ptr(), out_boxes.data_ptr(),
            out_labels.data_ptr(), out_scores.data_ptr(), out_valid.data_ptr(),
            b, k, max_out, float(iou_threshold), int(bool(iou_enable)), float(sigma),
            int(bool(global_mode)), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"vote_nms kernel launch failed: {lib.radet_cuda_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return out_boxes, out_labels, out_scores, out_valid
