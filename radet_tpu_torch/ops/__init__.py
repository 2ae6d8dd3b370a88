"""Kernels and their plain PyTorch versions: ``ops.vote_nms`` (entry point
and plain version) and ``ops.vote_nms_cuda`` (the CUDA kernel's wrapper)."""
