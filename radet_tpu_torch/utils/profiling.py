"""Profiling and step timing (port of ``radet_tpu/utils/profiling.py``).

:func:`profile_time` times a block on the host clock and synchronises the
card at its end, so that work still queued on the device is inside the
measurement; :func:`trace` records a ``torch.profiler`` run (CPU and, on a
card, CUDA activity) and writes it as a Chrome trace; :class:`StepTimer`
keeps a sliding window of step times.  :func:`card` and
:func:`device_label` name the hardware that every measuring tool prints
beside its numbers.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import subprocess
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def profile_time(name: str, logger=None, sync: bool = True, enabled: bool = True, device=None):
    """Time a block; with ``sync``, wait at its end for the work queued on
    ``device`` (default: the current card, when CUDA is in use)."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        device = torch.device(device) if device is not None else None
        if device is None or device.type == "cuda":
            torch.cuda.synchronize(device)
    msg = f"{name}: {(time.perf_counter() - t0) * 1000:.2f} ms"
    if logger is not None:
        logger.info(msg)
    else:
        print(msg)


def profiler_activities():
    """The CPU, and CUDA where a card is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, **profile_kwargs):
    """Record a ``torch.profiler`` run over the block; at its end write
    ``<log_dir>/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto).  Yields the profiler, whose ``key_averages()`` the caller may
    read after the block."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=profiler_activities(), **profile_kwargs) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class StepTimer:
    """Sliding-window steps/sec and images/sec of the train loop."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def ms_per_step(self) -> float:
        return 1000 * sum(self.times) / len(self.times) if self.times else 0.0

    def images_per_sec(self, batch_size: int) -> float:
        if not self.times:
            return 0.0
        return batch_size * len(self.times) / sum(self.times)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (one
    line per card, joined by '; ')."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return "; ".join(line.strip() for line in out.stdout.strip().splitlines())


def device_label(device) -> str:
    """What a measurement on ``device`` ran on: :func:`card` for a CUDA
    device; for the CPU, its core count (no device metric comes from it)."""
    if torch.device(device).type == "cuda":
        return card()
    return f"cpu, {os.cpu_count()} cores"


def resolve_device(device: str, cpu: bool = False) -> torch.device:
    """A tool's ``--device`` (``--cpu`` forces the CPU); a card asked for on
    a machine without one raises."""
    device = torch.device("cpu" if cpu else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu (or --cpu) to run on the CPU")
    return device
