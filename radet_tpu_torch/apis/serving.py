"""Dynamic batching for serving (port of ``radet_tpu/apis/serving.py``).

Callers submit single images from any thread and get a
``concurrent.futures.Future`` back.  Reading, resizing and padding run in
the caller's thread, so a threaded front end spreads that host work over
its threads.  A dispatcher thread coalesces requests into the static
``batch_size``, waiting at most ``max_latency_ms`` after the first for a
fuller batch, and pads a partial batch with zero images.  A completion
thread waits for each batch's detections and resolves its futures.

On a card the dispatcher does not wait for the device:

- it stacks a batch straight into one of ``SLOTS`` pinned host slots, so
  the step's copy of it to the card is asynchronous;
- right after launching the step it enqueues the copies of the
  detections into that slot's pinned output buffers and records the
  slot's CUDA event.  The completion thread waits on that event alone (it
  never reads a tensor on the card), so batch k's callers do not wait for
  batch k + 1, which the dispatcher has already launched;
- a slot is free again once the completion thread has sliced its results
  out.  The event follows the input copy, the step and the output copies
  in stream order, so it also guards the input rows.  At most ``SLOTS``
  batches are in flight: the free-slot queue is the back-pressure.

On the CPU the same threads run over plain host slots without events.  One
padded warm-up batch runs in the constructor, before any request is taken:
it builds the vote-NMS kernel at first use and runs its shared-memory set-up
and cuDNN's plan selection outside the request path.

A future is marked running when the dispatcher pulls its request into a
batch; a request its caller cancelled before then is dropped, and a cancel
after it fails.  Setting a future's outcome never raises in a worker
thread, so no caller can stop the server.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .inference import Detector, _prepare_batch, _split_results

__all__ = ["BatchingDetector"]

SLOTS = 2  # staging slots, and so batches in flight
_SENTINEL = object()


class _Request(NamedTuple):
    img: np.ndarray  # (H, W, 3) uint8, resized and padded
    shape: np.ndarray  # (2,) the resized (h, w)
    scale: np.ndarray  # (4,) scale factor
    fut: Future


def _resolve(fut: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Set ``fut``'s outcome; one that is already settled is left as it is."""
    try:
        if exc is None:
            fut.set_result(result)
        else:
            fut.set_exception(exc)
    except InvalidStateError:
        pass


def _pinned_like(tensors) -> List[torch.Tensor]:
    return [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]


class _Slot:
    """One batch's host staging: its input rows and, on a card, the pinned
    output buffers and the event recorded after their copies."""

    def __init__(self, batch: int, hw, device: torch.device):
        pin = device.type == "cuda"
        self.device = device
        self.hw = hw
        self.images = torch.zeros((batch, *hw, 3), dtype=torch.uint8, pin_memory=pin)
        self.shapes = torch.zeros((batch, 2), dtype=torch.float32, pin_memory=pin)
        self.scales = torch.zeros((batch, 4), dtype=torch.float32, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None
        self.out: Optional[List[torch.Tensor]] = None

    def fill(self, reqs) -> None:
        images, shapes, scales = self.images.numpy(), self.shapes.numpy(), self.scales.numpy()
        for i, r in enumerate(reqs):
            images[i], shapes[i], scales[i] = r.img, r.shape, r.scale
        n = len(reqs)
        images[n:], shapes[n:], scales[n:] = 0, self.hw, 1

    def launch(self, detector: Detector) -> None:
        """Run the step on the slot's rows; on a card, also enqueue the
        detections' copies into the pinned buffers and record the event."""
        det = detector._infer(detector.model, self.images, self.shapes, self.scales)
        if self.event is None:
            self.out = list(det[:4])
            return
        if self.out is None:
            self.out = _pinned_like(det[:4])
        for dst, src in zip(self.out, det[:4]):
            dst.copy_(src, non_blocking=True)
        self.event.record(torch.cuda.current_stream(self.device))

    def results(self, n: int):
        """Per-image dicts of the first ``n`` rows, once they are on the host."""
        if self.event is not None:
            self.event.synchronize()  # releases the interpreter lock while it waits
        return _split_results(*(t.numpy() for t in self.out), n)


class BatchingDetector:
    """Dynamic-batching wrapper around a :class:`Detector` handle
    (``init_detector(...)``), on the detector's device.

    Args:
        detector: the detector to serve.
        batch_size: the static batch every step runs at.
        max_latency_ms: how long the dispatcher waits, after the first
            request of a batch, for more before it runs a partial batch;
            0 runs whatever is queued at once.
    """

    def __init__(self, detector: Detector, batch_size: int = 16, max_latency_ms: float = 5.0):
        self._det = detector
        self._batch = int(batch_size)
        self._max_latency = float(max_latency_ms) / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue()
        self._free: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._batches = 0
        self._requests = 0
        device = next(detector.model.parameters()).device
        slots = [_Slot(self._batch, tuple(detector.input_size), device) for _ in range(SLOTS)]
        warm = slots[0]
        warm.fill([])
        warm.launch(detector)
        warm.results(0)
        if warm.event is not None:  # the other slots' outputs, outside the request path too
            for s in slots[1:]:
                s.out = _pinned_like(warm.out)
        for s in slots:
            self._free.put(s)
        self._dispatcher = threading.Thread(target=self._dispatch_loop, name="radet-serve-dispatch",
                                            daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, name="radet-serve-complete",
                                           daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # ---- public api -------------------------------------------------------

    def submit(self, img) -> Future:
        """Enqueue one image (a path, or an RGB uint8 (H, W, 3) array of any
        size); returns a Future of {boxes, scores, labels} in the image's
        coordinates.  Reading, resizing and the dtype and shape checks run
        here, in the caller's thread."""
        if self._closed:
            raise RuntimeError("BatchingDetector is closed")
        imgs, shapes, scales = _prepare_batch(self._det, [img])
        fut: Future = Future()
        # the check and the put are atomic against close(): a request lands
        # before the shutdown sentinel, or submit raises
        with self._lock:
            if self._closed:
                raise RuntimeError("BatchingDetector is closed")
            self._queue.put(_Request(imgs[0], shapes[0], scales[0], fut))
        return fut

    def detect(self, img, timeout: Optional[float] = None):
        """Submit and wait."""
        return self.submit(img).result(timeout=timeout)

    def stats(self) -> dict:
        """Requests run, batches run, their fill, and the batch size."""
        with self._lock:
            b, r = self._batches, self._requests
        return dict(requests=r, batches=b, fill=r / (b * self._batch) if b else 0.0, batch_size=self._batch)

    def close(self, timeout: float = 30.0) -> None:
        """Stop taking work, run what is queued, and join the threads.

        Raises RuntimeError when they have not drained within ``timeout``
        seconds: returning would leave callers waiting on futures that
        never resolve."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SENTINEL)
        self._dispatcher.join(timeout=timeout)
        self._completer.join(timeout=timeout)
        if self._dispatcher.is_alive() or self._completer.is_alive():
            raise RuntimeError(f"BatchingDetector workers did not drain within {timeout}s; "
                               "pending futures remain unresolved")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker threads ---------------------------------------------------

    def _collect(self) -> Optional[List[_Request]]:
        """Block for a live request, then take more up to the batch size
        within the latency budget; requests cancelled while queued are
        dropped, the others marked running.  None on shutdown."""
        reqs: List[_Request] = []
        deadline = None
        while len(reqs) < self._batch:
            if deadline is None:
                item = self._queue.get()
            else:
                remaining = deadline - time.monotonic()
                try:
                    item = self._queue.get(timeout=remaining) if remaining > 0 else self._queue.get_nowait()
                except queue.Empty:
                    break
            if item is _SENTINEL:
                if not reqs:
                    return None
                self._queue.put(_SENTINEL)  # shut down after this batch
                break
            if item.fut.set_running_or_notify_cancel():
                reqs.append(item)
                if deadline is None:
                    deadline = time.monotonic() + self._max_latency
        return reqs

    def _dispatch_loop(self) -> None:
        while True:
            slot = self._free.get()
            reqs = self._collect()
            if reqs is None:
                # close() puts the sentinel under the submit lock, so nothing
                # should follow it; cancel anything that did
                while True:
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is not _SENTINEL:
                        item.fut.cancel()
                self._done.put(_SENTINEL)
                return
            try:
                slot.fill(reqs)
                slot.launch(self._det)
            except Exception as e:  # fail this batch's futures; keep serving
                for r in reqs:
                    _resolve(r.fut, exc=e)
                self._free.put(slot)
                continue
            with self._lock:
                self._batches += 1
                self._requests += len(reqs)
            self._done.put((slot, reqs))

    def _complete_loop(self) -> None:
        while True:
            item = self._done.get()
            if item is _SENTINEL:
                return
            slot, reqs = item
            try:
                results = slot.results(len(reqs))
            except Exception as e:  # a device fault surfaces at the readback
                for r in reqs:
                    _resolve(r.fut, exc=e)
                continue
            finally:
                self._free.put(slot)
            for r, res in zip(reqs, results):
                _resolve(r.fut, result=res)
