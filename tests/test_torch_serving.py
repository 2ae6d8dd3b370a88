"""The port's serving front end (``radet_tpu_torch/apis/serving.py::
BatchingDetector``) and ``async_inference_detector`` on a CPU detector,
against the JAX package's ``inference_detector`` on the same weights.

The detector is the flagship config narrowed to 64x96 (widths 64, 2
stacked convs, 4 classes, float32), with the test_cfg of
tests/test_torch_slice.py: exact top-k and ``nms_topk`` (1024) above the
candidate pairs (516).  Futures are held to the JAX results with valid and
labels equal, scores within 1e-5 and boxes within 1e-2 px.  A gate in front
of the step holds the dispatcher, so that which requests are queued and
which are dispatched is known when the tests cancel or count them."""

import asyncio
import copy
import sys
import threading

import numpy as np
import pytest

from radet_tpu.apis.inference import inference_detector as jax_inference_detector
from radet_tpu_torch import BatchingDetector, async_inference_detector, inference_detector
from torch_parity import assert_same_detections, serving_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

# the input size, smaller and larger ones (resized), and ones that are padded
SIZES = [(64, 96), (48, 72), (100, 150), (60, 96), (128, 192), (30, 40), (64, 80)]
TIMEOUT = 60


def _images(seed=0, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*hw, 3), dtype=np.uint8) for hw in sizes]


@pytest.fixture(scope="module")
def pair():
    """(JAX Detector, port Detector on the CPU) carrying the same weights."""
    return serving_pair()


class Gate:
    """Stands in front of a step: records that the dispatcher reached it and
    holds it there until released."""

    def __init__(self, infer):
        self.infer = infer
        self.entered = threading.Event()
        self.open = threading.Event()

    def __call__(self, *args):
        self.entered.set()
        assert self.open.wait(TIMEOUT)
        return self.infer(*args)


def gated_server(det, **kw):
    """A BatchingDetector over a copy of ``det`` whose step is gated after
    the warm-up; returns (server, gate)."""
    held = copy.copy(det)
    srv = BatchingDetector(held, **kw)
    gate = held._infer = Gate(det._infer)
    return srv, gate


def test_batched_results_match_jax_and_direct_inference(pair):
    jax_det, det = pair
    imgs = _images()
    want = jax_inference_detector(jax_det, imgs)
    direct = inference_detector(det, imgs)
    assert sum(len(r["boxes"]) for r in want) > 10  # the random head clears score_thr
    with BatchingDetector(det, batch_size=4, max_latency_ms=50) as srv:
        futs = [srv.submit(im) for im in imgs]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        stats = srv.stats()
    assert stats["requests"] == 7 and stats["batches"] >= 2  # one batch at least is padded
    assert_same_detections(got, want)
    assert_same_detections(got, direct)
    assert got[4]["boxes"][:, 2:].max() > 96  # boxes in the larger image's coordinates


def test_stats_count_requests_batches_and_fill(pair):
    _, det = pair
    imgs = _images(1)
    srv, gate = gated_server(det, batch_size=4, max_latency_ms=200)
    assert srv.stats() == dict(requests=0, batches=0, fill=0.0, batch_size=4)  # the warm-up is not counted
    first = srv.submit(imgs[0])
    assert gate.entered.wait(TIMEOUT)  # batch 1 holds the first request alone
    rest = [srv.submit(im) for im in imgs[1:6]]
    gate.open.set()
    for f in [first] + rest:
        f.result(timeout=TIMEOUT)
    srv.close()
    # batches of 1 (dispatched alone), 4 (taken from the queue at once) and 1
    assert srv.stats() == dict(requests=6, batches=3, fill=0.5, batch_size=4)


def test_concurrent_submitters_and_detect(pair):
    """16 threads, 2 requests each, with the interpreter switching threads
    every 10 us: every result is its own image's, and no count is lost."""
    _, det = pair
    imgs = _images(2, SIZES * 5)[:32]
    want = inference_detector(det, imgs)
    got = [None] * len(imgs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BatchingDetector(det, batch_size=4, max_latency_ms=2) as srv:
            def worker(i):
                for j in (i, i + 16):
                    got[j] = srv.detect(imgs[j], timeout=TIMEOUT)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            single = srv.detect(imgs[0], timeout=TIMEOUT)  # a partial batch after the burst
            stats = srv.stats()
    finally:
        sys.setswitchinterval(interval)
    assert stats["requests"] == 33 and stats["batches"] >= 9
    assert_same_detections(got, want)
    assert_same_detections([single], want[:1])


def test_close_rejects_new_work_and_drains(pair):
    _, det = pair
    imgs = _images(3)
    srv = BatchingDetector(det, batch_size=4, max_latency_ms=50)
    futs = [srv.submit(im) for im in imgs]
    srv.close()
    assert all(f.done() and not f.cancelled() for f in futs)
    assert_same_detections([f.result() for f in futs], inference_detector(det, imgs))
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(imgs[0])
    srv.close()  # idempotent
    assert srv.stats()["requests"] == len(imgs)


def test_cancelled_futures_leave_the_server_answering(pair):
    """A future cancelled while queued is dropped; one cancelled after
    dispatch is running and cannot be cancelled.  radet_tpu's serving
    let both cancels succeed, and its completion thread then died on
    ``set_result`` (InvalidStateError), hanging every later request."""
    _, det = pair
    imgs = _images(4)
    srv, gate = gated_server(det, batch_size=4, max_latency_ms=0)
    dispatched = srv.submit(imgs[0])
    assert gate.entered.wait(TIMEOUT)
    queued = [srv.submit(im) for im in imgs[1:4]]
    assert dispatched.running() and not dispatched.cancel()
    assert queued[0].cancel() and queued[0].cancelled()
    gate.open.set()
    want = inference_detector(det, imgs[:5])
    assert_same_detections([dispatched.result(timeout=TIMEOUT)], want[:1])
    assert_same_detections([f.result(timeout=TIMEOUT) for f in queued[1:]], want[2:4])
    assert_same_detections([srv.detect(imgs[4], timeout=TIMEOUT)], want[4:])
    srv.close()
    assert srv.stats()["requests"] == 4  # the cancelled request never ran


def test_bad_images_raise_in_submit(pair):
    _, det = pair
    img = _images(5)[0]
    with BatchingDetector(det, batch_size=2, max_latency_ms=0) as srv:
        with pytest.raises(ValueError, match="uint8"):
            srv.submit(img.astype(np.float32))
        with pytest.raises(ValueError, match="RGB"):
            srv.submit(img[..., 0])
        with pytest.raises(ValueError, match="Pad target"):  # portrait through a landscape input
            srv.submit(np.ascontiguousarray(img.transpose(1, 0, 2)))
        assert_same_detections([srv.detect(img, timeout=TIMEOUT)], [inference_detector(det, img)])
        assert srv.stats()["requests"] == 1


def test_async_inference_detector_matches_inference_detector(pair):
    _, det = pair
    imgs = _images(6)[:3]

    async def both():
        return await asyncio.gather(async_inference_detector(det, imgs[0]), async_inference_detector(det, imgs))

    one, many = asyncio.run(both())
    for got, want in ((one, inference_detector(det, imgs[0])), *zip(many, inference_detector(det, imgs))):
        assert set(got) == {"boxes", "scores", "labels"}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
