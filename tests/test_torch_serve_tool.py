"""``python -m radet_tpu_torch.tools.serve``'s HTTP layer: the handler
contract over a stub batcher (as tests/test_serve_tool.py holds the JAX
package's), its status codes, and the real CPU batcher behind
``tools.serve.make_server``, whose answers to PNG and JPEG bodies are held to
the JAX package's ``inference_detector`` on ``cv2.imdecode`` of the same
bytes (valid and labels equal, scores within 1e-5, boxes within 1e-2 px)."""

import http.client
import json
import os
import os.path as osp
import threading
import types
from concurrent.futures import Future

import cv2
import numpy as np
import pytest

from radet_tpu.apis.inference import inference_detector as jax_inference_detector
from radet_tpu_torch import BatchingDetector
from radet_tpu_torch.tools.serve import make_server
from synthetic_bop import JPEG_FIXTURES, write_png
from torch_parity import assert_same_detections, serving_pair

TIMEOUT = 60


def _stub_batcher():
    seen = []

    def submit(img):
        seen.append(img.shape)
        f = Future()
        f.set_result(dict(boxes=np.asarray([[1.0, 2.0, 3.0, 4.0]], np.float32),
                          scores=np.asarray([0.9], np.float32), labels=np.asarray([2], np.int32)))
        return f

    return types.SimpleNamespace(
        submit=submit, seen=seen,
        stats=lambda: dict(requests=len(seen), batches=1, fill=0.5, batch_size=4),
    )


@pytest.fixture
def serve():
    """Starts a server on a free port over a batcher; yields a function
    (batcher, classes) -> port, and shuts every server down after."""
    servers = []

    def start(batcher, classes=()):
        server = make_server(batcher, classes, timeout_s=TIMEOUT)
        assert server.request_queue_size >= 128  # a burst of clients is queued, not dropped
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return server.server_address[1]

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def _png_bytes(tmp_path, img):
    path = osp.join(str(tmp_path), "img.png")
    write_png(path, img)
    with open(path, "rb") as f:
        return f.read()


def _post(port, body, path="/detect"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("POST", path, body=body)
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def test_handler_detect_health_stats(serve, tmp_path):
    batcher = _stub_batcher()
    port = serve(batcher, classes=("a", "b", "c"))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read()) == {"ok": True}
    img = np.zeros((32, 48, 3), np.uint8)
    img[8:24, 8:40] = (255, 0, 0)
    conn.request("POST", "/detect", body=_png_bytes(tmp_path, img))
    r = conn.getresponse()
    out = json.loads(r.read())
    assert r.status == 200
    assert out == dict(boxes=[[1.0, 2.0, 3.0, 4.0]], scores=[pytest.approx(0.9)], labels=[2],
                       classes=["a", "b", "c"])
    assert batcher.seen == [(32, 48, 3)]  # decoded to (H, W, 3)
    conn.request("GET", "/stats")
    r = conn.getresponse()
    assert json.loads(r.read())["requests"] == 1
    # a POST to an unknown path, body included, leaves the connection usable
    conn.request("POST", "/wrong", body=b"0123456789")
    r = conn.getresponse()
    assert r.status == 404
    r.read()
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read()) == {"ok": True}
    conn.close()


# (method, path, headers, body) -> status
BAD_REQUESTS = {
    "garbage_body": ("POST", "/detect", {"Content-Length": "12"}, b"not-an-image", 400),
    "png_signature_only": ("POST", "/detect", {"Content-Length": "8"}, b"\x89PNG\r\n\x1a\n", 400),
    "malformed_length": ("POST", "/detect", {"Content-Length": "twelve"}, b"", 400),
    "negative_length": ("POST", "/detect", {"Content-Length": "-1"}, b"", 400),
    "missing_length": ("POST", "/detect", {}, b"", 400),
    "chunked": ("POST", "/detect", {"Transfer-Encoding": "chunked"}, b"5\r\nhello\r\n0\r\n\r\n", 411),
    "unknown_get": ("GET", "/nope", {}, b"", 404),
    "unknown_post": ("POST", "/nope", {"Content-Length": "3"}, b"abc", 404),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_requests_get_their_status(serve, case):
    """Each bad request gets its code and a JSON error.  Where the body's
    end is known the connection stays usable (keep-alive after a 400 or a
    404); where it is not, the server closes it."""
    method, path, headers, body, status = BAD_REQUESTS[case]
    batcher = _stub_batcher()
    port = serve(batcher)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.putrequest(method, path, skip_accept_encoding=True)
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders(body or None)
    r = conn.getresponse()
    assert r.status == status
    assert "error" in json.loads(r.read())
    assert batcher.seen == []
    if r.will_close:
        assert case in ("malformed_length", "negative_length", "missing_length", "chunked")
    else:
        conn.request("GET", "/healthz")
        r2 = conn.getresponse()
        assert r2.status == 200 and json.loads(r2.read()) == {"ok": True}
    conn.close()


@pytest.fixture(scope="module")
def pair():
    return serving_pair()


def test_real_batcher_answers_png_and_jpeg_as_jax(serve, pair, tmp_path):
    jax_det, det = pair
    rng = np.random.RandomState(7)
    bodies = [_png_bytes(tmp_path, rng.randint(0, 256, (72, 100, 3), np.uint8))]
    for name in sorted(n for n in os.listdir(JPEG_FIXTURES) if n.endswith(".jpg")):
        with open(osp.join(JPEG_FIXTURES, name), "rb") as f:
            bodies.append(f.read())
    assert len(bodies) == 4
    want = jax_inference_detector(
        jax_det, [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)[..., ::-1] for b in bodies])
    with BatchingDetector(det, batch_size=2, max_latency_ms=20) as batcher:
        port = serve(batcher, det.classes)
        answers = [None] * len(bodies)

        def post(i):
            answers[i] = _post(port, bodies[i])

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        portrait = np.ascontiguousarray(rng.randint(0, 256, (100, 72, 3), np.uint8))
        status, err = _post(port, _png_bytes(tmp_path, portrait))
        assert status == 400 and "Pad target" in err["error"]
        stats = batcher.stats()
    assert [s for s, _ in answers] == [200] * 4
    assert all(a["classes"] == list(det.classes) and len(det.classes) == 21 for _, a in answers)
    got = [{k: np.asarray(a[k], np.float32 if k != "labels" else np.int64) for k in ("boxes", "scores", "labels")}
           for _, a in answers]
    assert sum(len(g["boxes"]) for g in got) > 4
    assert_same_detections(got, want)
    assert got[1]["boxes"][:, 2:].max() > 96  # a 480x640 JPEG's boxes in its own coordinates
    assert stats["requests"] == 4
