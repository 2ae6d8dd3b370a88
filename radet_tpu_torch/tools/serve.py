"""HTTP detection server over the dynamic-batching front end (port of
``tools/serve.py``).

    python -m radet_tpu_torch.tools.serve CONFIG [CHECKPOINT] --batch 16 \\
        --max-latency-ms 5 --port 8080 [--device cpu]

``CHECKPOINT`` is anything ``init_detector`` loads (a ``.pth``, a
trainer's ``checkpoints`` directory, a step directory or a work dir);
without one the weights are random.  Requests from concurrent connections
are batched together by :class:`radet_tpu_torch.apis.serving.BatchingDetector`.

API:
    POST /detect     body = a PNG or JPEG file  ->
                     {"boxes": [[x1, y1, x2, y2], ...], "scores": [...],
                      "labels": [...], "classes": [names...]}
    GET  /healthz    {"ok": true}
    GET  /stats      serving counters (requests, batches, fill, batch_size)

Status codes: 400 for a missing, malformed or negative Content-Length, for
a body that is not an image the port decodes and for an image that does
not fit the static input (a portrait image in a landscape ``input_size``),
with the error's text; 411 for a chunked body; 404 for an unknown path; 500
for a worker error or a closed batcher.
Each connection's thread decodes its body (``data.image_io.imdecode``, no
cv2) and waits on its request's future.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..apis import BatchingDetector, init_detector
from ..data.image_io import IMREAD_COLOR, imdecode
from ..utils.logging import get_root_logger


def make_handler(batcher, classes=(), timeout_s: float = 120.0):
    """The HTTP handler class over anything with ``submit`` and ``stats``
    (a :class:`BatchingDetector`, or a stub in tests)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"ok": True})
            if self.path == "/stats":
                return self._json(200, batcher.stats())
            return self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            # the body is read before anything else: under keep-alive an
            # unread body would be parsed as the next request.  Where its
            # end is unknown, the connection is closed after the answer.
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                self.close_connection = True
                return self._json(411, {"error": "chunked bodies are not accepted; send Content-Length"})
            length = self.headers.get("Content-Length")
            try:
                length = int(length)
                if length < 0:
                    raise ValueError
            except (TypeError, ValueError):
                self.close_connection = True
                return self._json(400, {"error": f"bad Content-Length {length!r}"})
            raw = self.rfile.read(length)
            if self.path != "/detect":
                return self._json(404, {"error": f"unknown path {self.path}"})
            try:
                # a body that is not an image the port decodes, or one that
                # does not fit the static input (a portrait image in a
                # landscape input_size), is the client's error
                fut = batcher.submit(imdecode(raw, IMREAD_COLOR))
            except (ValueError, NotImplementedError) as e:
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except RuntimeError as e:  # the batcher is closed
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            try:
                result = fut.result(timeout=timeout_s)
            except Exception as e:  # a worker error
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return self._json(200, {
                "boxes": result["boxes"].tolist(),
                "scores": result["scores"].tolist(),
                "labels": result["labels"].tolist(),
                "classes": list(classes),
            })

        def log_message(self, fmt, *args):  # no access log
            pass

    return Handler


class Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for bursts of clients:
    socketserver's default of 5 drops connections that arrive while the
    accept loop waits for the interpreter lock, and the client's TCP
    retries each dropped one a second later."""

    request_queue_size = 128


def make_server(batcher, classes=(), host: str = "127.0.0.1", port: int = 0,
                timeout_s: float = 120.0) -> Server:
    """A :class:`Server` on ``(host, port)`` (0 picks a free port) with the
    handler of :func:`make_handler`; run it with ``serve_forever()``."""
    return Server((host, port), make_handler(batcher, classes, timeout_s))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve a radet_tpu_torch detector over HTTP")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="weights (.pth, checkpoint directory); omit for random weights")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--max-latency-ms", type=float, default=5.0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="0 picks a free port (logged)")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logger = get_root_logger()
    detector = init_detector(args.config, args.checkpoint, args.cfg_options, device=args.device)
    if args.checkpoint is None:
        logger.warning("no checkpoint given: serving random weights")
    # SIGTERM ends the server as Ctrl-C does: the batcher drains and the exit code is 0
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    with BatchingDetector(detector, batch_size=args.batch, max_latency_ms=args.max_latency_ms) as batcher:
        server = make_server(batcher, detector.classes, args.host, args.port)
        logger.info("warmed up; serving on http://%s:%d (batch %d, max latency %g ms, %s)", args.host,
                    server.server_address[1], args.batch, args.max_latency_ms, args.device)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down")
        finally:
            server.server_close()


if __name__ == "__main__":
    main()
