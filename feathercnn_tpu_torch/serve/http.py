"""HTTP front-end for the continuous-batching server — a copy of
``feathercnn_tpu/serve/http.py`` over the port's ``InferenceServer``.

Stdlib only (``http.server``) and thin: every request thread blocks on
``InferenceServer.infer`` and the batcher underneath aggregates
concurrent requests into device batches — the HTTP layer adds no
batching logic of its own.

Routes
------
- ``POST /infer``  body = one image, either
    * ``.npy`` bytes (Content-Type ``application/x-npy``), shape (H,W,C)
      float-convertible, or
    * JSON ``{"data": [[[...]]]}`` nested lists.
  Response mirrors the request encoding (.npy bytes or ``{"result": ...}``).
- ``GET /healthz`` -> 200 ``ok`` / 503 ``unhealthy`` (SURVEY.md §5
  failure detection).
- ``GET /metrics`` -> Prometheus exposition text.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .server import InferenceFailed, InferenceServer

__all__ = ["HttpFrontend"]


class _Handler(BaseHTTPRequestHandler):
    # set by HttpFrontend
    frontend: "HttpFrontend"

    def log_message(self, fmt, *args):  # quiet: metrics cover observability
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.frontend.server
        if self.path == "/healthz":
            if srv.healthy():
                self._send(200, b"ok\n", "text/plain")
            else:
                self._send(503, b"unhealthy\n", "text/plain")
        elif self.path == "/metrics":
            self._send(200, srv.prometheus_text().encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send(404, b"not found\n", "text/plain")

    def do_POST(self):
        if self.path != "/infer":
            self._send(404, b"not found\n", "text/plain")
            return
        length = int(self.headers.get("Content-Length", 0))
        if length > self.frontend.max_body_bytes:
            self._send(413, b"payload too large\n", "text/plain")
            return
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        try:
            if "json" in ctype:
                img = np.asarray(json.loads(body)["data"], np.float32)
                as_json = True
            else:
                img = np.load(io.BytesIO(body), allow_pickle=False)
                img = np.asarray(img, np.float32)
                as_json = False
        except Exception as e:
            self._send(400, f"bad request: {e}\n".encode(), "text/plain")
            return
        expected = self.frontend.server._item_shape
        if tuple(img.shape) != expected:
            self._send(400, (f"bad shape {tuple(img.shape)}, expected "
                             f"{expected}\n").encode(), "text/plain")
            return
        srv = self.frontend.server
        try:
            out = srv.infer(img, timeout_s=self.frontend.timeout_s)
        except InferenceFailed:
            self._send(500, b"inference failed\n", "text/plain")
            return
        if out is None:
            self._send(503, b"queue closed or timed out\n", "text/plain")
            return
        if len(srv._out_names) > 1:
            # multi-output engines (two-stage detectors): every graph
            # output goes back — JSON name->nested-lists, or .npz bytes
            outs = srv.unpack_outputs(out)
            if as_json:
                self._send(200, json.dumps(
                    {"result": {k: np.asarray(v).tolist()
                                for k, v in outs.items()}}).encode(),
                    "application/json")
            else:
                buf = io.BytesIO()
                np.savez(buf, **{k: np.asarray(v, np.float32)
                                 for k, v in outs.items()})
                self._send(200, buf.getvalue(), "application/x-npz")
            return
        if as_json:
            self._send(200, json.dumps(
                {"result": np.asarray(out).tolist()}).encode(),
                "application/json")
        else:
            buf = io.BytesIO()
            np.save(buf, np.asarray(out, np.float32))
            self._send(200, buf.getvalue(), "application/x-npy")


class HttpFrontend:
    """Serve an ``InferenceServer`` over HTTP.  ``port=0`` picks a free
    port (read it back from ``.port`` — used by tests)."""

    def __init__(self, server: InferenceServer, host: str = "0.0.0.0",
                 port: int = 8000, timeout_s: float = 30.0,
                 max_body_bytes: int = None):
        self.server = server
        self.timeout_s = timeout_s
        # Reject absurd Content-Length before allocating (one malformed
        # client must not OOM the process that owns the card).  Default:
        # 8x the f32 item size (covers JSON text blow-up) + 1 MB slack.
        if max_body_bytes is None:
            item = int(np.prod(server._item_shape)) * 4
            max_body_bytes = 8 * item + (1 << 20)
        self.max_body_bytes = max_body_bytes
        handler = type("BoundHandler", (_Handler,), {"frontend": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        """Stop the loop ``start`` runs in its thread, and close the
        socket.  A ``serve_forever`` in the caller's own thread has ended
        by the time the caller gets here (the CLI's, on SIGTERM), and
        ``socketserver``'s ``shutdown`` would wait forever for a loop that
        a signal kept from starting."""
        if self._thread:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()
