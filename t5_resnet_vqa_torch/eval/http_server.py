"""HTTP serving front end over ``VQAInferenceSession`` (the JAX package's
``eval/http_server.py``, the same protocol byte for byte; standard library
only).

Endpoints (all JSON):

  GET  /healthz      -> {"status": "ok", "family", "batch_size",
                         "answer_space_size", "requests_served"}
  POST /v1/ask       -> body {"image_path"|"image_b64", "question",
                         "top_k"?}        -> session.ask result
  POST /v1/ask_batch -> body {"requests": [{"image_path"|"image_b64",
                         "question"}...], "top_k"?}
                                          -> {"results": [...]}
  POST /v1/generate  -> body {"image_path"|"image_b64", "question",
                         "num_beams"?, "max_answer_length"?}
                                          -> session.generate result
                         (ViT encoder-decoder family only; 400 otherwise)

  * Threaded I/O, serialized compute: ``ThreadingHTTPServer`` keeps slow
    clients from blocking each other, but every session call holds one
    lock: one model owns the card, and the session's ``ask_batch``
    chunking is the batching mechanism, so clients that want throughput
    send /v1/ask_batch.
  * ``image_b64`` bodies are written to a private temp file, because the
    collate's image loaders take file paths; the file is removed before
    the response is sent. Bodies are bounded by ``MAX_BODY_BYTES``.
  * ``image_path`` is checked against ``image_root`` when one is given;
    without one it is refused on a non-loopback bind.
  * Errors are JSON ``{"error": msg}`` with 400 (bad request), 404 (unknown
    route) or 500 (unexpected), never a stack trace on the wire.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

MAX_BODY_BYTES = 64 * 1024 * 1024   # bounds request memory (b64 images)


class VQAHTTPServer:
    """Bind a ``VQAInferenceSession`` to an HTTP port.

    ``serve_forever()`` blocks; ``start()`` runs the loop on a daemon
    thread and returns (used by tests and by embedders); ``close()`` shuts
    the socket down. ``port`` reflects the bound port (pass port=0 for an
    ephemeral one).
    """

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8000,
                 default_top_k: int = 1, logger=None,
                 image_root: Optional[str] = None):
        self.session = session
        self.default_top_k = int(default_top_k)
        self._lock = threading.Lock()      # one model owns the card
        self._log = logger
        self.requests_served = 0
        # image_path policy (an unrestricted path would be a
        # file-existence oracle over the server's filesystem on
        # non-loopback binds, and 400s would echo the probed path back):
        #   image_root set      -> paths must resolve under it; rejected
        #                          paths are never echoed
        #   unset, loopback     -> passthrough (a local caller already has
        #                          filesystem access)
        #   unset, non-loopback -> image_path refused entirely; remote
        #                          clients must send image_b64
        self.image_root = (os.path.realpath(image_root)
                           if image_root else None)
        self._loopback = host in ("127.0.0.1", "::1", "localhost")
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def serve_forever(self):
        self._httpd.serve_forever()

    def start(self) -> "VQAHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------- requests

    def handle(self, method: str, path: str, body: Optional[dict]):
        """Route one request; returns (status, payload dict)."""
        if method == "GET" and path == "/healthz":
            return 200, {
                "status": "ok",
                "family": self.session.family,
                "batch_size": self.session.batch_size,
                "answer_space_size": len(self.session.answer_spaces),
                "requests_served": self.requests_served,
            }
        if method != "POST":
            return 404, {"error": f"unknown route {method} {path}"}
        if path == "/v1/ask":
            return self._ask(body)
        if path == "/v1/ask_batch":
            return self._ask_batch(body)
        if path == "/v1/generate":
            return self._generate(body)
        return 404, {"error": f"unknown route {method} {path}"}

    def _ask(self, body):
        with _resolve_image(body, self) as img:
            question = _require(body, "question")
            top_k = int(body.get("top_k", self.default_top_k))
            with self._lock:
                res = self.session.ask(img, question, top_k=top_k)
        self.requests_served += 1
        return 200, res

    def _ask_batch(self, body):
        reqs = body.get("requests")
        if not isinstance(reqs, list) or not reqs:
            raise _BadRequest("'requests' must be a non-empty list")
        top_k = int(body.get("top_k", self.default_top_k))
        resolved = [_resolve_image(r, self) for r in reqs]
        try:
            pairs = [(ctx.__enter__(), _require(r, "question"))
                     for ctx, r in zip(resolved, reqs)]
            with self._lock:
                results = self.session.ask_batch(pairs, top_k=top_k)
        finally:
            for ctx in resolved:
                ctx.__exit__(None, None, None)
        self.requests_served += len(reqs)
        return 200, {"results": results}

    def _generate(self, body):
        with _resolve_image(body, self) as img:
            question = _require(body, "question")
            kwargs = dict(
                num_beams=int(body.get("num_beams", 1)),
                max_answer_length=int(body.get("max_answer_length", 5)))
            try:
                with self._lock:
                    res = self.session.generate(img, question, **kwargs)
            except ValueError as e:     # non-enc-dec family
                raise _BadRequest(str(e))
        self.requests_served += 1
        return 200, res


class _BadRequest(Exception):
    pass


def _require(body, key):
    if not isinstance(body, dict) or not isinstance(body.get(key), str):
        raise _BadRequest(f"missing string field '{key}'")
    return body[key]


class _resolve_image:
    """Context manager yielding a filesystem path for a request's image:
    ``image_path`` is validated against the server's image_root policy (see
    VQAHTTPServer.__init__ — never echoed back in errors), ``image_b64``
    lands in a temp file removed on exit."""

    def __init__(self, body, server: "VQAHTTPServer"):
        self.body = body if isinstance(body, dict) else {}
        self.server = server
        self.tmp = None

    def __enter__(self) -> str:
        path = self.body.get("image_path")
        if path is not None:
            srv = self.server
            if not isinstance(path, str):
                raise _BadRequest("image_path must be a string")
            if srv.image_root is not None:
                real = os.path.realpath(path)
                if not (real == srv.image_root
                        or real.startswith(srv.image_root + os.sep)):
                    # no path echo: outside-root probes get a constant reply
                    raise _BadRequest(
                        "image_path outside the served image root")
                path = real
            elif not srv._loopback:
                raise _BadRequest(
                    "image_path is disabled on non-loopback binds without "
                    "--image-root; send image_b64 instead")
            if not os.path.isfile(path):
                raise _BadRequest("image_path not found")
            return path
        b64 = self.body.get("image_b64")
        if not isinstance(b64, str):
            raise _BadRequest("need 'image_path' or 'image_b64'")
        try:
            raw = base64.b64decode(b64, validate=True)
        except Exception:
            raise _BadRequest("image_b64 is not valid base64")
        fd, self.tmp = tempfile.mkstemp(suffix=".png", prefix="vqa_req_")
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        return self.tmp

    def __exit__(self, *exc):
        if self.tmp is not None:
            try:
                os.unlink(self.tmp)
            except OSError:
                pass
        return False


def _make_handler(server: VQAHTTPServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route through our logger
            if server._log is not None:
                server._log(f"{self.address_string()} {fmt % args}")

        def _reply(self, status: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _dispatch(self, method):
            body = None
            if method == "POST":
                n = int(self.headers.get("Content-Length") or 0)
                if n > MAX_BODY_BYTES:
                    return self._reply(
                        400, {"error": f"body over {MAX_BODY_BYTES} bytes"})
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._reply(400, {"error": "body is not JSON"})
            try:
                status, payload = server.handle(method, self.path, body)
            except _BadRequest as e:
                status, payload = 400, {"error": str(e)}
            except Exception as e:          # never a stack trace on the wire
                status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            self._reply(status, payload)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    return Handler
