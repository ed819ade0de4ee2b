"""HTTP front end for the continuous-batching engines.

A threaded stdlib HTTP server (no extra dependencies) in front of a
:class:`~.engine.DecodeEngine`, a :class:`~.vision.VisionEngine`, or both.
Handler threads do host work only (JSON, the tokenizer, image decoding and
resizing in numpy) and block on engine requests; all device work stays on
each engine's own worker thread, so many concurrent clients feed one
continuously batched device loop. The API is the JAX package's
(``ggml_experiments_tpu/serving/http.py``).

Endpoints (JSON in and out):

* ``POST /v1/generate``: body ``{"prompt": str, "max_new_tokens"?: int,
  "temperature"?: float, "stream"?: bool}``. Without ``stream`` the reply is
  the whole result (``id``, ``tokens`` with the prompt echoed, ``text``,
  ``canceled``); with it, chunked newline-delimited JSON: ``{"id"}``, one
  ``{"token", "text"}`` object per token as the engine's ``on_token``
  delivers it, then ``{"done": true, "id", "generated", "canceled"}``.
* ``GET /v1/health``: liveness, slot occupancy, the vision backlog.
* ``GET /v1/stats``: the decode engine's counters.
* ``DELETE /v1/requests/<id>``: cancel a generate request by its id.
* ``POST /v1/classify`` and ``POST /v1/features`` (with a vision engine): a
  raw image body (PNG, JPEG, PPM, BMP or GIF, sniffed by magic; TGA, which
  has none, by ``Content-Type: image/*``) or JSON ``{"image_b64": ...,
  "top_k"?: int, "full"?: bool}``. ``classify`` replies the top-k
  ``[class, logit]`` pairs; ``features`` the feature shape and the
  reference's debug vector (``first5`` / ``last5`` of the channels at
  (0, 0)), and with ``full`` the whole map.
* ``GET /v1/vision/stats``: the vision engine's counters and wall breakdown.

Errors: 400 for a malformed request, 404 for an unknown path or id, 413 for
a body over ``max_body_bytes`` (the JAX front end reads any length), 429
when an engine's queue is full, 500 when an engine has failed, 504 when a
request outlives ``request_timeout_s`` (the request is canceled). A client
that disconnects before its reply cancels its request.
"""

from __future__ import annotations

import base64
import json
import queue
import select
import socket
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ggml_experiments_tpu_torch.serving.engine import DecodeEngine, Request
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

# the largest request body read; a raw 256 px image is ~200 KB, a photo a few MB
MAX_BODY_BYTES = 16 << 20
# the magic numbers a raw image body is recognised by (TGA has none)
IMAGE_MAGIC = (b"\x89PNG\r\n\x1a\n", b"P6", b"P3", b"BM", b"\xff\xd8", b"GIF87a", b"GIF89a")
_STREAM_END = object()
_POLL_S = 0.25   # how often a waiting handler looks for a departed client


class HttpFrontend:
    """Serve started engines over HTTP.

    ``port=0`` binds an ephemeral port (read ``.port`` after construction).
    """

    def __init__(self, engine: Optional[DecodeEngine], tokenizer: Optional[CharTokenizer] = None,
                 *, vision=None, host: str = "127.0.0.1", port: int = 0,
                 default_max_new_tokens: int = 200, request_timeout_s: float = 600.0,
                 max_body_bytes: int = MAX_BODY_BYTES):
        if engine is None and vision is None:
            raise ValueError("HttpFrontend needs a DecodeEngine, a VisionEngine, or both")
        self.engine = engine
        self.vision = vision
        self.tokenizer = tokenizer or CharTokenizer()
        self.default_max_new_tokens = default_max_new_tokens
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = int(max_body_bytes)
        self._requests: Dict[int, Request] = {}
        self._req_lock = threading.Lock()
        self._server = ThreadingHTTPServer((host, port), _make_handler(self))
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                            name="http-frontend")
            self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._server.server_close()

    def _track(self, req: Request) -> None:
        with self._req_lock:
            self._requests[req.id] = req
            # bound the registry: finished requests older than the newest 512
            # are of no further cancel interest; running ones stay cancelable
            if len(self._requests) > 1024:
                for rid in sorted(self._requests)[:-512]:
                    r = self._requests[rid]
                    if r._done.is_set():
                        del self._requests[rid]

    def find(self, req_id: int) -> Optional[Request]:
        with self._req_lock:
            return self._requests.get(req_id)


class _BadRequest(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def _make_handler(front: HttpFrontend):
    tok = front.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "gxt-serve/1"

        def log_message(self, fmt, *args):  # noqa: D102 - no per-request stderr lines
            pass

        def handle(self):  # noqa: D102
            try:
                super().handle()
            except (ConnectionResetError, BrokenPipeError):
                pass   # the client left a kept-alive connection: nothing to answer

        def _json(self, code: int, obj) -> None:
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            """The request body, at most ``max_body_bytes``. An over-long
            body is not read, so the connection closes after the reply."""
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                raise _BadRequest(400, "bad Content-Length")
            if length > front.max_body_bytes:
                self.close_connection = True
                raise _BadRequest(413, f"request body of {length} bytes is over the "
                                       f"{front.max_body_bytes}-byte limit")
            return self.rfile.read(length)

        def _client_gone(self) -> bool:
            """True once the client closed its end (a readable socket with
            nothing to read)."""
            try:
                readable, _, _ = select.select([self.connection], [], [], 0)
                return bool(readable) and self.connection.recv(1, socket.MSG_PEEK) == b""
            except (OSError, ValueError):
                return True

        def _wait(self, req, kind: str):
            """``req``'s result; None after replying 504 (timeout) or 500
            (engine failure), or when the client left (the request is
            canceled either way)."""
            waited = 0.0
            while not req._done.wait(_POLL_S):
                waited += _POLL_S
                if self._client_gone():
                    req.cancel()
                    return None
                if waited >= front.request_timeout_s:
                    req.cancel()
                    self._json(504, {"id": req.id, "error": f"{kind} timed out"})
                    return None
            try:
                return req.result(timeout=0)
            except RuntimeError as ex:
                self._json(500, {"id": req.id, "error": str(ex)})
                return None

        # -- GET / DELETE -------------------------------------------------------

        def do_GET(self):  # noqa: N802
            eng, vis = front.engine, front.vision
            if self.path == "/v1/health":
                errs = [e for e in (getattr(eng, "error", None), getattr(vis, "error", None))
                        if e is not None]
                out = {"status": "error" if errs else "ok"}
                if eng is not None:
                    out.update(slots=eng.n_slots, active=len(eng.active_requests()),
                               pending=eng.pending_count())
                if vis is not None:
                    out["vision_pending"] = vis._pending
                self._json(200, out)
            elif self.path == "/v1/stats" and eng is not None:
                s = eng.stats
                self._json(200, {
                    "tokens_generated": s.tokens_generated,
                    "requests_completed": s.requests_completed,
                    "requests_canceled": s.requests_canceled,
                    "device_steps": s.device_steps,
                    "wall_time_s": s.wall_time_s,
                    "tokens_per_s": s.tokens_per_s,
                })
            elif self.path == "/v1/vision/stats" and vis is not None:
                s = vis.stats
                self._json(200, {"images_done": s.images_done,
                                 "requests_canceled": s.requests_canceled,
                                 "batches": s.batches, "wall_time_s": s.wall_time_s,
                                 **s.breakdown()})
            else:
                self._json(404, {"error": f"no such path {self.path!r}"})

        def do_DELETE(self):  # noqa: N802
            prefix = "/v1/requests/"
            if not self.path.startswith(prefix):
                self._json(404, {"error": f"no such path {self.path!r}"})
                return
            try:
                rid = int(self.path[len(prefix):])
            except ValueError:
                self._json(400, {"error": "request id must be an integer"})
                return
            req = front.find(rid)
            if req is None:
                self._json(404, {"error": f"unknown request id {rid}"})
                return
            req.cancel()
            self._json(200, {"id": rid, "canceled": True})

        # -- POST ---------------------------------------------------------------

        def do_POST(self):  # noqa: N802
            try:
                if self.path in ("/v1/classify", "/v1/features"):
                    self._vision_post(self.path[len("/v1/"):])
                elif self.path == "/v1/generate" and front.engine is not None:
                    self._generate()
                else:
                    self.close_connection = True   # the body stays unread
                    self._json(404, {"error": f"no such path {self.path!r}"})
            except _BadRequest as ex:
                self._json(ex.code, {"error": str(ex)})

        def _read_image(self):
            """(image, top_k, full) from the body: the preprocessed (S, S, 3)
            image at the engine's transport."""
            from ggml_experiments_tpu_torch.utils import image as image_utils
            from ggml_experiments_tpu_torch.utils import image_codecs

            body = self._body()
            try:
                top_k, full = 5, False
                if (self.headers.get("Content-Type", "").startswith("image/")
                        or body.startswith(IMAGE_MAGIC)):
                    raw = body
                else:
                    payload = json.loads(body or b"{}")
                    raw = base64.b64decode(payload["image_b64"], validate=True)
                    top_k = int(payload.get("top_k", 5))
                    full = bool(payload.get("full", False))
                u8 = image_codecs.decode(raw)
                size = front.vision.image_size
                if front.vision.transport == "u8":
                    # the u8 canvas: the engine applies x/255 on the device
                    return image_utils.preprocess_canvas_u8(u8, size=size), top_k, full
                return image_utils.preprocess(u8, size=size), top_k, full
            except (KeyError, TypeError, ValueError, IndexError, struct.error,
                    zlib.error) as ex:
                raise _BadRequest(400, f"bad image request: {ex}") from ex

        def _vision_post(self, kind: str) -> None:
            if front.vision is None:
                self.close_connection = True
                self._json(404, {"error": "no vision engine attached"})
                return
            img, top_k, full = self._read_image()
            try:
                req = front.vision.submit(img, kind=kind)
            except RuntimeError as ex:    # the backlog is full, or the engine died
                self._json(429 if "backlog" in str(ex) else 500, {"error": str(ex)})
                return
            except ValueError as ex:      # a kind the checkpoint cannot serve
                self._json(400, {"error": str(ex)})
                return
            out = self._wait(req, "inference")
            if out is None:
                return
            if kind == "classify":
                order = np.argsort(out)[::-1][:top_k]
                self._json(200, {"id": req.id,
                                 "top": [[int(i), float(out[i])] for i in order]})
                return
            vec = out[0, 0]   # the reference's debug vector position
            resp = {"id": req.id, "shape": list(out.shape),
                    "first5": [float(v) for v in vec[:5]],
                    "last5": [float(v) for v in vec[-5:]]}
            if full:
                resp["features"] = out.tolist()
            self._json(200, resp)

        def _generate(self) -> None:
            eng = front.engine
            try:
                payload = json.loads(self._body() or b"{}")
                prompt = payload["prompt"]
                if not isinstance(prompt, str) or not prompt:
                    raise ValueError("'prompt' must be a non-empty string")
                max_new = int(payload.get("max_new_tokens", front.default_max_new_tokens))
                temperature = payload.get("temperature")
                if temperature is not None:
                    temperature = float(temperature)
                stream = bool(payload.get("stream", False))
            except (KeyError, TypeError, ValueError, AttributeError) as ex:
                raise _BadRequest(400, f"bad request: {ex}") from ex
            if eng.error is not None:
                self._json(500, {"error": f"engine failed: {eng.error!r}"})
                return
            token_q: Optional[queue.Queue] = queue.Queue() if stream else None
            try:
                req = eng.submit(tok.encode(prompt[: eng.max_prompt]), max_new,
                                 temperature=temperature,
                                 on_token=token_q.put if stream else None)
            except ValueError as ex:
                self._json(400, {"error": str(ex)})
                return
            except RuntimeError as ex:    # backpressure, or the engine died
                self._json(429 if "backpressure" in str(ex) else 500, {"error": str(ex)})
                return
            front._track(req)
            if not stream:
                tokens = self._wait(req, "generation")
                if tokens is not None:
                    self._json(200, {"id": req.id, "tokens": [int(t) for t in tokens],
                                     "text": tok.decode(int(t) for t in tokens),
                                     "canceled": req.canceled})
                return
            self._stream(req, token_q)

        def _stream(self, req: Request, token_q: queue.Queue) -> None:
            """Chunked NDJSON, one line per token as it lands. A watcher
            turns the request's end into a sentinel, so this loop never hangs
            on a canceled or failed request."""
            def watch():
                if not req._done.wait(front.request_timeout_s):
                    req.cancel()   # a timed-out stream frees its slot
                token_q.put(_STREAM_END)

            threading.Thread(target=watch, daemon=True).start()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj) -> bool:
                data = (json.dumps(obj) + "\n").encode()
                try:
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()
                    return True
                except (BrokenPipeError, ConnectionResetError):
                    req.cancel()   # the client went away: free the slot
                    return False

            if not chunk({"id": req.id}):
                return
            n = 0
            while True:
                try:
                    t = token_q.get(timeout=_POLL_S)
                except queue.Empty:
                    if self._client_gone():
                        req.cancel()
                        return
                    continue
                if t is _STREAM_END:
                    break
                n += 1
                if not chunk({"token": int(t), "text": tok.decode([int(t)])}):
                    return
            final = {"done": True, "id": req.id, "generated": n, "canceled": req.canceled}
            if req._error is not None:
                final["error"] = str(req._error)
            if chunk(final):
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass

    return Handler
