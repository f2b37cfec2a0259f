"""OpenAI-compatible HTTP transcription server over the continuous batcher
(the counterpart of whisper_tpu/http_server.py).

`POST /v1/audio/transcriptions` takes the OpenAI Whisper API's
multipart/form-data upload (field `file`), so existing clients point at
this server unchanged. Concurrent uploads share the batcher's window
rounds (continuous.py). Standard library only (http.server and the email
package's multipart parser).

Endpoints:
  POST /v1/audio/transcriptions   multipart form: file (required),
                                  response_format (json | text |
                                  verbose_json; default json)
  POST /v1/audio/transcriptions/stream
                                  LIVE: a raw little-endian PCM body
                                  (Content-Length or chunked; query:
                                  encoding=f32|s16 [f32], language,
                                  partial_hop_s, word_timestamps). The
                                  response is newline-delimited JSON in
                                  chunked transfer-encoding:
                                  {"segment": {..., "partial": true}}
                                  advisories, final segments (those of
                                  transcribe()), then {"done": true, text,
                                  language, duration}.
  GET  /healthz                   {"ok": true, "model": ..., "slots": N}
  GET  /metrics                   Prometheus text: HTTP and batcher counters

Model and decoding options are fixed when the server is built. A form
`model` field is accepted and ignored (OpenAI clients always send one); a
`language` field is honoured per request when the server has no pinned
language and is a 400 where it contradicts the pin. Uploads are held in
memory while parsed; `max_uploads` (default 4) bounds how many at once.

Threads: handler threads parse and queue only; everything that touches the
model and the card runs on the one serve_forever() thread. The serve loop,
its queue and the live sessions' backpressure are server.BatcherServer,
which the unix-socket server shares; only the HTTP transport is here.

    python -m whisper_tpu_torch.http_server --port 8000 --model turbo --slots 4
    curl -s localhost:8000/v1/audio/transcriptions -F file=@clip.flac
"""

import json
import os
import tempfile
import threading
import urllib.parse
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .server import _STREAM_SESSION_KEYS, BatcherServer, Session, _json_line, serve_main

MAX_UPLOAD_BYTES = 512 << 20  # ~8.7 h of 16 kHz s16 mono
# a refused request's body up to this size is read before the reply
DRAIN_BYTES = 64 << 10


class _HTTPStream(Session):
    """One live request: the handler thread reads and converts the PCM,
    then waits for `done`; the serve thread owns the StreamingTranscriber
    and writes the chunked response frames."""

    def __init__(self, wfile, opts: dict):
        super().__init__(opts)
        self.wfile = wfile
        # orders the writes of the serve thread (frames) and the handler
        # thread (the terminal chunk of a session that timed out)
        self.wlock = threading.Lock()

    def write(self, obj: dict):
        with self.wlock:
            if self.dead:
                return
            raw = _json_line(obj)
            try:
                self.wfile.write(f"{len(raw):x}\r\n".encode() + raw + b"\r\n")
                self.wfile.flush()
            except OSError:
                self.dead = True


class _Pending:
    """One upload in flight: its handler thread waits on `event` until the
    serve thread sets `response` (status, payload dict or message)."""

    __slots__ = ("event", "response", "tmp_path", "response_format", "language")

    def __init__(self, tmp_path: str, response_format: str, language=None):
        self.event = threading.Event()
        self.response = None
        self.tmp_path = tmp_path
        self.response_format = response_format
        self.language = language


def _parse_multipart(content_type: str, body: bytes):
    """-> ({field: text}, the file part's bytes, its file name), by the
    email parser: the body is a MIME multipart document once it is given
    its Content-Type header."""
    head = f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n".encode()
    msg = BytesParser(policy=HTTP).parsebytes(head + body)
    if not msg.is_multipart():
        raise ValueError("expected multipart/form-data")
    fields, file_bytes, file_name = {}, None, None
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        if name == "file":
            file_bytes = payload
            file_name = part.get_filename() or "upload"
        else:
            fields[name] = payload.decode("utf-8", "replace").strip()
    return fields, file_bytes, file_name


def _format_response(result: dict, response_format: str):
    """-> (content type, body) in the OpenAI response schema."""
    if response_format == "text":
        return "text/plain; charset=utf-8", (result["text"].strip() + "\n").encode()
    if response_format == "verbose_json":
        segs = result.get("segments", [])
        # the batcher records the audio's true duration
        duration = result.get("duration", round(float(segs[-1]["end"]), 3) if segs else 0.0)
        body = {
            "task": "transcribe",
            "language": result.get("language"),
            "duration": float(duration),
            "text": result["text"],
            "segments": segs,
        }
        return "application/json", json.dumps(body).encode()
    return "application/json", json.dumps({"text": result["text"]}).encode()


def _stream_options(params: dict) -> dict:
    opts = {}
    for k in _STREAM_SESSION_KEYS:
        if k in params:
            v = params[k]
            if k == "partial_hop_s":
                v = float(v)
            elif k == "word_timestamps":
                v = v.lower() in ("1", "true", "yes")
            opts[k] = v
    return opts


class _ThreadingServer(ThreadingHTTPServer):
    """A thread per connection, with a listen backlog of 128: at the
    socketserver default of 5, a burst of clients overflows the accept
    queue and some of them are reset before any reply."""

    daemon_threads = True
    request_queue_size = 128


class TranscriptionHTTPServer(BatcherServer):
    def __init__(
        self,
        model,
        host: str = "127.0.0.1",
        port: int = 8000,
        slots: int = 4,
        max_uploads: int = 4,
        **batcher_options,
    ):
        # more uploads parsing at once hold 2-3x their bodies in memory each,
        # and the threading server spawns a thread per connection unbounded;
        # 0 would block every POST on the semaphore for ever
        if isinstance(max_uploads, bool) or not isinstance(max_uploads, int):
            raise ValueError(f"max_uploads={max_uploads!r} is not an int")
        if max_uploads < 1:
            raise ValueError(f"max_uploads must be >= 1, got {max_uploads}")
        super().__init__(model, slots, batcher_options)
        # HTTP counters (the batcher's are in batcher.stats), bumped from
        # handler threads under a lock
        self.http_stats = {"http_requests_total": 0, "http_errors_total": 0}
        self._stats_lock = threading.Lock()
        self._upload_sem = threading.BoundedSemaphore(max_uploads)
        self._httpd_thread: Optional[threading.Thread] = None
        self._httpd = _ThreadingServer((host, port), self._handler_class())
        self.host, self.port = self._httpd.server_address[:2]

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet: errors go to the responses
                pass

            def _send(self, status: int, content_type: str, body: bytes):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, status: int, obj: dict):
                self._send(status, "application/json", json.dumps(obj).encode())

            def _send_error_openai(self, status: int, message: str):
                server._bump("http_errors_total")
                self._send_json(status, {"error": {"message": message}})

            def _fail_before_body_read(self, status: int, message: str):
                """An error before the body was read closes the connection:
                on keep-alive the unread bytes would be parsed as the next
                request line. A Content-Length body up to DRAIN_BYTES is
                read and dropped first: closing a socket with unread bytes
                makes the kernel send a reset, which can reach the client
                before the reply. A larger or chunked body closes unread."""
                self.close_connection = True
                chunked = self.headers.get("Transfer-Encoding", "").lower() == "chunked"
                try:
                    length = int(self.headers.get("Content-Length", "0") or 0)
                except ValueError:
                    length = 0
                if not chunked and 0 < length <= DRAIN_BYTES:
                    self.rfile.read(length)
                self._send_error_openai(status, message)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, {"ok": True, "model": server.model.name, "slots": server.slots})
                elif self.path == "/metrics":
                    self._send(
                        200, "text/plain; version=0.0.4; charset=utf-8",
                        server._render_metrics().encode(),
                    )  # fmt: skip
                else:
                    self._send_error_openai(404, f"no route {self.path}")

            def _read_pcm_pieces(self):
                """The body's pieces: chunked transfer-encoding frames, or
                Content-Length read in slices. Raises past the cap, on a
                negative chunk size and on a short read."""
                total = 0
                if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
                    while True:
                        size_line = self.rfile.readline(34)
                        size = int(size_line.split(b";")[0].strip() or b"0", 16)
                        if size < 0:
                            # int(b"-10", 16) parses; a negative size would take
                            # `total` back past the cap and make the read below
                            # a read to EOF
                            raise ValueError("negative chunk size")
                        if size == 0:
                            self.rfile.readline()  # the trailing CRLF
                            return
                        total += size
                        if total > MAX_UPLOAD_BYTES:
                            raise ValueError("stream exceeds 512 MiB")
                        data = self.rfile.read(size)
                        if len(data) < size:
                            raise ValueError("connection closed mid-chunk")
                        self.rfile.readline()  # the chunk's CRLF
                        yield data
                else:
                    length = int(self.headers.get("Content-Length", "0") or 0)
                    if length <= 0:
                        raise ValueError("empty body (need Content-Length or chunked)")
                    if length > MAX_UPLOAD_BYTES:
                        raise ValueError("stream exceeds 512 MiB")
                    while length > 0:
                        piece = self.rfile.read(min(65536, length))
                        if not piece:
                            # the client died mid-upload: transcribing the
                            # truncated audio would answer done as if whole
                            raise ValueError(f"connection closed {length} bytes short of Content-Length")
                        length -= len(piece)
                        yield piece

            def do_stream(self, query: str):
                """POST /v1/audio/transcriptions/stream: PCM in, ndjson
                segments out. IO stays here; the decoding runs on the serve
                thread (BatcherServer._session_event)."""
                params = {k: v[0] for k, v in urllib.parse.parse_qs(query).items()}
                encoding = params.pop("encoding", "f32")
                if encoding not in ("f32", "s16"):
                    self._fail_before_body_read(400, f"encoding must be f32 or s16, got {encoding!r}")
                    return
                try:
                    opts = _stream_options(params)
                except ValueError as e:
                    self._fail_before_body_read(400, str(e))
                    return

                self.close_connection = True  # chunked framing by hand below
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Connection", "close")
                self.end_headers()

                sess = _HTTPStream(self.wfile, opts)
                if not server._enqueue(("open", sess, None)):
                    sess.write({"error": "server shutting down"})
                    self.wfile.write(b"0\r\n\r\n")
                    return
                itemsize = 4 if encoding == "f32" else 2
                buf = b""
                try:
                    for piece in self._read_pcm_pieces():
                        buf += piece
                        usable = len(buf) - (len(buf) % itemsize)
                        if usable == 0:
                            continue
                        raw, buf = buf[:usable], buf[usable:]
                        if encoding == "f32":
                            audio = np.frombuffer(raw, dtype="<f4").astype(np.float32)
                        else:
                            audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
                        # backpressure: stop reading the socket while the serve
                        # thread is more than the cap behind
                        if not server._queue_audio(sess, audio):
                            break  # the session ended server-side
                    server._enqueue(("end", sess, None))
                except Exception as e:
                    server._enqueue(("fail", sess, f"{type(e).__name__}: {e}"))
                # wait for the serve thread to finish the session while it
                # makes progress; give up after a slice of that length with
                # no chunk fed
                last_fed = -1
                while not sess.done.wait(timeout=server.STREAM_STALL_TIMEOUT_S):
                    if sess.fed_samples == last_fed:
                        server._bump("http_errors_total")
                        break
                    last_fed = sess.fed_samples
                # after `done` the serve thread writes nothing more; on the
                # bail-out, killing the session under wlock keeps the
                # terminal chunk from interleaving with a frame
                with sess.wlock:
                    sess.dead = True
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        pass

            def do_POST(self):
                server._bump("http_requests_total")
                # the path may carry a query (gateways add api-version)
                path, _, query = self.path.partition("?")
                path = path.rstrip("/")
                if path == "/v1/audio/transcriptions/stream":
                    self.do_stream(query)
                    return
                if path != "/v1/audio/transcriptions":
                    self._fail_before_body_read(404, f"no route {self.path}")
                    return
                length = int(self.headers.get("Content-Length", "0") or 0)
                if length <= 0:
                    self._fail_before_body_read(400, "empty body")
                    return
                if length > MAX_UPLOAD_BYTES:
                    self._fail_before_body_read(400, "upload exceeds 512 MiB")
                    return
                ctype = self.headers.get("Content-Type", "")
                if "multipart/form-data" not in ctype:
                    self._fail_before_body_read(400, "expected multipart/form-data with a 'file' field")
                    return
                with server._upload_sem:
                    body = self.rfile.read(length)
                    try:
                        fields, file_bytes, file_name = _parse_multipart(ctype, body)
                        del body
                        if not file_bytes:
                            raise ValueError("missing 'file' field")
                        # the language is checked (aliases, the pin) by
                        # batcher.submit, whose ValueError becomes a 400
                        lang = fields.get("language") or None
                        response_format = fields.get("response_format", "json")
                        if response_format not in ("json", "text", "verbose_json"):
                            raise ValueError(f"unsupported response_format {response_format!r}")
                    except Exception as e:
                        self._send_error_openai(400, str(e))
                        return
                    # the audio decoder reads a path: the upload goes to a temp file
                    suffix = os.path.splitext(file_name)[1] or ".bin"
                    fd, tmp_path = tempfile.mkstemp(prefix="wtt_http_", suffix=suffix)
                    with os.fdopen(fd, "wb") as f:
                        f.write(file_bytes)
                pending = _Pending(tmp_path, response_format, language=lang)
                if not server._enqueue(("request", pending, None)):  # the shutdown drain already ran
                    try:
                        os.unlink(tmp_path)
                    except OSError:
                        pass
                    self._send_error_openai(503, "server shutting down")
                    return
                pending.event.wait()
                status, payload = pending.response
                if status != 200:
                    self._send_error_openai(status, payload)
                    return
                ctype_out, body = _format_response(payload, response_format)
                self._send(200, ctype_out, body)

        return Handler

    # ---- serve thread ------------------------------------------------------------

    def _render_metrics(self) -> str:
        """Prometheus text: the HTTP counters, the batcher's round and
        request counters (monotonic) and its occupancy now (gauges)."""
        b = self.batcher
        lines = []

        def metric(name, kind, help_, value):
            lines.extend([f"# HELP {name} {help_}", f"# TYPE {name} {kind}", f"{name} {value}"])

        metric("wtpu_http_requests_total", "counter", "POST requests received",
               self.http_stats["http_requests_total"])
        metric("wtpu_http_errors_total", "counter", "error responses sent",
               self.http_stats["http_errors_total"])
        metric("wtpu_requests_submitted_total", "counter", "requests admitted to the batcher",
               int(b.stats["requests_submitted"]))
        metric("wtpu_requests_completed_total", "counter", "requests fully transcribed",
               int(b.stats["requests_completed"]))
        metric("wtpu_decode_rounds_total", "counter", "lockstep window rounds run",
               int(b.stats["rounds"]))
        metric("wtpu_decode_round_seconds_total", "counter", "wall seconds inside decode rounds",
               round(b.stats["round_seconds_sum"], 6))
        metric("wtpu_windows_decoded_total", "counter",
               "30s windows decoded (occupied slots x rounds)", int(b.stats["windows_decoded"]))
        metric("wtpu_slots", "gauge", "configured batcher slots", self.slots)
        metric("wtpu_requests_in_flight", "gauge", "requests admitted but not finished", b.pending())
        return "\n".join(lines) + "\n"  # fmt: skip

    def _bump(self, name: str):
        with self._stats_lock:
            self.http_stats[name] += 1

    def _request(self, pending: _Pending, _):
        self._submit(pending, pending.tmp_path, pending.language)

    def _answer(self, pending: _Pending, result: dict):
        self._resolve(pending, 200, result)

    def _refuse(self, pending: _Pending, status: int, message: str):
        self._resolve(pending, status, message)

    def _resolve(self, pending: _Pending, status: int, payload):
        try:
            os.unlink(pending.tmp_path)
        except OSError:
            pass
        pending.response = (status, payload)
        pending.event.set()

    def _open_transport(self):
        self._httpd_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._httpd_thread.start()

    def _close_transport(self):
        self._httpd.shutdown()
        self._httpd_thread.join()
        self._httpd.server_close()


def main(argv=None):
    def transport_args(parser):
        parser.add_argument("--host", default="127.0.0.1")
        parser.add_argument("--port", type=int, default=8000)
        parser.add_argument("--max_uploads", type=int, default=4, help="uploads parsed in memory at once")

    serve_main(
        argv, "OpenAI-compatible HTTP transcription server", transport_args,
        lambda model, args, kw: TranscriptionHTTPServer(
            model, args.host, args.port, slots=args.slots, max_uploads=args.max_uploads, **kw
        ),
    )  # fmt: skip


if __name__ == "__main__":
    main()
