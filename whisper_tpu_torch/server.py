"""JSON-lines transcription server on a unix socket, over the continuous
batcher (the counterpart of whisper_tpu/server.py).

Concurrent clients share the batcher's window rounds (continuous.py), so K
clients cost about one batched decode per 30 s round instead of K
transcriptions one after another.

Protocol: a client connects, sends ONE JSON line, and receives ONE back:

    -> {"audio": "/path/to/file.flac"}                 (a path on the server)
    <- {"text": "...", "segments": [...], "language": "en", "duration": 11.0}
    <- {"error": "..."}                                 (on failure)

An optional "language" field overrides detection when the server has no
pinned language (an error where it contradicts the pin). Every other
option is fixed when the server is built.

LIVE sessions (chunked audio in, partials out): a first line
`{"stream": true, ...}` turns the connection into a session over a
StreamingTranscriber (streaming.py):

    -> {"stream": true, "language": "en", "partial_hop_s": 1.0,
        "word_timestamps": false}
    <- {"ack": true}
    -> {"pcm": "<base64 float32 LE mono @16 kHz>"}      (one per chunk;
    -> {"pcm16": "<base64 int16 LE mono @16 kHz>"}       either encoding)
    <- {"segment": {..., "partial": true}}               (advisory, any time)
    <- {"segment": {...}}                                (final, any time)
    -> {"end": true}
    <- {"segment": {...}}                                (the last finals)
    <- {"done": true, "text": ..., "language": ..., "duration": ...}

Final segments are those of transcribe() on the concatenated audio. Keep
each line under 1 MiB (~6 s of float32 audio). A session's reader stops
reading its socket while more than MAX_STREAM_PENDING_S of its audio waits
to be decoded, so the client feels TCP backpressure instead of the server
buffering without bound.

Threads: client sockets are read on reader threads (IO and base64 only);
everything that touches the model and the card (submit's mel, the rounds,
the sessions' feed()/flush()) runs on the one serve_forever() thread,
which also writes the replies. That serve loop, its queue and the live
sessions' backpressure are `BatcherServer`, which the HTTP server shares;
only the transport is this module's own.

    python -m whisper_tpu_torch.server /tmp/wtt.sock --model turbo --slots 4
"""

import argparse
import base64
import json
import os
import queue
import socket
import threading
from typing import Dict, Optional, Set

import numpy as np

from .continuous import ContinuousBatcher
from .streaming import StreamingTranscriber

SAMPLE_RATE = 16000

# the options a live session may set (on its opening line here, in the
# query of the HTTP server's /stream); the others are the server's
_STREAM_SESSION_KEYS = ("language", "partial_hop_s", "word_timestamps", "task")


def _json_line(obj: dict) -> bytes:
    # segments may carry numpy scalars; item() unwraps them
    return (json.dumps(obj, default=lambda o: o.item() if hasattr(o, "item") else str(o)) + "\n").encode()


class Session:
    """One live session. Its reader thread queues the audio; the serve
    thread owns the StreamingTranscriber, feeds it, and writes the frames
    through write(), which the transport defines."""

    def __init__(self, opts: dict):
        self.opts = opts  # the session's own options (_STREAM_SESSION_KEYS)
        self.st: Optional[StreamingTranscriber] = None
        self.fed_samples = 0  # serve thread: samples fed
        self.enqueued_samples = 0  # reader thread: samples queued
        self.dead = False  # a write failed or the client left: nobody listens
        self.done = threading.Event()  # the serve thread ended the session

    def opened(self):
        """The transcriber exists (the socket protocol acks here)."""

    def write(self, obj: dict):
        raise NotImplementedError

    def finish(self):
        """After the last frame."""


class BatcherServer:
    """The core both servers share; a subclass adds the transport.

    IO threads queue events while the queue is open (`_enqueue`): requests
    ("request", client, payload) and live-session events (kind, session,
    payload) with kind "open", "feed", "end", "fail" or "abort". The one
    serve thread owns the model and the card: it admits every queued
    event, runs a batcher round while a request waits, and answers each
    request whose ticket is ready. A failed round answers its requests and
    starts a fresh batcher that keeps the monotonic counters. A session's
    reader stops reading while more than MAX_STREAM_PENDING_S of its audio
    waits for the serve thread, so the client feels TCP backpressure
    instead of the server buffering without bound. serve_forever() ends,
    on shutdown() or an exception, by closing the transport and the queue,
    answering every request still waiting and ending every session.

    A subclass defines _request(client, payload), which validates and
    calls _submit; _answer(client, result); _refuse(client, status,
    message) (status is an HTTP code); and the transport's _open_transport
    and _close_transport.
    """

    MAX_STREAM_PENDING_S = 600.0  # undecoded audio a session may queue
    STREAM_STALL_TIMEOUT_S = 600.0  # a held reader's wait for a wedged serve thread

    def __init__(self, model, slots: int, batcher_options: dict):
        self.model = model
        self.slots = slots
        self._batcher_options = dict(batcher_options)
        self.batcher = self._make_batcher()
        self._requests: "queue.Queue" = queue.Queue()
        self._waiting: Dict[int, object] = {}  # ticket -> the client waiting for it
        self._sessions: Set[Session] = set()  # open live sessions (serve thread)
        self._stop = threading.Event()
        # IO threads enqueue under this lock while the queue is open; the
        # cleanup closes it under the same lock before its one drain, so
        # nothing can land after the drain (its client would wait for ever)
        self._queue_open = True
        self._queue_lock = threading.Lock()
        # the serve thread notifies after every fed chunk and ended session;
        # a reader held back by MAX_STREAM_PENDING_S waits on it
        self._fed = threading.Condition()
        self.stream_stalls = 0  # times a session's reader waited for the decoder

    def _make_batcher(self) -> ContinuousBatcher:
        return ContinuousBatcher(self.model, slots=self.slots, **self._batcher_options)

    def _enqueue(self, item) -> bool:
        with self._queue_lock:
            if self._queue_open:
                self._requests.put(item)
                return True
        return False

    # ---- IO threads: a session's audio -------------------------------------------

    def _queue_audio(self, sess: Session, audio: np.ndarray) -> bool:
        """Queue one chunk of a session's audio, first waiting while more
        than MAX_STREAM_PENDING_S of it waits for the serve thread. False
        when the session has ended (the reader stops reading)."""

        def may_read():
            backlog = (sess.enqueued_samples - sess.fed_samples) / SAMPLE_RATE
            return sess.done.is_set() or sess.dead or backlog <= self.MAX_STREAM_PENDING_S

        with self._fed:
            if not may_read():
                self.stream_stalls += 1
                if not self._fed.wait_for(may_read, timeout=self.STREAM_STALL_TIMEOUT_S):
                    raise RuntimeError("server backlogged beyond the stream cap")
        if sess.done.is_set() or sess.dead:
            return False
        sess.enqueued_samples += len(audio)
        return self._enqueue(("feed", sess, audio))

    # ---- serve thread ------------------------------------------------------------

    def _submit(self, client, audio: str, language: Optional[str]):
        try:
            ticket = self.batcher.submit(audio, language=language)
        except ValueError as e:  # undecodable audio, bad language: the client's
            self._refuse(client, 400, str(e))
            return
        except Exception as e:  # a device or runtime fault is not the client's
            self._refuse(client, 500, f"{type(e).__name__}: {e}")
            return
        if self.batcher.ready(ticket):  # sub-second audio resolves at submit
            self._answer(client, self.batcher.pop(ticket))
        else:
            self._waiting[ticket] = client

    def _admit(self, block: bool):
        try:
            kind, target, payload = self._requests.get(timeout=0.05) if block else self._requests.get_nowait()
        except queue.Empty:
            return
        if kind == "request":
            self._request(target, payload)
        else:
            self._session_event(kind, target, payload)

    def _session_event(self, kind: str, sess: Session, payload):
        """The serve thread's half of a live session: every feed() and
        flush(), so every decode, and every frame."""
        if kind == "open":
            opts = dict(self._batcher_options)
            opts.pop("language", None)  # a session pins or detects its own
            opts.update(sess.opts)
            try:
                sess.st = StreamingTranscriber(self.model, **opts)
            except Exception as e:
                self._end_session(sess, f"{type(e).__name__}: {e}")
                return
            self._sessions.add(sess)
            sess.opened()
            return
        if sess.done.is_set() or sess.st is None:
            return  # already ended
        if kind == "feed":
            # feed() decodes every complete window now, so the decoder is at
            # most one window behind what it was handed
            sess.fed_samples += len(payload)
            try:
                for seg in sess.st.feed(payload):
                    sess.write({"segment": seg})
            except Exception as e:
                self._end_session(sess, f"{type(e).__name__}: {e}")
                return
            with self._fed:
                self._fed.notify_all()
        elif kind == "end":
            try:
                for seg in sess.st.flush():
                    sess.write({"segment": seg})
                res = sess.st.result
                sess.write({
                    "done": True, "text": res["text"], "language": res["language"],
                    "duration": sess.fed_samples / SAMPLE_RATE,
                })  # fmt: skip
            except Exception as e:
                self._end_session(sess, f"{type(e).__name__}: {e}")
                return
            self._end_session(sess)
        elif kind == "fail":
            self._end_session(sess, payload)
        elif kind == "abort":  # the client left: nobody is listening
            sess.dead = True
            self._end_session(sess)

    def _end_session(self, sess: Session, error: Optional[str] = None):
        if error is not None:
            sess.write({"error": error})
        self._sessions.discard(sess)
        sess.done.set()
        sess.finish()
        with self._fed:
            self._fed.notify_all()

    def serve_forever(self):
        """Open the transport and run window rounds until shutdown() (or an
        exception, KeyboardInterrupt included); then close the transport,
        answer every request still waiting and end every session."""
        self._open_transport()
        try:
            while not self._stop.is_set():
                self._serve_once()
        finally:
            self._stop.set()
            self._close_transport()
            self._close_all()

    def _serve_once(self):
        # every queued event admitted, then one round
        self._admit(block=not self._waiting)
        while not self._requests.empty():
            self._admit(block=False)
        if not self._waiting:
            return
        try:
            self.batcher.step()
        except Exception as e:  # a failed round must not leave clients waiting
            msg = f"decode round failed: {type(e).__name__}: {e}"
            for client in self._waiting.values():
                self._refuse(client, 500, msg)
            self._waiting.clear()
            # the failed round's streams still hold slots: start a clean
            # batcher, with the monotonic counters carried over
            stats = self.batcher.stats
            self.batcher = self._make_batcher()
            self.batcher.stats = stats
            return
        for ticket in [t for t in self._waiting if self.batcher.ready(t)]:
            # pop() evicts the ticket: a daemon keeps no state per request served
            self._answer(self._waiting.pop(ticket), self.batcher.pop(ticket))

    def _close_all(self):
        # close the queue before draining it: IO threads still running
        # answer the shutdown themselves
        with self._queue_lock:
            self._queue_open = False
        msg = "server shutting down"
        while True:
            try:
                kind, target, _ = self._requests.get_nowait()
            except queue.Empty:
                break
            if kind == "request":
                self._refuse(target, 503, msg)
            elif not target.done.is_set():
                self._end_session(target, msg)
        for client in self._waiting.values():
            self._refuse(client, 503, msg)
        self._waiting.clear()
        for sess in list(self._sessions):
            self._end_session(sess, msg)

    def shutdown(self):
        """Make serve_forever() return after its current round."""
        self._stop.set()


class _SocketSession(Session):
    def __init__(self, conn: socket.socket, opts: dict):
        super().__init__(opts)
        self.conn = conn

    def opened(self):
        self.write({"ack": True})

    def write(self, obj: dict):
        if self.dead:
            return
        try:
            self.conn.sendall(_json_line(obj))
        except OSError:
            self.dead = True

    def finish(self):
        # shutdown() first: it wakes the reader blocked in recv() and sends
        # the client its EOF, which close() alone defers while a thread
        # still reads the socket
        for end in (lambda: self.conn.shutdown(socket.SHUT_RDWR), self.conn.close):
            try:
                end()
            except OSError:
                pass


class TranscriptionServer(BatcherServer):
    REQUEST_TIMEOUT_S = 30.0
    STREAM_IDLE_TIMEOUT_S = 300.0  # a live microphone pauses, but not for 5 min
    MAX_REQUEST_BYTES = 1 << 20  # one JSON line: a path, or ~6 s of pcm
    ACCEPT_POLL_S = 0.1  # how soon the acceptor sees shutdown()

    def __init__(self, model, socket_path: str, slots: int = 4, **batcher_options):
        super().__init__(model, slots, batcher_options)
        self.socket_path = socket_path
        self._listener: Optional[socket.socket] = None
        self._acceptor_thread: Optional[threading.Thread] = None
        self._readers = []  # one thread per connection, while it lives

    @property
    def address(self) -> str:
        return self.socket_path

    # ---- IO (reader threads) -----------------------------------------------------

    def _acceptor(self):
        # accept() wakes every ACCEPT_POLL_S to look at the stop flag: not
        # every kernel wakes a blocked accept() when the socket is shut down
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # the listener closed
            reader = threading.Thread(target=self._read_request, args=(conn,), daemon=True)
            self._readers = [t for t in self._readers if t.is_alive()] + [reader]
            reader.start()

    def _read_request(self, conn: socket.socket):
        try:
            conn.settimeout(self.REQUEST_TIMEOUT_S)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                if len(buf) > self.MAX_REQUEST_BYTES:
                    raise ValueError("request exceeds 1 MiB")
            conn.settimeout(None)  # the decode may take longer
            line, _, rest = buf.partition(b"\n")
            payload = json.loads(line.decode() or "{}")
        except Exception as e:  # malformed or slow: answer and close here
            self._reply(conn, {"error": f"bad request: {e}"})
            return
        if payload.get("stream"):
            sess = _SocketSession(conn, {k: payload[k] for k in _STREAM_SESSION_KEYS if k in payload})
            if self._enqueue(("open", sess, None)):
                self._read_stream(sess, rest)
            else:
                self._reply(conn, {"error": "server shutting down"})
            return
        if not self._enqueue(("request", conn, payload)):
            self._reply(conn, {"error": "server shutting down"})

    def _read_stream(self, sess: _SocketSession, buf: bytes):
        """One session's reader: parse JSON lines, decode base64 PCM here,
        and queue the chunks for the serve thread, until {"end": true}, EOF,
        a protocol error or the session's end."""
        conn = sess.conn
        try:
            conn.settimeout(self.STREAM_IDLE_TIMEOUT_S)
            while True:
                while b"\n" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:  # the client vanished: no replies
                        self._enqueue(("abort", sess, None))
                        return
                    buf += chunk
                    if len(buf) > self.MAX_REQUEST_BYTES:
                        raise ValueError("pcm line exceeds 1 MiB; send smaller chunks")
                line, _, buf = buf.partition(b"\n")
                if not line.strip():
                    continue
                msg = json.loads(line.decode())
                if msg.get("end"):
                    self._enqueue(("end", sess, None))
                    return
                if "pcm" in msg:
                    audio = np.frombuffer(base64.b64decode(msg["pcm"]), dtype="<f4").astype(np.float32)
                elif "pcm16" in msg:
                    raw = np.frombuffer(base64.b64decode(msg["pcm16"]), dtype="<i2")
                    audio = raw.astype(np.float32) / 32768.0
                else:
                    raise ValueError("stream line must carry pcm/pcm16/end")
                if not self._queue_audio(sess, audio):
                    if sess.dead:  # the replies failed: let the serve thread clean up
                        self._enqueue(("abort", sess, None))
                    return
        except Exception as e:
            # the serve thread owns the session: it reports and cleans up
            self._enqueue(("fail", sess, f"{type(e).__name__}: {e}"))

    @staticmethod
    def _reply(conn: socket.socket, obj: dict):
        try:
            conn.sendall(_json_line(obj))
        except OSError:
            pass
        finally:
            conn.close()

    # ---- the serve thread's transport --------------------------------------------

    def _request(self, conn: socket.socket, payload: dict):
        audio = payload.get("audio")
        if not isinstance(audio, str):
            self._reply(conn, {"error": "request must carry an 'audio' path"})
            return
        self._submit(conn, audio, payload.get("language"))

    def _answer(self, conn: socket.socket, result: dict):
        self._reply(conn, result)

    def _refuse(self, conn: socket.socket, status: int, message: str):
        self._reply(conn, {"error": message})

    def _open_transport(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        self._listener.settimeout(self.ACCEPT_POLL_S)  # accepted sockets stay blocking
        self._acceptor_thread = threading.Thread(target=self._acceptor, daemon=True)
        self._acceptor_thread.start()

    def _close_transport(self):
        self._acceptor_thread.join()
        self._listener.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


def serve_main(argv, description: str, add_transport_args, make_server):
    """The servers' main(): the shared model and decoding options, the
    transport's own (`add_transport_args(parser)`), and
    `make_server(model, args, batcher_options)`; serves until Ctrl-C."""
    import torch

    from . import load_model

    parser = argparse.ArgumentParser(description=description)
    add_transport_args(parser)
    parser.add_argument("--model", default="turbo", help="a registry name, or a local .pt / .npz checkpoint")
    parser.add_argument("--device", default="cuda", help="cuda (a card is required) or cpu")
    parser.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--weights", default="bf16", choices=["bf16", "int8"], help="decode-loop weight storage (int8: weight-only quantized)")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--language", default=None)
    parser.add_argument("--beam_size", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=None)
    parser.add_argument("--word_timestamps", action="store_true", help="segments carry per-word times")
    args = parser.parse_args(argv)

    model = load_model(
        args.model, compute_dtype=getattr(torch, args.compute_dtype), device=args.device,
        weights=args.weights,
    )  # fmt: skip
    kw = dict(language=args.language, word_timestamps=args.word_timestamps)
    if args.beam_size is not None:
        kw["beam_size"] = args.beam_size
    if args.temperature is not None:
        kw["temperature"] = args.temperature
    srv = make_server(model, args, kw)
    print(f"serving on {srv.address} (slots={args.slots}, device={model.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass  # serve_forever has answered its clients and closed the transport


def main(argv=None):
    serve_main(
        argv, "continuous-batching transcription server (unix socket)",
        lambda p: p.add_argument("socket", help="unix socket path to listen on"),
        lambda model, args, kw: TranscriptionServer(model, args.socket, slots=args.slots, **kw),
    )  # fmt: skip


if __name__ == "__main__":
    main()
