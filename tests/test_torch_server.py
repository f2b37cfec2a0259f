"""The port's JSON-lines socket server on the CPU, the protocol cases of
tests/test_server.py: concurrent clients share the continuous batcher and
each receives transcribe()'s transcript (one case also against the JAX
package's transcribe()); live sessions give transcribe()'s finals; a
session's reader stops reading while the decoder is behind. Every socket
read has a timeout and every server is shut down in a `finally`."""

import base64
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu_torch import server as server_module
from whisper_tpu_torch.server import TranscriptionServer

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

SR = 16000
TIMEOUT_S = 120.0
EN = dict(language="en", temperature=0.0)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def reference(torch_model):
    """The port's transcribe(), once per (audio, options)."""
    cache = {}

    def run(audio, **kw):
        key = (audio if isinstance(audio, str) else audio.tobytes(), tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = torch_model.transcribe(audio, verbose=None, **kw)
        return cache[key]

    return run


def _wait_for(predicate, what, timeout=TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.fixture
def server(torch_model, tmp_path):
    sock = str(tmp_path / "wtt.sock")
    srv = TranscriptionServer(torch_model, sock, slots=2, **EN)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        _wait_for(lambda: os.path.exists(sock) and srv._listener is not None, "the socket")
        yield sock, srv
    finally:
        srv.shutdown()
        th.join(timeout=30)
        assert not th.is_alive(), "serve_forever outlived shutdown()"
        _wait_for(lambda: not any(t.is_alive() for t in srv._readers), "the readers to end", 30)
        assert not os.path.exists(sock)


def _request(sock_path: str, payload: dict) -> dict:
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(TIMEOUT_S)
    try:
        c.connect(sock_path)
        c.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while b"\n" not in buf:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
    finally:
        c.close()
    return json.loads(buf.decode())


def _clients(sock, payloads):
    out = [None] * len(payloads)
    errors = []

    def client(i):
        try:
            out[i] = _request(sock, payloads[i])
        except Exception as e:  # surfaced below, with the test's failure
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S * 2)
    assert not errors, errors
    return out


def test_server_concurrent_clients_match_transcribe_and_jax(server, tpu_model, reference, jfk_flac_path):
    sock, _ = server
    out = _clients(sock, [{"audio": jfk_flac_path}] * 3)
    ref = reference(jfk_flac_path, **EN)
    jax_ref = tpu_model.transcribe(jfk_flac_path, verbose=None, **EN)
    assert ref["text"] == jax_ref["text"]
    for r in out:
        assert r is not None and "error" not in r, r
        assert r["text"] == ref["text"] and r["language"] == "en"
        assert [s["tokens"] for s in r["segments"]] == [s["tokens"] for s in jax_ref["segments"]]
        for a, b in zip(r["segments"], jax_ref["segments"]):
            assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6


def test_server_bad_requests(server):
    sock, _ = server
    assert "error" in _request(sock, {"no_audio": 1})
    assert "error" in _request(sock, {"audio": "/nonexistent/file.flac"})
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(TIMEOUT_S)
    try:
        c.connect(sock)
        c.sendall(b"not json\n")
        assert "bad request" in json.loads(c.makefile("rb").readline())["error"]
    finally:
        c.close()


def test_server_language_field(server, jfk_flac_path):
    """A language that matches the pin (an alias too) is accepted; one that
    contradicts it is an error line, not a hang."""
    sock, _ = server
    ok = _request(sock, {"audio": jfk_flac_path, "language": "English"})
    assert "error" not in ok and ok["language"] == "en"
    assert ok["duration"] == pytest.approx(11.0, abs=0.05)
    bad = _request(sock, {"audio": jfk_flac_path, "language": "fr"})
    assert "error" in bad and "pinned" in bad["error"]


def test_server_five_clients_two_slots(server, reference, jfk_flac_path):
    sock, _ = server
    out = _clients(sock, [{"audio": jfk_flac_path}] * 5)
    assert all(r is not None and "error" not in r for r in out), out
    assert {r["text"] for r in out} == {reference(jfk_flac_path, **EN)["text"]}


def test_server_soak_no_state_leak(server, jfk_flac_path):
    """After waves of requests drain, no batcher or server table holds
    anything."""
    sock, srv = server
    results = []
    for _ in range(3):
        results += _clients(sock, [{"audio": jfk_flac_path}] * 3)
    assert all("error" not in r for r in results), results
    assert len({r["text"] for r in results}) == 1
    _wait_for(lambda: not srv._waiting and srv.batcher.pending() == 0, "the replies")
    b = srv.batcher
    assert b._streams == {} and b._langs == {} and b._results == {}
    assert not b._queue and all(t is None for t in b._slot_ticket)
    assert b.stats["requests_submitted"] == b.stats["requests_completed"] == 9


# ---- live sessions ---------------------------------------------------------------


def _open_stream(sock_path: str, opts: dict):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(TIMEOUT_S * 2)
    c.connect(sock_path)
    c.sendall((json.dumps({"stream": True, **opts}) + "\n").encode())
    f = c.makefile("rb")
    ack = json.loads(f.readline())
    assert ack.get("ack"), ack
    return c, f


def _pcm_line(audio: np.ndarray, key="pcm") -> bytes:
    if key == "pcm":
        raw = audio.astype("<f4").tobytes()
    else:
        raw = np.clip(audio * 32768.0, -32768, 32767).astype("<i2").tobytes()
    return (json.dumps({key: base64.b64encode(raw).decode()}) + "\n").encode()


def _read_stream_lines(f):
    """Lines until done or error: (lines, the done or error line)."""
    lines = []
    while True:
        line = f.readline()
        if not line:
            return lines, {"error": "connection closed"}
        msg = json.loads(line)
        if msg.get("done") or "error" in msg:
            return lines, msg
        lines.append(msg)


def _session(sock, audio, opts, chunk_s, key="pcm"):
    c, f = _open_stream(sock, opts)
    try:
        step = int(chunk_s * SR)
        for i in range(0, len(audio), step):
            c.sendall(_pcm_line(audio[i : i + step], key))
        c.sendall(b'{"end": true}\n')
        return _read_stream_lines(f)
    finally:
        c.close()


def test_server_streaming_partials_and_finals(server, reference, jfk_audio):
    """Partials before the first final; finals are transcribe()'s."""
    sock, _ = server
    audio = np.tile(jfk_audio, 3)  # 33 s
    lines, done = _session(sock, audio, {"language": "en", "partial_hop_s": 4.0}, 2.0)
    assert done.get("done"), done
    segs = [m["segment"] for m in lines]
    first_final = next(i for i, s in enumerate(segs) if not s.get("partial"))
    assert any(s.get("partial") for s in segs[:first_final]), "no partial before the first final"
    ref = reference(audio, **EN)
    assert done["text"] == ref["text"]
    finals = [s for s in segs if not s.get("partial")]
    assert [s["tokens"] for s in finals] == [s["tokens"] for s in ref["segments"]]
    assert done["duration"] == pytest.approx(33.0, abs=0.05)


def test_server_streaming_autodetect_language(server, reference, jfk_audio):
    """A session with no language detects on its first final window, as
    transcribe(language=None) does."""
    sock, _ = server
    audio = np.tile(jfk_audio, 3)
    lines, done = _session(sock, audio, {}, 4.0)
    ref = reference(audio, temperature=0.0)
    assert done.get("done"), done
    assert done["language"] == ref["language"] and done["text"] == ref["text"]


def test_server_streaming_pcm16(server, reference, jfk_audio):
    """pcm16 chunks read as s16 / 32768."""
    sock, _ = server
    quantized = np.clip(jfk_audio * 32768.0, -32768, 32767).astype(np.int16).astype(np.float32) / 32768.0
    lines, done = _session(sock, jfk_audio, {"language": "en"}, 3.0, key="pcm16")
    assert done.get("done"), done
    assert done["text"] == reference(quantized, **EN)["text"]
    assert done["duration"] == pytest.approx(11.0, abs=0.05)


def test_server_streaming_bad_line(server):
    """A malformed line answers an error and closes the session; the
    server goes on serving."""
    sock, srv = server
    c, f = _open_stream(sock, {"language": "en"})
    try:
        c.sendall(b'{"neither_pcm_nor_end": 1}\n')
        _, done = _read_stream_lines(f)
    finally:
        c.close()
    assert "pcm/pcm16/end" in done["error"]
    assert "error" in _request(sock, {"no_audio": 1})
    _wait_for(lambda: not srv._sessions, "the session to close")


def test_server_streaming_backpressure_bounds_queue(server, reference, jfk_audio, monkeypatch):
    """With the decoder held on the session's first chunk, the reader stops
    reading once the queued audio passes MAX_STREAM_PENDING_S (2 s here,
    four 0.5 s chunks): the queue holds at most six chunks of the 66 sent.
    Released, the session finishes with transcribe()'s finals."""
    sock, srv = server
    srv.MAX_STREAM_PENDING_S = 2.0
    release = threading.Event()

    class Held(server_module.StreamingTranscriber):
        def feed(self, audio):
            assert release.wait(TIMEOUT_S), "never released"
            return super().feed(audio)

    monkeypatch.setattr(server_module, "StreamingTranscriber", Held)
    audio = np.tile(jfk_audio, 3)  # 33 s: 66 chunks
    c, f = _open_stream(sock, {"language": "en"})
    sent = []

    def push():
        try:
            for i in range(0, len(audio), SR // 2):
                c.sendall(_pcm_line(audio[i : i + SR // 2]))
            c.sendall(b'{"end": true}\n')
            sent.append(True)
        except OSError as e:
            sent.append(e)

    pusher = threading.Thread(target=push, daemon=True)
    pusher.start()
    try:
        _wait_for(lambda: srv.stream_stalls >= 1, "the reader to stall")
        queued = srv._requests.qsize()
        assert 1 <= queued <= 6, f"{queued} chunks queued behind a held decoder"
        release.set()
        lines, done = _read_stream_lines(f)
        pusher.join(timeout=TIMEOUT_S)
    finally:
        release.set()
        c.close()
    assert sent == [True]
    assert done.get("done"), done
    ref = reference(audio, **EN)
    assert done["text"] == ref["text"]
    assert [m["segment"]["tokens"] for m in lines] == [s["tokens"] for s in ref["segments"]]


def test_server_shutdown_answers_queued_requests(torch_model, tmp_path):
    """A request queued when the server stops is answered with the shutdown
    error, the queue closes and the socket file goes."""
    sock = str(tmp_path / "s.sock")
    srv = TranscriptionServer(torch_model, sock, slots=1, **EN)
    a, b = socket.socketpair()
    try:
        a.settimeout(TIMEOUT_S)
        srv._requests.put(("request", b, {"audio": "/nonexistent"}))
        srv.shutdown()
        srv.serve_forever()  # returns at once, answering the queued request
        assert "shutting down" in json.loads(a.makefile("rb").readline())["error"]
        assert not srv._enqueue(("request", b, {}))  # the queue is closed
        assert not os.path.exists(sock)
    finally:
        a.close()
        b.close()


def test_server_interrupt_cleans_up(torch_model, tmp_path, monkeypatch):
    """An exception out of the serve loop (Ctrl-C in main()) still answers
    the waiting clients, ends the acceptor and removes the socket file."""
    sock = str(tmp_path / "i.sock")
    srv = TranscriptionServer(torch_model, sock, slots=1, **EN)
    calls = []

    def interrupt():
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt

    monkeypatch.setattr(srv, "_serve_once", interrupt)
    before = {t for t in threading.enumerate()}
    with pytest.raises(KeyboardInterrupt):
        srv.serve_forever()
    assert not os.path.exists(sock)
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]


def test_server_shutdown_ends_live_sessions(torch_model, tmp_path):
    """A live session still open when the server stops gets the shutdown
    error and its connection closes."""
    sock = str(tmp_path / "l.sock")
    srv = TranscriptionServer(torch_model, sock, slots=1, **EN)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        _wait_for(lambda: os.path.exists(sock) and srv._listener is not None, "the socket")
        c, f = _open_stream(sock, {"language": "en"})
        try:
            c.sendall(_pcm_line(np.zeros(SR // 10, np.float32)))
            _wait_for(lambda: any(s.fed_samples for s in list(srv._sessions)), "the first feed")
            srv.shutdown()
            lines, done = _read_stream_lines(f)
            assert "shutting down" in done["error"], done
            assert f.readline() == b""  # closed by the server
        finally:
            c.close()
    finally:
        srv.shutdown()
        th.join(timeout=30)
    assert not th.is_alive() and not srv._sessions
