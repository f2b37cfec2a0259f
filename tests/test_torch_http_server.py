"""The port's OpenAI-compatible HTTP server on the CPU, the protocol cases
of tests/test_http_server.py: multipart uploads through the continuous
batcher return transcribe()'s transcript (one case also against the JAX
package's transcribe()) in each response_format; malformed requests get
OpenAI-schema errors; live PCM sessions give transcribe()'s finals. Every
request has a timeout and every server is shut down in a `finally`."""

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu_torch import server as server_module
from whisper_tpu_torch.http_server import TranscriptionHTTPServer, _Pending

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


@pytest.fixture(scope="module")
def jfk_bytes(jfk_flac_path):
    with open(jfk_flac_path, "rb") as f:
        return f.read()


class _Running:
    """A server with serve_forever() on a thread; stop() shuts it down and
    checks that its threads end."""

    def __init__(self, model, **kw):
        self.srv = TranscriptionHTTPServer(model, "127.0.0.1", 0, **kw)
        self.url = f"http://{self.srv.host}:{self.srv.port}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.srv.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive(), "serve_forever outlived shutdown()"
        assert not self.srv._httpd_thread.is_alive(), "the HTTP thread outlived shutdown()"


@pytest.fixture(scope="module")
def http_server(torch_model):
    running = _Running(torch_model, slots=2, **EN)
    try:
        yield running.url, running.srv
    finally:
        running.stop()


def _multipart(fields: dict, file_bytes: bytes, filename: str):
    boundary = uuid.uuid4().hex
    parts = [
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
        for k, v in fields.items()
    ]
    parts.append(
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{filename}"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n".encode() + file_bytes + b"\r\n"
    )
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _post(url: str, body: bytes, content_type: str, timeout=TIMEOUT_S):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _upload(url, data, fields=None, query=""):
    body, ctype = _multipart(fields or {}, data, "jfk.flac")
    return _post(f"{url}/v1/audio/transcriptions{query}", body, ctype)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
        return r.headers.get("Content-Type", ""), r.read()


def test_healthz(http_server):
    url, _ = http_server
    body = json.loads(_get(f"{url}/healthz")[1])
    assert body == {"ok": True, "model": body["model"], "slots": 2}


def test_transcription_json_matches_transcribe_and_jax(http_server, tpu_model, reference, jfk_flac_path, jfk_bytes):
    url, _ = http_server
    status, rtype, resp = _upload(url, jfk_bytes, {"model": "whisper-1"})
    assert status == 200 and rtype.startswith("application/json"), resp
    jax_ref = tpu_model.transcribe(jfk_flac_path, verbose=None, **EN)
    assert json.loads(resp) == {"text": reference(jfk_flac_path, **EN)["text"]} == {"text": jax_ref["text"]}


def test_response_formats(http_server, reference, jfk_flac_path, jfk_bytes, jfk_audio):
    url, _ = http_server
    ref = reference(jfk_flac_path, **EN)
    status, rtype, resp = _upload(url, jfk_bytes, {"response_format": "text"})
    assert status == 200 and rtype.startswith("text/plain")
    assert resp.decode().strip() == ref["text"].strip()

    status, _, resp = _upload(url, jfk_bytes, {"response_format": "verbose_json"})
    assert status == 200
    out = json.loads(resp)
    assert out["task"] == "transcribe" and out["language"] == "en" and out["text"] == ref["text"]
    assert [s["tokens"] for s in out["segments"]] == [s["tokens"] for s in ref["segments"]]
    # the audio's true length, not the last segment's end
    assert out["duration"] == pytest.approx(len(jfk_audio) / SR, abs=0.05)


def test_concurrent_uploads_share_slots(http_server, reference, jfk_flac_path, jfk_bytes):
    url, srv = http_server
    rounds = srv.batcher.stats["rounds"]
    out = [None] * 3

    def client(i):
        out[i] = _upload(url, jfk_bytes)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S * 2)
    for status, _, resp in out:
        assert status == 200
        assert json.loads(resp)["text"] == reference(jfk_flac_path, **EN)["text"]
    assert srv.batcher.stats["rounds"] - rounds <= 3  # two slots: at least one shared round


def test_http_errors(http_server):
    url, srv = http_server
    body, ctype = _multipart({"model": "whisper-1"}, b"", "x")
    status, _, resp = _post(f"{url}/v1/audio/transcriptions", body, ctype)
    assert status == 400 and "file" in json.loads(resp)["error"]["message"]
    status, _, _ = _post(f"{url}/v1/audio/transcriptions", b'{"x": 1}', "application/json")
    assert status == 400
    status, _, resp = _upload(url, b"RIFFxxxx", {"language": "fr"})
    assert status == 400 and "pinned" in json.loads(resp)["error"]["message"]
    status, _, _ = _upload(url, b"not audio at all")
    assert status == 400
    body, ctype = _multipart({"response_format": "srt"}, b"x", "a.wav")
    status, _, resp = _post(f"{url}/v1/audio/transcriptions", body, ctype)
    assert status == 400 and "response_format" in json.loads(resp)["error"]["message"]
    status, _, _ = _post(f"{url}/v1/other", b"", "text/plain")
    assert status == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{url}/nope")
    assert e.value.code == 404
    assert srv._waiting == {} and srv.batcher.pending() == 0


def test_keepalive_discipline(http_server, jfk_bytes):
    """An error before the body is read closes the connection; one after it
    keeps the connection usable, also for a path with a query."""
    url, _ = http_server
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/v1/audio/transcriptions", b'{"x": 1}', {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 400 and (r.getheader("Connection") or "").lower() == "close"
        r.read()
    finally:
        conn.close()
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=TIMEOUT_S)
    try:
        body, ctype = _multipart({"model": "whisper-1"}, b"", "x")
        conn.request("POST", "/v1/audio/transcriptions", body, {"Content-Type": ctype})
        r = conn.getresponse()
        assert r.status == 400 and "file" in json.loads(r.read())["error"]["message"]
        body, ctype = _multipart({}, jfk_bytes, "jfk.flac")
        conn.request("POST", "/v1/audio/transcriptions?api-version=2026-08", body, {"Content-Type": ctype})
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["text"]
    finally:
        conn.close()


def test_counters_under_concurrent_errors(http_server):
    """Sixteen clients (more than the cores) each send three requests that
    fail before the decoder, with the interpreter switching threads every
    microsecond: no bump of the shared HTTP counters is lost."""
    import sys

    url, srv = http_server
    before = dict(srv.http_stats)
    errors = []

    def client():
        try:
            for _ in range(3):
                assert _post(f"{url}/v1/other", b"x", "text/plain")[0] == 404
        except Exception as e:  # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert srv.http_stats["http_requests_total"] - before["http_requests_total"] == 48
    assert srv.http_stats["http_errors_total"] - before["http_errors_total"] == 48


def test_refused_posts_with_bodies_read_their_replies(http_server):
    """200 posts in turn, each with a body the server refuses before
    reading it (a 404 route, a bad stream encoding): every client reads its
    reply, none sees the reset that closing a socket with unread bytes sends."""
    url, srv = http_server
    before = dict(srv.http_stats)
    body = b"x" * 32768  # past the handler's 8 KiB read buffer: the drain reads the socket
    for i in range(200):
        path = "/v1/other" if i % 2 else "/v1/audio/transcriptions/stream?encoding=mp3"
        status, _, resp = _post(f"{url}{path}", body, "application/octet-stream")
        assert status == (404 if i % 2 else 400) and json.loads(resp)["error"]["message"], i
    assert srv.http_stats["http_errors_total"] - before["http_errors_total"] == 200


def test_rejected_submits_do_not_count_as_admitted(http_server):
    url, srv = http_server
    before = int(srv.batcher.stats["requests_submitted"])
    status, _, _ = _upload(url, b"not audio at all")
    assert status == 400
    assert int(srv.batcher.stats["requests_submitted"]) == before


def test_word_timestamps_in_verbose_json(torch_model, reference, jfk_flac_path, jfk_bytes):
    running = _Running(torch_model, slots=1, word_timestamps=True, **EN)
    try:
        status, _, resp = _upload(running.url, jfk_bytes, {"response_format": "verbose_json"})
    finally:
        running.stop()
    assert status == 200
    got = [w for s in json.loads(resp)["segments"] for w in s.get("words", [])]
    want = [w for s in reference(jfk_flac_path, word_timestamps=True, **EN)["segments"] for w in s["words"]]
    assert got and [w["word"] for w in got] == [w["word"] for w in want]
    for a, b in zip(got, want):
        assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6


def test_metrics_endpoint(http_server, jfk_bytes):
    url, _ = http_server
    status, _, _ = _upload(url, jfk_bytes)
    assert status == 200
    ctype, text = _get(f"{url}/metrics")
    assert ctype.startswith("text/plain")
    vals = {
        line.split()[0]: float(line.split()[1])
        for line in text.decode().splitlines()
        if line and not line.startswith("#")
    }
    assert vals["wtpu_http_requests_total"] >= 1
    assert vals["wtpu_requests_completed_total"] >= 1
    assert vals["wtpu_requests_submitted_total"] >= vals["wtpu_requests_completed_total"]
    assert vals["wtpu_decode_rounds_total"] >= 1 and vals["wtpu_decode_round_seconds_total"] > 0
    assert vals["wtpu_windows_decoded_total"] >= vals["wtpu_decode_rounds_total"]
    assert vals["wtpu_slots"] == 2 and vals["wtpu_requests_in_flight"] == 0


def test_shutdown_resolves_inflight_requests(torch_model):
    """A request still queued at shutdown resolves with 503."""
    srv = TranscriptionHTTPServer(torch_model, "127.0.0.1", 0, slots=1, language="en")
    p = _Pending("/nonexistent", "json")
    srv._requests.put(("request", p, None))
    srv.shutdown()
    srv.serve_forever()  # returns at once, resolving the queued request
    assert p.event.is_set() and p.response[0] == 503


def test_failed_round_answers_clients_and_keeps_counters(torch_model, jfk_bytes):
    """A round that raises answers its clients with 500 and starts a new
    batcher that keeps the monotonic counters and serves on."""
    running = _Running(torch_model, slots=1, **EN)
    srv = running.srv
    try:
        assert _upload(running.url, jfk_bytes)[0] == 200
        rounds = int(srv.batcher.stats["rounds"])
        assert rounds > 0

        def boom():
            raise RuntimeError("injected decode failure")

        srv.batcher.step = boom
        status, _, resp = _upload(running.url, jfk_bytes)
        assert status == 500 and "injected decode failure" in json.loads(resp)["error"]["message"]
        assert srv._waiting == {}
        assert int(srv.batcher.stats["rounds"]) == rounds
        status, _, resp = _upload(running.url, jfk_bytes)
        assert status == 200 and json.loads(resp)["text"]
        assert int(srv.batcher.stats["rounds"]) > rounds
    finally:
        running.stop()


def test_language_aliases_accepted_against_pin(http_server, jfk_bytes):
    url, _ = http_server
    for alias in ("English", "EN", "en"):
        status, _, resp = _upload(url, jfk_bytes, {"language": alias})
        assert status == 200, (alias, resp)
        assert json.loads(resp)["text"]


@pytest.mark.parametrize("bad", [0, -3, "four", 2.0, True])
def test_max_uploads_validated(torch_model, bad):
    """max_uploads = 0 would block every POST on the semaphore for ever:
    it, negatives and non-integers fail when the server is built."""
    with pytest.raises(ValueError, match="max_uploads"):
        TranscriptionHTTPServer(torch_model, "127.0.0.1", 0, slots=1, max_uploads=bad, language="en")


def test_max_uploads_bounds_concurrent_parses(torch_model):
    srv = TranscriptionHTTPServer(torch_model, "127.0.0.1", 0, slots=1, max_uploads=2, language="en")
    try:
        assert srv._upload_sem.acquire(blocking=False) and srv._upload_sem.acquire(blocking=False)
        assert not srv._upload_sem.acquire(blocking=False)
    finally:
        srv._httpd.server_close()


def test_post_after_drain_answers_503(torch_model, jfk_bytes):
    """A POST that reaches the queue after the shutdown drain answers 503
    itself instead of waiting for ever (the queue is closed by hand here
    while the listener still runs)."""
    srv = TranscriptionHTTPServer(torch_model, "127.0.0.1", 0, slots=1, language="en")
    th = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    th.start()
    try:
        with srv._queue_lock:
            srv._queue_open = False
        status, _, resp = _upload(f"http://{srv.host}:{srv.port}", jfk_bytes)
        assert status == 503 and "shutting down" in json.loads(resp)["error"]["message"]
        assert srv._requests.empty()
    finally:
        srv._httpd.shutdown()
        srv._httpd.server_close()
        th.join(timeout=30)


# ---- live sessions ---------------------------------------------------------------


def _stream_pcm(url: str, audio, *, query="", chunk_s=2.0, encoding="f32"):
    """POST raw PCM in chunked transfer-encoding; the ndjson messages."""
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=TIMEOUT_S * 2)

    def chunks():
        step = int(chunk_s * SR)
        for i in range(0, len(audio), step):
            piece = audio[i : i + step]
            if encoding == "f32":
                yield piece.astype("<f4").tobytes()
            else:
                yield np.clip(piece * 32768.0, -32768, 32767).astype("<i2").tobytes()

    query = "&".join(p for p in (query, f"encoding={encoding}") if p)
    try:
        conn.request(
            "POST", f"/v1/audio/transcriptions/stream?{query}", body=chunks(),
            headers={"Transfer-Encoding": "chunked", "Content-Type": "audio/pcm"}, encode_chunked=True,
        )  # fmt: skip
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        return [json.loads(line) for line in resp.read().splitlines() if line.strip()]
    finally:
        conn.close()


def test_http_streaming_partials_and_finals(http_server, reference, jfk_audio):
    url, _ = http_server
    audio = np.tile(jfk_audio, 3)  # 33 s
    msgs = _stream_pcm(url, audio, query="language=en&partial_hop_s=4.0")
    done = msgs[-1]
    assert done.get("done"), done
    segs = [m["segment"] for m in msgs[:-1]]
    first_final = next(i for i, s in enumerate(segs) if not s.get("partial"))
    assert any(s.get("partial") for s in segs[:first_final]), "no partial before the first final"
    ref = reference(audio, **EN)
    assert done["text"] == ref["text"]
    finals = [s for s in segs if not s.get("partial")]
    assert [s["tokens"] for s in finals] == [s["tokens"] for s in ref["segments"]]


def test_http_streaming_s16_and_autodetect(http_server, reference, jfk_audio):
    """s16 reads as pcm / 32768; with no language the session detects on
    its first final window, as transcribe(language=None) does."""
    url, _ = http_server
    quantized = np.clip(jfk_audio * 32768.0, -32768, 32767).astype(np.int16).astype(np.float32) / 32768.0
    audio = np.tile(quantized, 3)
    msgs = _stream_pcm(url, audio, encoding="s16", chunk_s=4.0)
    done = msgs[-1]
    ref = reference(audio, temperature=0.0)
    assert done.get("done"), done
    assert done["language"] == ref["language"] and done["text"] == ref["text"]
    assert done["duration"] == pytest.approx(33.0, abs=0.1)


def test_http_streaming_bad_encoding(http_server):
    url, _ = http_server
    status, _, resp = _post(f"{url}/v1/audio/transcriptions/stream?encoding=mp3", b"x", "audio/pcm")
    assert status == 400 and b"encoding" in resp


def _raw_stream_request(url: str, headers: str, payload: bytes) -> bytes:
    """A hand-built /stream POST on a raw socket, half-closed; everything
    the server sends back."""
    u = urllib.parse.urlparse(url)
    s = socket.create_connection((u.hostname, u.port), timeout=60)
    try:
        s.sendall(
            (
                "POST /v1/audio/transcriptions/stream?encoding=s16&language=en HTTP/1.1\r\n"
                f"Host: {u.hostname}\r\n{headers}\r\n\r\n"
            ).encode()
            + payload
        )
        s.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            d = s.recv(65536)
            if not d:
                return out
            out += d
    finally:
        s.close()


def test_http_streaming_negative_chunk_rejected(http_server):
    """A negative chunk size parses as hex but is refused: it would pass
    the cap and turn the body read into a read to EOF."""
    url, _ = http_server
    out = _raw_stream_request(url, "Transfer-Encoding: chunked", b"-1\r\nXXXX\r\n0\r\n\r\n")
    assert b'"error"' in out and b"negative chunk size" in out
    assert out.rstrip().endswith(b"0")  # the terminal chunk


def test_http_streaming_short_body_is_an_error(http_server):
    """Fewer bytes than Content-Length: an error frame, not a transcript of
    truncated audio."""
    url, _ = http_server
    out = _raw_stream_request(url, "Content-Length: 64000", b"\x00" * 1000)
    assert b'"error"' in out and b"short of" in out
    assert b'"done": true' not in out


def test_http_streaming_backpressure(torch_model, reference, jfk_audio, monkeypatch):
    """With the decoder held on the session's first chunk, the handler stops
    reading once more than MAX_STREAM_PENDING_S (2 s here, four 0.5 s
    chunks) is queued: at most six chunks of the 66 wait. Released, the
    session finishes with transcribe()'s text."""
    monkeypatch.setattr(TranscriptionHTTPServer, "MAX_STREAM_PENDING_S", 2.0)
    release, held = threading.Event(), threading.Event()

    class Held(server_module.StreamingTranscriber):
        def feed(self, audio):
            held.set()
            assert release.wait(TIMEOUT_S), "never released"
            return super().feed(audio)

    monkeypatch.setattr(server_module, "StreamingTranscriber", Held)
    running = _Running(torch_model, slots=1, **EN)
    audio = np.tile(jfk_audio, 3)
    out = []
    client = threading.Thread(
        target=lambda: out.append(_stream_pcm(running.url, audio, query="language=en", chunk_s=0.5)),
        daemon=True,
    )
    try:
        client.start()
        assert held.wait(TIMEOUT_S)
        deadline = time.monotonic() + TIMEOUT_S
        while running.srv.stream_stalls == 0:
            assert time.monotonic() < deadline, "the handler never waited for the decoder"
            time.sleep(0.01)
        queued = running.srv._requests.qsize()
        assert 1 <= queued <= 6, f"{queued} chunks queued behind a held decoder"
        release.set()
        client.join(timeout=TIMEOUT_S)
    finally:
        release.set()
        running.stop()
    done = out[0][-1]
    assert done.get("done"), done
    assert done["text"] == reference(audio, **EN)["text"]


def test_shutdown_ends_live_sessions(torch_model):
    """A live session still open when the server stops gets the shutdown
    error at once, and its response ends as soon as the client stops
    sending (no wait for the stall timeout)."""
    running = _Running(torch_model, slots=1, **EN)
    srv = running.srv
    u = urllib.parse.urlparse(running.url)
    s = socket.create_connection((u.hostname, u.port), timeout=TIMEOUT_S)
    out = b""
    try:
        s.sendall(
            b"POST /v1/audio/transcriptions/stream?encoding=s16&language=en HTTP/1.1\r\n"
            b"Host: localhost\r\nTransfer-Encoding: chunked\r\n\r\n"
        )
        piece = b"\x00\x00" * (SR // 10)
        s.sendall(b"%x\r\n" % len(piece) + piece + b"\r\n")
        deadline = time.monotonic() + TIMEOUT_S
        while not any(sess.fed_samples for sess in list(srv._sessions)):
            assert time.monotonic() < deadline, "the session never opened"
            time.sleep(0.01)
        running.stop()
        while b"shutting down" not in out:
            d = s.recv(65536)
            assert d, out
            out += d
        s.shutdown(socket.SHUT_WR)
        while not out.endswith(b"0\r\n\r\n"):
            d = s.recv(65536)
            if not d:
                break
            out += d
    finally:
        s.close()
    assert b'"error"' in out and out.endswith(b"0\r\n\r\n"), out
    assert not srv._sessions
