"""Serving soak (the counterpart of tools/soak_server.py): N requests
through the port's unix-socket `TranscriptionServer` (or, with --http, the
OpenAI-compatible `TranscriptionHTTPServer`; one batcher underneath
either), with concurrent clients in waves and the process's memory sampled
after every wave.

A long-running server must stay flat per request. The record holds the
start and end RSS and a per-100-requests growth slope fitted over the
tail (the first third of the waves is left out: caches, program keys and
allocator pools grow once before steady state), whether the server and
its batcher hold no state once drained, and the requests answered with
text against the errors. On the card a leak of device memory does not
show in host RSS (the JAX tool's default CPU backend kept device buffers
in RSS), so the port also samples `torch.cuda.memory_allocated()` each
wave and reports its start, end and tail slope beside RSS.

The default model is the JAX tool's 2-layer, 128-wide synthetic model in
float32 (seeded random weights), on the card like every other; `--model
turbo` runs a registry name's dims in bf16.

  python -m whisper_tpu_torch.soak_server [requests=120] [slots=2]
         [--wave 4] [--http] [--model NAME] [--device cuda]
"""

import argparse
import json
import os
import socket
import sys
import tempfile
import threading
import time
import wave as wavmod
from typing import List, Optional

import numpy as np
import torch

from .tool_common import build_model, device_name

CLIP_SECONDS = (4.0, 9.0, 35.0)  # two 1-window clips and one 2-window clip rotate
SYNTHETIC = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=2,
)  # fmt: skip
SERVER_OPTIONS = dict(
    language="en", temperature=0.0, no_speech_threshold=None, condition_on_previous_text=False,
    sample_len=16,
)  # fmt: skip


def synthetic_model(device, seed: int = 0):
    """The JAX tool's synthetic-tiny model: float32, seeded random weights."""
    from .models.dims import ModelDimensions
    from .models.whisper import Whisper

    return Whisper(ModelDimensions(**SYNTHETIC), None, name="synthetic-tiny", device=device,
                   compute_dtype=torch.float32, seed=seed)  # fmt: skip


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


# write_wav: copied from tools/soak_server.py (framework-free)
def write_wav(path: str, seconds: float, seed: int) -> None:
    rng = np.random.RandomState(seed)
    pcm = (rng.randn(int(seconds * 16000)) * 0.05 * 32767).astype(np.int16)
    with wavmod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def request(sock_path: str, payload: dict, timeout=600.0) -> dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(timeout)
        c.connect(sock_path)
        c.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while b"\n" not in buf:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def request_http(url: str, path: str, timeout=600.0) -> dict:
    import urllib.error
    import urllib.request
    import uuid

    with open(path, "rb") as f:
        data = f.read()
    boundary = uuid.uuid4().hex
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
        f'filename="{os.path.basename(path)}"\r\n\r\n'.encode()
        + data
        + f"\r\n--{boundary}--\r\n".encode()
    )
    req = urllib.request.Request(
        f"{url}/v1/audio/transcriptions",
        data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def tail_slope_per_100(samples) -> Optional[float]:
    """Growth per 100 requests of a least-squares line through the last two
    thirds of (requests done, value) samples; None with fewer than 3."""
    tail = samples[len(samples) // 3 :]
    if len(tail) <= 2:
        return None
    xs = np.array([s[0] for s in tail], float)
    ys = np.array([s[1] for s in tail], float)
    return float(np.polyfit(xs, ys, 1)[0] * 100)


def state_empty(srv) -> bool:
    """The server and its batcher hold nothing for any request: no client
    waits on a ticket, no session is open, no event is queued, and the
    batcher has no stream, language, result, queued ticket or occupied slot."""
    b = srv.batcher
    return (
        not srv._waiting and not srv._sessions and srv._requests.empty()
        and not b._streams and not b._langs and not b._results and not b._queue
        and all(t is None for t in b._slot_ticket)
    )  # fmt: skip


def run(model, n_req: int = 120, slots: int = 2, wave: int = 4, http: bool = False) -> dict:
    """Serve `n_req` requests in waves of `wave` concurrent clients; the
    server is shut down and its thread joined before its state is read."""
    from .http_server import TranscriptionHTTPServer
    from .server import TranscriptionServer

    cuda = model.device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="soak_") as tmp:
        paths = []
        for i, sec in enumerate(CLIP_SECONDS):
            p = os.path.join(tmp, f"clip{i}.wav")
            write_wav(p, sec, seed=i)
            paths.append(p)

        opts = dict(SERVER_OPTIONS, slots=slots)
        if http:
            srv = TranscriptionHTTPServer(model, "127.0.0.1", 0, **opts)
            url = srv.address
        else:
            sock = os.path.join(tmp, "wtpu.sock")
            srv = TranscriptionServer(model, sock, **opts)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        if not http:
            for _ in range(200):
                try:
                    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                        s.connect(sock)
                    break
                except OSError:
                    time.sleep(0.05)

        ok = err = 0
        errors: List[str] = []
        lock = threading.Lock()

        def client(i):
            nonlocal ok, err
            path = paths[i % len(paths)]
            try:
                r = request_http(url, path) if http else request(sock, {"audio": path})
            except Exception as e:  # a failed request is the soak's count, reported below
                r = {"error": f"{type(e).__name__}: {e}"}
            with lock:
                if isinstance(r, dict) and "text" in r:
                    ok += 1
                else:
                    err += 1
                    errors.append(str(r)[:200])

        rss, dmem = [], []  # (requests done, MB)
        done = 0
        t0 = time.time()
        try:
            while done < n_req:
                n = min(wave, n_req - done)
                threads = [threading.Thread(target=client, args=(done + j,)) for j in range(n)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                if any(t.is_alive() for t in threads):
                    raise RuntimeError(f"a client of the wave after {done} requests did not finish in 600 s")
                done += n
                rss.append((done, rss_mb()))
                if cuda:
                    dmem.append((done, torch.cuda.memory_allocated(model.device) / 2**20))
                if done % (10 * wave) < wave:
                    print(f"  {done}/{n_req} requests, rss {rss[-1][1]:.1f} MB", file=sys.stderr, flush=True)
            wall = time.time() - t0
        finally:
            srv.shutdown()
            th.join(timeout=60)
        if th.is_alive():
            raise RuntimeError("the server's serve thread did not end after shutdown()")

    slope = tail_slope_per_100(rss)
    dslope = tail_slope_per_100(dmem)
    return {
        "metric": "serving_soak",
        "transport": "http" if http else "unix-socket",
        "model": model.name,
        "backend": model.device.type,
        "requests": n_req,
        "slots": slots,
        "wave": wave,
        "ok": ok,
        "errors": err,
        "error_samples": errors[:5],
        "wall_s": wall,
        "rss_start_mb": rss[0][1],
        "rss_end_mb": rss[-1][1],
        "rss_growth_tail_mb_per_100req": slope,
        "device_mem_start_mb": dmem[0][1] if dmem else None,
        "device_mem_end_mb": dmem[-1][1] if dmem else None,
        "device_mem_growth_tail_mb_per_100req": dslope,
        "state_empty_after_drain": state_empty(srv),
        "device": device_name(model.device),
    }


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of --model's
    (and of the synthetic default). Exits 1 when a request failed or the
    drained server held state."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("requests", nargs="?", type=int, default=120)
    ap.add_argument("slots", nargs="?", type=int, default=2)
    ap.add_argument("--wave", type=int, default=4, help="concurrent clients per wave")
    ap.add_argument("--http", action="store_true", help="soak the HTTP server instead of the unix socket's")
    ap.add_argument("--model", default=None,
                    help="registry name of the dims (seeded random bf16 weights); default: the "
                         "2-layer synthetic float32 model")  # fmt: skip
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = synthetic_model(args.device) if args.model is None else build_model(args.model, args.device)
    out = run(model, args.requests, args.slots, args.wave, args.http)
    print(json.dumps(out), flush=True)
    return 0 if out["errors"] == 0 and out["state_empty_after_drain"] else 1


if __name__ == "__main__":
    sys.exit(main())
