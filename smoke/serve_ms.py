"""Where a continuous-batching round's time goes on the card, at 16 slots.

    python3 smoke/serve_ms.py [ROOT]

Imports whisper_tpu_torch from ROOT (default: this checkout) and builds its
kernels if needed. Turbo width and depth (MODEL_DIMS["turbo"]) with seeded
random bf16 weights; 16 requests of mixed lengths (8 s to 300 s) cut from
tests/data/jfk.flac tiled; greedy at temperature 0, conditioning on, the
language pinned (no detection). Each timed call has a
torch.cuda.synchronize() before and after it, on the host clock:

  * `mel_full_ms`: ops/stft.device_mel_full of each request, the mel that
    ContinuousBatcher.submit() computes on a CUDA model (median of 3);
  * `mel_parts_ms_60s`: the parts of the 60 s request's mel: pack_audio,
    the upload, the DFT basis, the log-mel on the card, the floor (median
    of 5);
  * `submit_ms`: one submit() per request (its mel and bookkeeping);
  * `window_build_rows_ms`: the window build of a round, as step() does it
    (torch.stack of device_mel_window), over the 16 streams of round 1 and
    over those left for round 3: (rows, median ms of 5);
  * `rounds`: after a warm-up round of a throwaway batcher, two batchers
    given the same requests step in lockstep for three rounds. Batcher A
    runs unprofiled: each round's wall seconds, its (rows, engine calls)
    per language group (one engine call per distinct prompt; conditioning
    gives each stream its own prompt after its first window), and the
    deltas of its stats (the phases are not synchronized, so the mel phase
    there is host time).
    Batcher B runs rounds 1 and 2 timed and round 3 under torch.profiler:
    the union of its CUDA kernels' intervals (device-busy ms), the kernels
    launched, and the device's idle share of A's wall for the same round
    (the rounds decode the same windows; the profiler's own host cost
    inflates B's wall, which is reported beside it).

Prints one JSON line with the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # fmt: skip
SR = 16000
SLOTS = 16
LENGTHS_S = [8, 11, 15, 23, 30, 37, 45, 53, 60, 75, 90, 120, 150, 180, 240, 300]


def synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def busy_ms(prof):
    """The union of the CUDA kernels' intervals, and their count."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    return busy / 1e3, len(spans)


def main():
    if not torch.cuda.is_available():
        sys.exit("serve_ms: CUDA is not available")
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import ContinuousBatcher, batch, load_audio
    from whisper_tpu_torch.kernels import build
    from whisper_tpu_torch.models.dims import MODEL_DIMS
    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.ops import stft
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.load_library()
    model = Whisper(MODEL_DIMS["turbo"], None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    n_mels = model.dims.n_mels
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    tiled = np.tile(jfk, -(-(max(LENGTHS_S) + 40) * SR // len(jfk)))
    # each request starts elsewhere in the tiling, so the streams differ
    audios = [np.ascontiguousarray(tiled[i * 7 * SR // 3 :][: n * SR]) for i, n in enumerate(LENGTHS_S)]
    out = {"root": ROOT, "slots": SLOTS, "lengths_s": LENGTHS_S}

    device_mel_full(audios[0], n_mels, dev)  # warm-up
    out["mel_full_ms"] = [
        statistics.median(synced_s(lambda: device_mel_full(a, n_mels, dev))[0] for _ in range(3)) * 1e3
        for a in audios
    ]

    # the parts of one request's mel (the 60 s request), each synchronized
    a60 = audios[LENGTHS_S.index(60)]
    bucket = -(-(len(a60) + 30 * SR) // (30 * SR)) * 30 * SR
    packed = stft.pack_audio(a60, bucket)
    on_card = torch.from_numpy(packed).to(dev)
    raw = stft.log_mel_raw_torch(on_card, n_mels)
    parts = dict(
        pack_audio=lambda: stft.pack_audio(a60, bucket),
        upload=lambda: torch.from_numpy(packed).to(dev),
        dft_basis=lambda: stft._dft_basis(dev),
        log_mel_raw_torch=lambda: stft.log_mel_raw_torch(on_card, n_mels),
        normalize=lambda: stft.normalize_log_mel_torch(raw, raw.amax()),
    )  # fmt: skip
    out["mel_parts_ms_60s"] = {
        name: statistics.median(synced_s(fn)[0] for _ in range(5)) * 1e3 for name, fn in parts.items()
    }

    cb = ContinuousBatcher(model, slots=SLOTS, language="en", temperature=0.0)
    submit_ms = []
    for a in audios:
        seconds, _ = synced_s(lambda: cb.submit(a))
        submit_ms.append(seconds * 1e3)
    out["submit_ms"] = submit_ms

    def window_build_ms(cb):
        """(rows, median ms) of the build over the streams not done."""
        streams = [s for s in cb._streams.values() if not s.done]
        sizes = [s.window_frames for s in streams]

        def build_windows():
            return torch.stack([device_mel_window(s.device_mel, s.seek, n) for s, n in zip(streams, sizes)])

        build_windows()
        return len(streams), statistics.median(synced_s(build_windows)[0] * 1e3 for _ in range(5))

    out["window_build_rows_ms"] = {"round_1": window_build_ms(cb)}

    warm = ContinuousBatcher(model, slots=SLOTS, language="en", temperature=0.0)
    for a in audios:
        warm.submit(a)
    warm.step()
    del warm

    twin = ContinuousBatcher(model, slots=SLOTS, language="en", temperature=0.0)
    for a in audios:
        twin.submit(a)
    calls = []
    run = batch._decode_window_batch

    def watched(model_, mels, prompts, *args):
        calls.append((len(prompts), len({tuple(p) for p in prompts})))
        return run(model_, mels, prompts, *args)

    batch._decode_window_batch = watched
    keys = ("windows_decoded", "mel_seconds_sum", "decode_seconds_sum", "apply_seconds_sum")
    rounds = []
    try:
        for k in range(3):
            if k == 2:
                out["window_build_rows_ms"]["round_3"] = window_build_ms(cb)
            before = dict(cb.stats)
            calls.clear()
            seconds, _ = synced_s(cb.step)
            rnd = dict(wall_s=seconds, rows_and_engine_calls=list(calls))
            rnd.update({key: cb.stats[key] - before[key] for key in keys})
            if k < 2:
                rnd["twin_wall_s"] = synced_s(twin.step)[0]
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    twin.step()
                    torch.cuda.synchronize()
                    profiled = time.perf_counter() - t0
                busy, n_kernels = busy_ms(prof)
                rnd["twin_profiled"] = dict(
                    wall_ms=profiled * 1e3, device_busy_ms=busy, kernels=n_kernels,
                    device_idle_share_of_unprofiled_wall=1 - busy / (seconds * 1e3),
                )  # fmt: skip
            rounds.append(rnd)
    finally:
        batch._decode_window_batch = run
    out["rounds"] = rounds
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(json.dumps({"phase": "serve_ms", **out}), flush=True)


if __name__ == "__main__":
    main()
