"""The per-layer split of transcribe() on the card, through profiling.py.

    python3 smoke/layers_ms.py [ROOT]

Imports whisper_tpu_torch from ROOT (default: this checkout; give another
checkout to compare two versions of the port on one card) and builds its
kernels if needed. Run it in a process that has run no profiler session: a
session slows the host's later dispatch. At turbo width with seeded random
bf16 weights, on a 60 s clip (tests/data/jfk.flac tiled), transcribe() at
temperature 0, greedy and beam 5:

  * `cold`: profiling.summary() of the process's first greedy run with
    set_sync(True): each span's first call holds the warm-up of first use;
  * `greedy`, `beam5`: with set_sync(True), after a reset, the summary per
    span (first s, steady calls, mean ms); per window the engine's run
    (FusedEngine.history: its steps and wall, which is the "fused_decode"
    span's: the prefill, the steps and the final host read) and its ms a
    step; the "encoder" span (encoder and cross-K/V) of the first window
    (first_call_s after the reset) and of the others (the steady mean);
    `host_rest_ms`, transcribe()'s wall less all its spans (its log-mel,
    the decoding tasks' host work, window slices and segments) and, apart,
    the log-mel of the clip (`mel_ms`: device_mel_full, synchronized, the
    median of 5 calls; the JAX package has no mel span);
  * `timing_cost`: the engine's wall ms per token of each window of the
    greedy runs again, with sync off and with profiling.enabled = False,
    three runs each in the order off, disabled, disabled, off, off,
    disabled (beam 5 is left out of this part to keep the smoke's time);
  * `trace`: profiling.trace() of one greedy window of decode(), cut to 48
    steps (sample_len): the Chrome trace's CUDA kernel events, of which the
    greedy update kernel's.

Any failed check raises. Prints one JSON line with the card's name and
power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # fmt: skip


def main():
    if not torch.cuda.is_available():
        sys.exit("layers_ms: CUDA is not available")
    sys.path.insert(0, ROOT)
    from whisper_tpu_torch import DecodingOptions, decode, load_audio, profiling
    from whisper_tpu_torch.engine import model_engine
    from whisper_tpu_torch.kernels import build
    from whisper_tpu_torch.models.dims import MODEL_DIMS
    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.load_library()
    model = Whisper(MODEL_DIMS["turbo"], None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    audio = np.tile(jfk, 6)[: 60 * 16000]
    out = {"root": ROOT}

    def transcribe(beam_size):
        """transcribe()'s wall s and the engine's history entries of its
        windows: (beam_search, temperature, steps, wall s)."""
        engine = model_engine(model)
        first = len(engine.history)
        t0 = time.perf_counter()
        res = model.transcribe(audio, language="en", temperature=0.0, beam_size=beam_size, verbose=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not res["segments"] or not all(np.isfinite(s["avg_logprob"]) for s in res["segments"]):
            raise AssertionError(f"transcribe() gave no finite segments: {str(res)[:300]}")
        return wall, list(engine.history)[first:]

    def mel_ms():
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            device_mel_full(audio, model.dims.n_mels, dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def summary():
        return {name: dict(first_s=s["first_call_s"], calls=s["steady_calls"], mean_ms=s["steady_mean_ms"])
                for name, s in profiling.summary().items()}  # fmt: skip

    profiling.set_sync(True)
    profiling.reset()
    transcribe(None)
    out["cold"] = summary()
    for label, beam_size in (("greedy", None), ("beam5", 5)):
        profiling.reset()
        wall, runs = transcribe(beam_size)
        spans = profiling.summary()
        for name in ("encoder", "fused_decode"):
            if name not in spans or spans[name]["steady_calls"] + 1 != len(runs):
                raise AssertionError(f"{label}: {len(runs)} windows, spans {spans}")
        enc = spans["encoder"]
        out[label] = dict(
            summary=summary(), wall_ms=wall * 1e3, mel_ms=mel_ms(),
            windows=[dict(steps=r[2], fused_decode_ms=r[3] * 1e3, ms_per_step=r[3] * 1e3 / r[2])
                     for r in runs],
            encoder_first_ms=enc["first_call_s"] * 1e3, encoder_mean_ms=enc["steady_mean_ms"],
            host_rest_ms=1e3 * (wall - sum(s["first_call_s"] + s["steady_total_s"] for s in spans.values())),
        )  # fmt: skip

    # what timing costs the loop: the engine's wall ms per token, sync off,
    # with profiling on and off
    profiling.set_sync(False)
    cost = {"sync_off": [], "disabled": []}
    for mode in ("sync_off", "disabled", "disabled", "sync_off", "sync_off", "disabled"):
        profiling.enabled = mode == "sync_off"
        _, runs = transcribe(None)
        cost[mode] += [r[3] * 1e3 / r[2] for r in runs]
    profiling.enabled = True
    out["timing_cost"] = dict(cost, **{f"{m}_median": statistics.median(v) for m, v in cost.items()})

    # one traced window
    mel, _ = device_mel_full(audio, model.dims.n_mels, dev)
    window = device_mel_window(mel, 0, 3000)
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=48)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            decode(model, window, opts)
            torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        with open(path) as f:
            trace_events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in trace_events if e.get("cat") == "kernel"]
        update = sum("greedy_argmax_kernel" in k for k in kernels)
        out["trace"] = dict(bytes=os.path.getsize(path), kernel_events=len(kernels), update_kernel_events=update,
                            steps=model_engine(model).history[-1][2])  # fmt: skip
    if not kernels or update == 0:
        raise AssertionError(f"the trace holds {len(kernels)} kernel events, {update} of the update kernel")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(json.dumps({"phase": "layers", **out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
