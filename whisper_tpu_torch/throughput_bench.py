"""Multi-stream throughput on one card (the counterpart of
tools/throughput_bench.py): N independent synthetic streams transcribed
concurrently through `batch.transcribe_batch` (lockstep windows, one
batched encode and one engine run per round), aggregate real-time factor.

The decode is pinned deterministic as in the JAX tool: T = 0, no
conditioning on previous text, every quality gate off, English, beam 5
unless --greedy. One warm call (it captures the loop's graphs), then
--trials timed calls; the value is the median's aggregate RTFx. Besides the
JAX tool's keys the record holds what the engine's runs of the timed calls
recorded (captures, re-captures, distinct program keys), the card's peak
memory over the whole run and the device.

  python -m whisper_tpu_torch.throughput_bench [--model large-v3] [--streams 8]
         [--seconds 60] [--greedy] [--trials 3] [--device cuda]

The model has seeded random bf16 weights at the registry name's dims.
"""

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .tool_common import build_model, device_name, engine_counts, synchronize


# synth_audio: copied from tools/throughput_bench.py (framework-free)
def synth_audio(seconds: int, seed: int, sr: int = 16000) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = seconds * sr
    x = rng.randn(n).astype(np.float32) * 0.2
    env = 0.5 * (1 + np.sin(2 * np.pi * (2.0 + seed * 0.3) * np.arange(n) / sr))
    return (x * env).astype(np.float32)


def decode_kwargs(greedy: bool) -> dict:
    """The JAX tool's transcribe_batch keywords."""
    kw = dict(
        language="en",
        temperature=0.0,
        condition_on_previous_text=False,  # streams stay batched (no prompt divergence)
        no_speech_threshold=None,  # deterministic workload with random weights
        logprob_threshold=None,
        compression_ratio_threshold=None,
    )
    if not greedy:
        kw["beam_size"] = 5
    return kw


def run(model, streams: int = 8, seconds: int = 60, greedy: bool = False, trials: int = 3) -> dict:
    """The measurement: returns the record, with each stream's transcript
    of the last timed call under "results" (not printed)."""
    from .batch import transcribe_batch
    from .engine import model_engine

    device = model.device
    cuda = device.type == "cuda"
    audios = [synth_audio(seconds, seed=i) for i in range(streams)]
    kwargs = decode_kwargs(greedy)
    engine = model_engine(model, model.decode_weights)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    synchronize(device)
    t0 = time.perf_counter()
    transcribe_batch(model, audios, **kwargs)
    synchronize(device)
    warm = time.perf_counter() - t0

    engine.history.clear()
    times: List[float] = []
    for _ in range(trials):
        t0 = time.perf_counter()
        results = transcribe_batch(model, audios, **kwargs)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    return {
        "metric": f"throughput_{model.name}_{streams}streams" + ("_greedy" if greedy else "_bs5"),
        "value": streams * seconds / p50,
        "unit": "aggregate_x_realtime_per_chip",
        "p50_batch_latency_s": p50,
        "batch_latency_s": times,
        "warmup_s": warm,
        "streams": streams,
        **engine_counts(list(engine.history)),
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": device_name(device),
        "results": results,
    }


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of --model's."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--seconds", type=int, default=60)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = build_model(args.model, args.device)
    out = run(model, args.streams, args.seconds, args.greedy, args.trials)
    out.pop("results")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
