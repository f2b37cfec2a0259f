"""Run the repo's five published configurations end to end through the
port's entry points, at seeded random weights (no checkpoint can be
downloaded), and print one JSON record per configuration.

The counterpart of tools/config_matrix.py. BASELINE.json names the five:
tiny.en greedy on jfk.flac, base with language detection and the
temperature ladder, small at beam 5 / best_of 5, turbo at beam 5 with word
timestamps, large-v3 with four streams through `transcribe_batch`. A
record keeps the JAX tool's keys (config, name, ok, wall_s, segments,
n_streams, language) and adds what the decode engine recorded: the windows
decoded, its runs, steps and ms a token (host wall of its runs over their
steps), its captures and re-captures, and the card's peak memory.

Usage:
  python -m whisper_tpu_torch.config_matrix                    # full width, on the card
  python -m whisper_tpu_torch.config_matrix --configs 1,5      # a subset
  python -m whisper_tpu_torch.config_matrix --scaled --device cpu   # 2-layer stand-ins

A configuration that raises prints its `ok: false` record with the error;
the process then exits 1. Nothing falls back to another device.
"""

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

JFK = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "tests", "data", "jfk.flac")

COMPUTE_DTYPE = torch.bfloat16  # the models' compute dtype, as the JAX tool's

# config: (registry name of the dims, the record's name)
CONFIGS = {
    1: ("tiny.en", "tiny.en greedy jfk.flac"),
    2: ("base", "base langdetect + fallback"),
    3: ("small", "small beam5 best_of5"),
    4: ("turbo", "turbo beam5 word_timestamps"),
    5: ("large-v3", "large-v3 batched 4-stream"),
}


# copied from tools/config_matrix.py
def synth_speech(seconds: float, seed: int = 0, sr: int = 16000) -> np.ndarray:
    """Speech-shaped int16-representable noise (AM-modulated lowpass)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    x = rng.randn(n).astype(np.float32) * 0.15
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / sr))
    q = np.clip(x * env * 32768.0, -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32768.0


def scaled_dims(dims, n_layer=2):
    """The dims at most `n_layer` layers deep on each side, widths kept."""
    return dataclasses.replace(
        dims,
        n_audio_layer=min(dims.n_audio_layer, n_layer),
        n_text_layer=min(dims.n_text_layer, n_layer),
    )


def build(name: str, scaled: bool, device, seed: int = 0):
    """A model at `name`'s published dims (cut to 2 layers when `scaled`)
    with seeded random weights drawn on `device`, computing in
    COMPUTE_DTYPE."""
    from .models.dims import MODEL_DIMS
    from .models.whisper import Whisper

    dims = MODEL_DIMS[name]
    if scaled:
        dims = scaled_dims(dims)
    return Whisper(dims, None, name=name, device=device, compute_dtype=COMPUTE_DTYPE, seed=seed)


def transcribe_config(n: int, model, seconds: float):
    """Configuration `n`'s call on `model`: a transcribe() result, or
    transcribe_batch's list of them."""
    from .batch import transcribe_batch
    from .transcribe import transcribe

    if n == 1:
        return transcribe(model, JFK, language="en", temperature=0.0, verbose=None)
    audio = synth_speech(seconds)
    if n == 2:
        return transcribe(model, audio, language=None, verbose=None)
    if n == 3:
        # BASELINE.json's beam_size=5 / best_of=5 at the default ladder, so
        # the ladder's best_of draw runs at T > 0 (tools/config_matrix.py
        # passes temperature=0.0, which never reaches best_of)
        return transcribe(model, audio, language="en", beam_size=5, best_of=5, verbose=None)
    if n == 4:
        return transcribe(
            model, audio, language="en", beam_size=5, word_timestamps=True, temperature=0.0,
            verbose=None,
        )  # fmt: skip
    if n == 5:
        streams = [synth_speech(seconds, seed=s) for s in range(4)]
        return transcribe_batch(model, streams, language="en", beam_size=5, temperature=0.0)
    raise ValueError(f"no configuration {n}; configurations are {sorted(CONFIGS)}")


def engine_stats(runs) -> Dict:
    """What the engine's records (engine.EngineRun) of one configuration
    say: the audio windows decoded (the audios of the runs at the first
    temperature; a ladder retry decodes the same window again), runs,
    tokens a row, the host ms a token, the temperatures, captures and
    re-captures."""
    if not runs:
        return dict(windows=0, engine_runs=0)
    first = runs[0].temperature
    steps = sum(r.steps for r in runs)
    seconds = sum(r.seconds for r in runs)
    return dict(
        windows=sum(r.program[0] for r in runs if r.temperature == first),
        engine_runs=len(runs),
        steps=steps,
        decode_s=seconds,
        ms_per_token=seconds / steps * 1e3,
        temperatures=sorted({r.temperature for r in runs}),
        captures=sum(r.captures for r in runs),
        capture_s=sum(r.capture_s for r in runs),
        recaptures=sum(r.recaptures for r in runs),
    )


def run_config(n: int, device="cuda", scaled: bool = False, seconds: float = 10.0):
    """Build configuration `n`'s model, run its call, free the model.
    Returns (the record, the engine's runs). A failure is caught here only
    to give its record (`ok: false`, the error) and no runs."""
    from .engine import model_engine

    name, label = CONFIGS[n]
    record = dict(config=n, name=label, ok=False, model=name, scaled=scaled, dtype=str(COMPUTE_DTYPE)[6:])
    runs: List = []
    # no card: the build below raises, and nothing reads the card's stats
    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    model = engine = out = None
    t0 = time.perf_counter()
    try:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        model = build(name, scaled, device)
        engine = model_engine(model)
        out = transcribe_config(n, model, seconds)
        if cuda:
            torch.cuda.synchronize()
        record["ok"] = True
        runs = list(engine.history)
    except Exception as e:  # a configuration's failure is its record
        record["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc(file=sys.stderr)
    record["wall_s"] = time.perf_counter() - t0
    if record["ok"]:
        if isinstance(out, list):
            record["n_streams"] = len(out)
            record["segments"] = sum(len(r["segments"]) for r in out)
            record["segments_per_stream"] = [len(r["segments"]) for r in out]
            record["languages"] = [r["language"] for r in out]
        else:
            record["segments"] = len(out["segments"])
            record["language"] = out.get("language")
        record.update(engine_stats(runs))
    if cuda:
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        record["device"] = torch.cuda.get_device_name(torch.device(device))
    else:
        record["device"] = str(device)
    model = engine = None  # the engine holds the model: drop both before emptying the cache
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return record, runs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scaled", action="store_true", help="2-layer stand-in models (fast; the CPU)")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--seconds", type=float, default=10.0, help="audio length per stream")
    ap.add_argument("--device", default="cuda", help="the models' device (default: the card)")
    args = ap.parse_args(argv)
    wanted = sorted({int(c) for c in args.configs.split(",")})
    unknown = [n for n in wanted if n not in CONFIGS]
    if unknown:
        ap.error(f"no configuration {unknown}; configurations are {sorted(CONFIGS)}")
    failed = 0
    for n in wanted:
        record, _ = run_config(n, args.device, args.scaled, args.seconds)
        print(json.dumps(record), flush=True)
        failed += not record["ok"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
