"""Continuous-batching serving bench (the counterpart of
tools/continuous_bench.py): N requests of mixed lengths drain through a
fixed-slot `ContinuousBatcher` on the card.

It measures the scheduler's value, window-granular slot reuse, not model
quality: the weights are random, so decoding is pinned deterministic
(greedy T = 0, no ladder, no conditioning, no-speech gate off, 64 tokens a
window). The batcher is warmed on the workload's distinct clip lengths,
then two timed passes submit the whole request set and drain it (the
first may still pay first uses; the second is the scheduler's number).
Each pass reports makespan, aggregate RTFx, mean and p95 completion
latency, the submit overhead and the batcher's phase sums; the port adds
what the engine's runs recorded in each pass and over the whole run:
captures, re-captures (graphs made again after their buffers were dropped
past engine.MAX_PROGRAMS) and the distinct program keys.

  python -m whisper_tpu_torch.continuous_bench [slots=4] [n_requests=8]
         [--model turbo] [--device cuda]

Left out of the JAX tool: its hedged workers (CONT_HEDGE, CONT_WORKER_OUT,
CONT_GO_FILE), the cold switch (CONT_COLD) and the resident-daemon probe
(try_daemon). They race processes against a remote TPU service replica's
first-execute cost, which a card attached to its host does not have; a
process here measures the card it runs on.
"""

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from .tool_common import build_model, device_name, engine_counts


def prepare_batcher(model, slots, lengths_s, rng):
    """A ContinuousBatcher under the JAX tool's options, warmed by draining
    one request per slot whose lengths cycle the workload's distinct
    lengths (the clips drawn from `rng`, as the JAX tool draws them).
    Returns (batcher, warm_s)."""
    from .continuous import ContinuousBatcher

    cb = ContinuousBatcher(
        model,
        slots=slots,
        language="en",
        temperature=0.0,
        no_speech_threshold=None,
        condition_on_previous_text=False,
        sample_len=64,
    )
    t_w = time.perf_counter()
    warm_lengths = sorted(set(lengths_s))
    for i in range(slots):
        sec = warm_lengths[i % len(warm_lengths)]
        cb.submit((rng.randn(sec * 16000) * 0.1).astype(np.float32))
    cb.drain()
    return cb, time.perf_counter() - t_w


# workload: copied from tools/continuous_bench.py (framework-free)
def workload(n_req, seed=0):
    rng = np.random.RandomState(seed)
    lengths_s = [30 if i % 2 else 60 for i in range(n_req)]
    audios = [(rng.randn(sec * 16000) * 0.1).astype(np.float32) for sec in lengths_s]
    return rng, lengths_s, audios


def run_serving_bench(model, slots: int, n_req: int) -> dict:
    """Warm the batcher, then two timed passes of the whole request set.
    Returns the record, with each ticket's result of the second pass under
    "results" (not printed)."""
    from .engine import model_engine

    engine = model_engine(model, model.decode_weights)
    engine.history.clear()
    rng, lengths_s, audios = workload(n_req)
    cb, warm_s = prepare_batcher(model, slots, lengths_s, rng)
    all_runs = list(engine.history)

    def run_pass():
        """Submit the full request set and drain it; returns its stats and
        each ticket's result."""
        engine.history.clear()
        stats0 = dict(cb.stats)
        t_submit = time.perf_counter()
        tickets = [cb.submit(a) for a in audios]
        done_at = {}
        t0 = time.perf_counter()
        rounds = 0
        while cb.step():
            rounds += 1
            now = time.perf_counter() - t0
            for t in tickets:
                if cb.ready(t) and t not in done_at:
                    done_at[t] = now
        makespan = time.perf_counter() - t0
        results = [cb.pop(t) for t in tickets]
        runs = list(engine.history)
        all_runs.extend(runs)
        lats = sorted(done_at.values())
        return dict(
            rounds=rounds,
            makespan_s=makespan,
            aggregate_rtfx=sum(lengths_s) / max(makespan, 1e-9),
            latency_mean_s=float(np.mean(lats)),
            latency_p95_s=float(np.percentile(lats, 95)),
            submit_overhead_s=t0 - t_submit,
            # where the rounds' wall time went (batcher phase accumulators)
            phases_s={
                k.replace("_seconds_sum", ""): cb.stats[k] - stats0[k]
                for k in ("mel_seconds_sum", "decode_seconds_sum", "apply_seconds_sum")
            },
            **engine_counts(runs),
        ), results

    first, _ = run_pass()
    warm, results = run_pass()
    total = engine_counts(all_runs)
    return {
        "model": model.name,
        "slots": slots,
        "requests": n_req,
        "audio_seconds": sum(lengths_s),
        **first,
        "warm_pass": warm,
        "warmup_s": warm_s,
        "captures_total": total["captures"],
        "recaptures_total": total["recaptures"],
        "program_keys_total": total["program_keys"],
        "device": device_name(model.device),
        "results": results,
    }


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of --model's."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("slots", nargs="?", type=int, default=4)
    ap.add_argument("n_requests", nargs="?", type=int, default=8)
    ap.add_argument("--model", default="turbo", help="registry name of the dims (seeded random bf16 weights)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = build_model(args.model, args.device)
    out = run_serving_bench(model, args.slots, args.n_requests)
    out.pop("results")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
