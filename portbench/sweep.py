"""The knee of a serving cell: its traffic at a list of offered rates, one
process a seed (weights, audio and the arrivals drawn from it). For each
rate: the latencies, and the backlog (requests submitted and not finished)
over the window. A rate is flat where the backlog's mean in the window's
last quarter is at most one request above its mean in the second quarter.
The knee is the highest rate that is flat on every seed; the last line
gives it, with four fifths of it, the rate the
cell's file then fixes. The benchmark's runs never search for one.

    python3 portbench/sweep.py --workload turbo.serve8.greedy --seconds 20 \
        --seeds 17 18 --rates 10 12 14 16 18 20
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402


def quarter_mean(backlog, seconds, lo, hi):
    vals = [n for t, n in backlog if lo * seconds <= t < hi * seconds]
    return float(np.mean(vals)) if vals else float("nan")


def sweep_rate(ctx, seed: int, rate: float, seconds: float) -> dict:
    kind = ctx.kind
    ctx.mix = dict(ctx.mix, rate_per_s=rate, schedule_seed=seed + int(rate * 1000))
    rng = np.random.default_rng([seed, int(rate * 1000)])
    arrivals, audios = kind.requests(ctx.mix, seconds, rng, ctx.base)
    rec = kind.run_schedule(ctx, arrivals, audios)
    lat = np.array(rec["latency"])
    row = {
        "seed": seed,
        "rate_per_s": rate,
        "requests": len(lat),
        "failed": int((~np.isfinite(lat)).sum()),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "backlog_q2": quarter_mean(rec["backlog"], seconds, 0.25, 0.5),
        "backlog_q4": quarter_mean(rec["backlog"], seconds, 0.75, 1.0),
        "drain_s": rec["elapsed"] - seconds,
        "rounds": rec["stats"]["rounds"],
        "occupancy_pct": 100.0 * rec["stats"]["windows_decoded"] / max(1, rec["stats"]["rounds"] * ctx.mix["slots"]),
        "submit_ms_mean": 1000.0 * float(np.mean(rec["submit_s"])),
        "generator_late_max_s": max(rec["late_s"]),
    }
    row["flat"] = bool(row["backlog_q4"] <= row["backlog_q2"] + 1.0)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    flat = {rate: True for rate in args.rates}
    for seed in args.seeds:
        ctx = harness.setup(args.workload, seed, args.seconds, args.device)
        for rate in args.rates:
            row = sweep_rate(ctx, seed, rate, args.seconds)
            flat[rate] = flat[rate] and row["flat"]
            print(json.dumps(row), flush=True)
        harness.free_program(ctx)
    knee = max((rate for rate in args.rates if flat[rate]), default=None)
    print(json.dumps({"seeds": args.seeds, "knee_per_s": knee, "rate_per_s": None if knee is None else round(0.8 * knee, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
