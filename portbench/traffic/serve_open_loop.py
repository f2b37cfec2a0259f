"""Open-loop serving: requests arrive on a fixed schedule into the
program's `ContinuousBatcher`, driven as its serve loop drives it
(server.BatcherServer): before each round, submit every request whose
arrival is due, then `step()`.

Mix parameters: `slots`, `rate_per_s` (the offered load, fixed in the mix),
request lengths log-normal (`median_seconds`, `sigma`) clipped to
[`min_seconds`, `max_seconds`], `beam_size` (null: greedy), `sample_len`,
`check_windows`.

Every seed offers the same work: round(rate * seconds) requests, whose
lengths are the log-normal's stratified quantiles and whose gaps are the
exponential's (Poisson arrivals), each in an order drawn from the mix's
`schedule_seed`, so that one schedule serves every run; the gaps are
scaled to fill the window exactly. The run's seed draws the weights and
each request's samples (a slice of one babble buffer at a drawn offset).

latency: from a request's scheduled arrival to its result being ready (the
end of the round that finished it). After the window no request arrives;
those in flight are drained and counted. A request that fails counts as
missing (an infinite latency).
"""

import statistics
import time

import numpy as np

from portbench import inputs
from portbench.work import clock, expected_seeks, stratified, sync, windows_of


def schedule(mix: dict, seconds: float, rng: np.random.Generator):
    """(arrival seconds, length seconds) of the requests of a window."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf(q) for q in stratified(n, rng)])
    lengths = np.clip(mix["median_seconds"] * np.exp(mix["sigma"] * z), mix["min_seconds"], mix["max_seconds"])
    gaps = -np.log1p(-stratified(n, rng))
    gaps *= seconds / gaps.sum()
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return arrivals, lengths


def requests(mix: dict, seconds: float, rng: np.random.Generator, base: np.ndarray):
    """(arrivals, audios) of a window: the mix's schedule, each request a
    slice of `base` at an offset drawn from rng."""
    arrivals, lengths = schedule(mix, seconds, np.random.default_rng(mix["schedule_seed"]))
    offsets = rng.integers(0, len(base) // 2, size=len(lengths))
    n = np.round(lengths * inputs.SAMPLE_RATE).astype(np.int64)
    return arrivals, [base[o : o + k] for o, k in zip(offsets, n)]


def prepare(ctx):
    rng = np.random.default_rng(ctx.seed)
    mix = ctx.mix
    ctx.base = inputs.synth_audio(mix["max_seconds"] * 2, rng, inputs.syllables(rng))
    ctx.arrivals, ctx.audios = requests(mix, ctx.seconds, rng, ctx.base)
    lengths = [len(a) for a in ctx.audios]
    ctx.longest = {int(np.argmax(lengths))}
    ctx.expected = {i: expected_seeks(n) for i, n in enumerate(lengths)}
    # the warm-up's requests: one a slot, the k-th of k windows, so that the
    # rounds pass through every occupancy from full to one and the engine
    # holds the loop of each before the window
    warm = [(k * 30 - 15) * inputs.SAMPLE_RATE for k in range(1, mix["slots"] + 1)]
    ctx.warm_audios = [np.resize(ctx.base, n) for n in warm]


def _batcher(ctx):
    from whisper_tpu_torch.continuous import ContinuousBatcher

    return ContinuousBatcher(ctx.model, slots=ctx.mix["slots"], **ctx.decode_kwargs)


def warm(ctx):
    """One drain of one request a slot, of 1 to `slots` windows."""
    cb = _batcher(ctx)
    for a in ctx.warm_audios:
        cb.submit(a)
    cb.drain()
    sync(ctx.device)


def run_schedule(ctx, arrivals, audios):
    """Serve `audios` arriving at `arrivals` (seconds from now) and drain.
    Returns the record."""
    cb = _batcher(ctx)
    n = len(arrivals)
    latency = [float("inf")] * n
    submit_s, late_s, served, backlog = [], [], [], []
    inflight = {}
    failed = 0
    i = 0
    t0 = clock()
    while True:
        now = clock() - t0
        while i < n and arrivals[i] <= now:
            t_sub = clock()
            late_s.append(t_sub - t0 - arrivals[i])
            try:
                inflight[cb.submit(audios[i])] = i
            except Exception as e:  # a refused request is a failure, not a crash
                print(f"request {i} failed at submit: {e!r}", flush=True)
                failed += 1
            submit_s.append(clock() - t_sub)
            i += 1
            now = clock() - t0
        if cb.pending():
            cb.step()
            done_at = clock() - t0
            for ticket in [t for t in inflight if cb.ready(t)]:
                k = inflight.pop(ticket)
                latency[k] = done_at - arrivals[k]
                served += windows_of(cb.pop(ticket), k, len(audios[k]))
            backlog.append((done_at, len(inflight)))
        elif i < n:
            time.sleep(max(0.0, arrivals[i] - (clock() - t0)))
        else:
            break
    sync(ctx.device)
    elapsed = clock() - t0
    return dict(
        latency=latency, submit_s=submit_s, late_s=late_s, served=served, failed=failed,
        elapsed=elapsed, stats=dict(cb.stats), backlog=backlog,
    )  # fmt: skip


def window(ctx, seconds):
    rec = run_schedule(ctx, ctx.arrivals, ctx.audios)
    lat = sorted(rec["latency"])
    q = lambda p: lat[min(len(lat) - 1, int(np.ceil(p * len(lat))) - 1)]  # noqa: E731  nearest rank
    done = int(np.isfinite(lat).sum())
    return dict(
        metrics={"latency_p95_s": q(0.95), "latency_p50_s": q(0.50)},
        elapsed=rec["elapsed"],
        attempted=len(lat),
        failed=len(lat) - done,
        served=rec["served"],
        times={k: 1 for k in range(len(lat)) if np.isfinite(rec["latency"][k])},
        windows=len(rec["served"]),
        calls=done,
        submit_s=rec["submit_s"],
        late_s=rec["late_s"],
        stats=rec["stats"],
    )


def profiled(ctx):
    """The traced slice: the first `profile_seconds` of the schedule at the
    mix's rate, drained."""
    k = int(np.searchsorted(ctx.arrivals, ctx.mix["profile_seconds"]))
    run_schedule(ctx, ctx.arrivals[:k], ctx.audios[:k])
