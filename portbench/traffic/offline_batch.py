"""Offline batch traffic: `transcribe_batch` on a fixed set of streams,
closed loop, call after call on the same streams.

Mix parameters: `stream_seconds` (one length per stream), `beam_size`
(null: greedy), `sample_len`, `check_windows` (windows the comparison
samples). The seed draws each stream's samples; the lengths, and so the
work, are the mix's.

rtfx: the audio seconds of every call the window started, over the time
from the window's start to the end of the last such call (calls start
while the clock is under --seconds; the last runs to its end).
"""

import numpy as np

from portbench import inputs
from portbench.work import clock, expected_seeks, sync, windows_of


def prepare(ctx):
    rng = np.random.default_rng(ctx.seed)
    pool = inputs.syllables(rng)
    ctx.audios = [inputs.synth_audio(s, rng, pool) for s in ctx.mix["stream_seconds"]]
    longest = int(np.argmax([len(a) for a in ctx.audios]))
    ctx.longest = {longest}
    ctx.expected = {i: expected_seeks(len(a)) for i, a in enumerate(ctx.audios)}


def _call(ctx, audios):
    from whisper_tpu_torch.batch import transcribe_batch

    return transcribe_batch(ctx.model, audios, **ctx.decode_kwargs)


def warm(ctx):
    """One whole call: every round's shapes, the loop's captures."""
    _call(ctx, ctx.audios)
    sync(ctx.device)


def window(ctx, seconds):
    """Calls while the clock is under `seconds`, at least one."""
    served, calls = [], 0
    t0 = clock()
    while calls == 0 or clock() - t0 < seconds:
        results = _call(ctx, ctx.audios)
        calls += 1
        for i, (r, a) in enumerate(zip(results, ctx.audios)):
            served += windows_of(r, i, len(a))
    sync(ctx.device)
    elapsed = clock() - t0
    audio_s = calls * sum(len(a) for a in ctx.audios) / inputs.SAMPLE_RATE
    return dict(
        metrics={"rtfx": audio_s / elapsed},
        elapsed=elapsed,
        attempted=calls * len(ctx.audios),
        failed=0,
        served=served,
        times={i: calls for i in range(len(ctx.audios))},
        windows=len(served),
        calls=calls,
    )


def profiled(ctx):
    """The traced slice: one round at full occupancy (every stream's first
    window, one call), the steady core of a call."""
    _call(ctx, [a[: inputs.N_SAMPLES] for a in ctx.audios])
    sync(ctx.device)
