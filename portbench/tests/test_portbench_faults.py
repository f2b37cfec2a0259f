"""The comparison fails a run whose timed path is broken underneath: each
fault the cells can have, planted in the program at tiny dims on the CPU,
turns `correct` false. (The cells run on one card and train nothing: no
exchange between chips, no training step to leave unchanged.)"""

import os
import time

import pytest

from portbench import harness, spec

DATA = os.path.join(spec.HERE, "tests", "data")


def _run(cell, bench, seconds=0.5):
    result, numbers = harness.run(cell, 31, seconds, False, t_start=time.perf_counter(), device="cpu", data=DATA, bench=bench)
    return result, numbers


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.serve"])
def test_altered_token(cell, bench_for_tiny, monkeypatch):
    """A token altered where it is produced: the engine's output."""
    from whisper_tpu_torch import engine

    run = engine.FusedEngine.run

    def altered(self, initial_tokens, *args, **kwargs):
        out = run(self, initial_tokens, *args, **kwargs)
        tokens = out[0].copy()
        tokens[:, len(initial_tokens[0]) + 3] = (tokens[:, len(initial_tokens[0]) + 3] + 1234) % 50000
        return (tokens, *out[1:])

    monkeypatch.setattr(engine.FusedEngine, "run", altered)
    result, numbers = _run(cell, bench_for_tiny)
    assert not result["correct"]
    assert numbers["token_gap"] > 1.0


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.serve"])
def test_half_batch_left_out(cell, bench_for_tiny, monkeypatch):
    """Half of a round's windows left out: the first half decoded, its
    results standing in for the rest."""
    from whisper_tpu_torch import batch

    decode = batch._decode_window_batch

    def half(model, mels, prompts, *args, **kwargs):
        n = len(prompts)
        keep = max(1, n // 2)
        out = decode(model, mels[:keep], prompts[:keep], *args, **kwargs)
        return [out[i % keep] for i in range(n)]

    monkeypatch.setattr(batch, "_decode_window_batch", half)
    result, numbers = _run(cell, bench_for_tiny, seconds=3.0)
    assert not result["correct"]


def _with_kind(cell, kind):
    cell.__dict__["kind"] = kind  # the cached traffic module, patched
    return cell


def test_window_dropped(bench_for_tiny, monkeypatch):
    """A window that never comes: bad_windows counts it."""
    from portbench import spec

    kind = spec.cell("tiny.batch", DATA).kind
    windows_of = kind.windows_of
    monkeypatch.setattr(kind, "windows_of", lambda *a: windows_of(*a)[:-1])
    monkeypatch.setattr(spec, "cell", lambda *a, _cell=spec.cell: _with_kind(_cell(*a), kind))
    result, numbers = _run("tiny.batch", bench_for_tiny)
    assert not result["correct"] and numbers["bad_windows"] > 0
