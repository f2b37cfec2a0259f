"""The temperature ladder at the multilingual pre-v3 layout (V = 51865, 80
mels) on a 33 s clip (two windows), the port against the JAX package on
one synthetic checkpoint in float32: language detection with the default
ladder (configuration 2 of whisper_tpu_torch.config_matrix) here, and
beam_size=5 / best_of=5 with the ladder (configuration 3: beam search at
T = 0, best_of draws at T > 0) in test_torch_configs_bestof.py, which
shares this file's checks.

Random weights fail the quality gates, so every window runs the whole
ladder. The host loops of both packages draw from numpy's global stream,
so with the same seed the whole transcripts are equal, every attempt
included. The port's engine draws with its own generator: there the
first window's T = 0 attempt and the detected language are held against
the JAX package's, and the T > 0 attempts must have run on the engine."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu_torch import decoding, engine

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

LADDER = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
# each attempt decodes at most 40 tokens a row: random weights never emit
# EOT early, and at 224 the file's 24 attempts would take minutes
SAMPLE_LEN = 40


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def clip(jfk_audio):
    return np.tile(jfk_audio, 3)  # 33 s: two windows


def _attempts(module, monkeypatch):
    """Record every DecodingTask.run of `module` (its results) in a list."""
    seen = []
    run = module.DecodingTask.run

    def watched(self, mel):
        out = run(self, mel)
        seen.append((self.options.temperature, out))
        return out

    monkeypatch.setattr(module.DecodingTask, "run", watched)
    return seen


def _tokens(results):
    return [r.tokens for r in results]


def check_host_loops(tpu_model, torch_model, clip, kw, monkeypatch):
    """Both packages' host loops, seeded alike: every attempt and the
    transcript are equal."""
    monkeypatch.setattr(torch_model, "use_fused_decode", False)
    monkeypatch.setattr(tpu_model, "use_fused_decode", False, raising=False)
    mine_runs = _attempts(decoding, monkeypatch)
    ref_runs = _attempts(whisper_tpu.decoding, monkeypatch)
    np.random.seed(0)
    ref = tpu_model.transcribe(clip, verbose=None, **kw)
    np.random.seed(0)
    mine = torch_model.transcribe(clip, verbose=None, **kw)
    # the whole ladder ran, attempt for attempt
    assert [t for t, _ in mine_runs] == [t for t, _ in ref_runs]
    assert {t for t, _ in mine_runs} == set(LADDER)
    for (_, m), (_, r) in zip(mine_runs, ref_runs):
        assert _tokens(m) == _tokens(r)
    assert mine["language"] == ref["language"]
    assert mine["text"] == ref["text"]
    assert len(mine["segments"]) == len(ref["segments"]) > 0
    for m, r in zip(mine["segments"], ref["segments"]):
        assert m["tokens"] == r["tokens"]
        for key in ("id", "seek", "temperature", "text"):
            assert m[key] == r[key], key
        for key in ("start", "end"):
            assert abs(m[key] - r[key]) <= 1e-6, key
        for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
            assert abs(m[key] - r[key]) < 1e-4, key


def check_engine(tpu_model, torch_model, clip, kw, monkeypatch):
    """The port's engine: the language and the first window's T = 0
    attempt are the JAX engine's; every attempt ran on the loop body."""
    monkeypatch.setattr(tpu_model, "use_fused_decode", True, raising=False)
    mine_runs = _attempts(decoding, monkeypatch)
    ref_runs = _attempts(whisper_tpu.decoding, monkeypatch)
    ref = tpu_model.transcribe(clip, temperature=0.0, verbose=None, **kw)
    history = engine.model_engine(torch_model).history
    history.clear()
    mine = torch_model.transcribe(clip, verbose=None, **kw)
    assert mine["language"] == ref["language"]
    # the first window's T = 0 attempt (beam search, or greedy) is the JAX package's
    assert mine_runs[0][0] == ref_runs[0][0] == 0.0
    assert _tokens(mine_runs[0][1]) == _tokens(ref_runs[0][1])
    # every attempt, T > 0 included, decoded on the engine's loop body
    assert [r.temperature for r in history] == [t for t, _ in mine_runs]
    assert {r.temperature for r in history} == set(LADDER)
    assert all(r.loop == "program" and r.bodies > 0 for r in history)
    beam = kw.get("beam_size") is not None
    for r in history:
        assert r.beam_search == (beam and r.temperature == 0.0)
        # best_of draws a group of rows per audio at T > 0
        assert r.program[1] == (5 if beam or (r.temperature > 0 and kw.get("best_of")) else 1)
    segs = mine["segments"]
    assert segs and segs[-1]["end"] > 30.0
    assert all(np.isfinite([s["start"], s["end"], s["avg_logprob"]]).all() for s in segs)


LANGDETECT = dict(language=None, sample_len=SAMPLE_LEN)


def test_langdetect_ladder_host_loops_match_jax(tpu_model, torch_model, clip, monkeypatch):
    check_host_loops(tpu_model, torch_model, clip, LANGDETECT, monkeypatch)


def test_langdetect_ladder_on_the_engine(tpu_model, torch_model, clip, monkeypatch):
    check_engine(tpu_model, torch_model, clip, LANGDETECT, monkeypatch)
