"""Port transcribe() vs the JAX package's on tests/data/jfk.flac at
temperature 0: the same text, segment tokens and segment times."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


def _assert_same_transcript(mine, ref):
    assert mine["language"] == ref["language"]
    assert mine["text"] == ref["text"]
    assert len(mine["segments"]) == len(ref["segments"]) > 0
    for m, r in zip(mine["segments"], ref["segments"]):
        assert m["tokens"] == r["tokens"]
        assert m["text"] == r["text"]
        for key in ("id", "seek", "start", "end", "temperature"):
            assert m[key] == r[key], key
        assert abs(m["avg_logprob"] - r["avg_logprob"]) < 1e-4
        assert abs(m["no_speech_prob"] - r["no_speech_prob"]) < 1e-4


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(clip_timestamps="2,8"),
        dict(initial_prompt="Greetings", carry_initial_prompt=True),
    ],
    ids=["plain", "clip", "initial-prompt"],
)
def test_transcribe_matches_jax(tpu_model, torch_model, jfk_audio, kw):
    tpu_model.use_fused_decode = True
    ref = tpu_model.transcribe(jfk_audio, language="en", temperature=0.0, verbose=None, **kw)
    mine = torch_model.transcribe(jfk_audio, language="en", temperature=0.0, verbose=None, **kw)
    _assert_same_transcript(mine, ref)


@pytest.mark.parametrize(
    "tile,kw",
    [
        (3, dict(beam_size=2, sample_len=100)),  # 100 tokens a row: half the file's time
        (3, dict(condition_on_previous_text=False)),
        (1, dict(task="translate")),
        (1, dict(without_timestamps=True)),
    ],
    ids=["long-beam2", "long-unconditioned", "translate", "without-timestamps"],
)
def test_transcribe_options_match_jax(tpu_model, torch_model, jfk_audio, tile, kw, monkeypatch):
    """Long form (33 s: two windows) at beam 2 and without conditioning on
    the previous window's text, the translate task, and no timestamps."""
    monkeypatch.setattr(tpu_model, "use_fused_decode", True, raising=False)
    audio = np.tile(jfk_audio, tile)
    ref = tpu_model.transcribe(audio, language="en", temperature=0.0, verbose=None, **kw)
    mine = torch_model.transcribe(audio, language="en", temperature=0.0, verbose=None, **kw)
    _assert_same_transcript(mine, ref)
    if tile > 1:
        assert mine["segments"][-1]["seek"] > 0  # the second window was decoded


def test_transcribe_from_path_and_language_detection(tpu_model, torch_model, jfk_flac_path):
    ref = tpu_model.transcribe(jfk_flac_path, temperature=0.0, verbose=None)
    mine = whisper_tpu_torch.transcribe(torch_model, jfk_flac_path, temperature=0.0, verbose=None)
    _assert_same_transcript(mine, ref)


def test_long_form_runs_the_fallback_ladder(torch_model, jfk_audio):
    """Two windows with the default temperature ladder: the result is well
    formed whatever the random draws are."""
    res = torch_model.transcribe(np.tile(jfk_audio, 3), language="en", verbose=None)
    assert res["segments"] and res["segments"][-1]["end"] > 30.0
    assert all(s["start"] <= s["end"] for s in res["segments"])
