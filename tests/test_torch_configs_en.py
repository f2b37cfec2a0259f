"""An English-only model (the gpt2 encoding: V = 51864, EOT 50256, SOT
50257, timestamps from 50363, a one-token SOT sequence, so sample_begin is
1) through the port's decode(), detect_language, transcribe() with and
without words and transcribe_batch, against the JAX package on one
synthetic checkpoint in float32: equal tokens and segments, times within
1e-6 s. The port decodes on its engine (the loop body with the update
kernels' loop-state launches; their plain versions on the CPU)."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu_torch import decoding, engine

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

LANG_ID = "This model doesn't have language tokens so it can't perform lang id"


@pytest.fixture(scope="module")
def en_checkpoint(tmp_path_factory):
    from oracle import save_reference_checkpoint
    from whisper_tpu.models.dims import ModelDimensions

    dims = ModelDimensions(80, 1500, 128, 2, 2, 51864, 448, 128, 2, 2)
    path = tmp_path_factory.mktemp("en") / "synth_en.pt"
    return save_reference_checkpoint(str(path), dims, seed=21, scale=0.5)


@pytest.fixture(scope="module")
def jax_en(en_checkpoint):
    return whisper_tpu.load_model(en_checkpoint, compute_dtype="float32")


@pytest.fixture(scope="module")
def torch_en(en_checkpoint):
    return whisper_tpu_torch.load_model(en_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(9).randn(80, 3000) * 0.6).astype(np.float32)


def _same_segments(mine, ref):
    assert mine["language"] == ref["language"] == "en"
    assert mine["text"] == ref["text"]
    assert len(mine["segments"]) == len(ref["segments"]) > 0
    for m, r in zip(mine["segments"], ref["segments"]):
        assert m["tokens"] == r["tokens"]
        for key in ("id", "seek", "temperature", "text"):
            assert m[key] == r[key], key
        for key in ("start", "end"):
            assert abs(m[key] - r[key]) <= 1e-6, key
        assert abs(m["avg_logprob"] - r["avg_logprob"]) < 1e-4


def test_en_layout_matches_jax(torch_en, jax_en):
    """The tokenizer's specials and the task's initial tokens, sample_begin
    and penalty vectors are the JAX package's at the English-only layout."""
    assert not torch_en.is_multilingual and not jax_en.is_multilingual
    assert torch_en.num_languages == jax_en.num_languages
    opts = dict(language="en", temperature=0.0)
    mine = decoding.DecodingTask(torch_en, whisper_tpu_torch.DecodingOptions(**opts))
    ref = whisper_tpu.decoding.DecodingTask(jax_en, whisper_tpu.DecodingOptions(**opts))
    assert mine.initial_tokens == tuple(ref.initial_tokens) == (50257,)
    assert mine.sample_begin == ref.sample_begin == 1
    tok = mine.tokenizer
    assert (tok.eot, tok.sot, tok.no_timestamps, tok.timestamp_begin) == (50256, 50257, 50362, 50363)
    assert tok.no_speech == ref.tokenizer.no_speech
    assert sorted(mine._get_suppress_tokens()) == sorted(ref._get_suppress_tokens())


@pytest.mark.parametrize("kw", [{}, dict(beam_size=5)], ids=["greedy", "beam5"])
def test_en_decode_matches_jax(torch_en, jax_en, mel, kw):
    opts = dict(language="en", temperature=0.0, sample_len=40, **kw)
    ref = whisper_tpu.decode(jax_en, mel, whisper_tpu.DecodingOptions(**opts))
    history = engine.model_engine(torch_en).history
    history.clear()
    mine = whisper_tpu_torch.decode(torch_en, mel, whisper_tpu_torch.DecodingOptions(**opts))
    assert mine.tokens == ref.tokens and len(mine.tokens) > 0
    assert mine.text == ref.text and mine.language == ref.language == "en"
    assert abs(mine.avg_logprob - ref.avg_logprob) < 1e-4
    assert abs(mine.no_speech_prob - ref.no_speech_prob) < 1e-4
    # the engine's loop body decoded it
    (run,) = history
    assert run.loop == "program" and run.bodies > 0 and run.beam_search == bool(kw)


def test_en_language_none_raises_as_jax(torch_en, jax_en, mel):
    with pytest.raises(ValueError, match=LANG_ID):
        whisper_tpu.decode(jax_en, mel, whisper_tpu.DecodingOptions(temperature=0.0, sample_len=5))
    with pytest.raises(ValueError, match=LANG_ID):
        whisper_tpu_torch.decode(torch_en, mel, whisper_tpu_torch.DecodingOptions(temperature=0.0, sample_len=5))
    with pytest.raises(ValueError, match=LANG_ID):
        whisper_tpu.detect_language(jax_en, mel)
    with pytest.raises(ValueError, match=LANG_ID):
        whisper_tpu_torch.detect_language(torch_en, torch.from_numpy(mel))


@pytest.mark.parametrize("words", [False, True], ids=["plain", "words"])
def test_en_transcribe_matches_jax(torch_en, jax_en, jfk_audio, words):
    """language=None on an English-only model transcribes English."""
    kw = dict(language=None, temperature=0.0, verbose=None, word_timestamps=words)
    ref = jax_en.transcribe(jfk_audio, **kw)
    mine = torch_en.transcribe(jfk_audio, **kw)
    _same_segments(mine, ref)
    if words:
        mw = [w for s in mine["segments"] for w in s["words"]]
        rw = [w for s in ref["segments"] for w in s["words"]]
        assert [w["word"] for w in mw] == [w["word"] for w in rw] and rw
        for m, r in zip(mw, rw):
            assert abs(m["start"] - r["start"]) <= 1e-6 and abs(m["end"] - r["end"]) <= 1e-6
            assert abs(m["probability"] - r["probability"]) < 1e-4


def test_en_transcribe_batch_matches_jax(torch_en, jax_en, jfk_audio):
    from whisper_tpu.batch import transcribe_batch as jax_batch

    streams = [jfk_audio, (np.random.RandomState(3).randn(14 * 16000) * 0.05).astype(np.float32)]
    kw = dict(temperature=0.0)
    ref = jax_batch(jax_en, streams, **kw)
    mine = whisper_tpu_torch.transcribe_batch(torch_en, streams, **kw)
    assert len(mine) == len(ref) == 2
    for m, r in zip(mine, ref):
        _same_segments(m, r)
