"""Port decode() vs whisper_tpu.decode() token for token at temperature 0,
on the configurations of tests/test_fused.py, on the same checkpoint and
mel. avg_logprob and no_speech_prob agree within 1e-4 (float32 sums in
another order); language probabilities within 1e-4."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

CONFIGS = [
    dict(language="en", temperature=0.0, sample_len=40),
    dict(language="en", beam_size=2, sample_len=40),
    dict(language="en", beam_size=5, sample_len=30),
    dict(language="en", beam_size=3, patience=1.5, sample_len=30),
    dict(language="en", without_timestamps=True, sample_len=30),
    dict(language="en", sample_len=30, prompt="hello world test"),
    dict(language="en", sample_len=25, prefix="the quick"),
]
IDS = ["greedy", "beam2", "beam5", "beam3-patience", "no-ts", "prompt", "prefix"]


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(5).randn(80, 3000) * 0.6).astype(np.float32)


def _assert_same(mine, ref):
    assert mine.tokens == ref.tokens
    assert mine.text == ref.text
    assert mine.language == ref.language
    assert abs(mine.avg_logprob - ref.avg_logprob) < 1e-4
    assert abs(mine.no_speech_prob - ref.no_speech_prob) < 1e-4


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_decode_matches_jax(tpu_model, torch_model, mel, kw):
    tpu_model.use_fused_decode = True
    ref = whisper_tpu.decode(tpu_model, mel, whisper_tpu.DecodingOptions(**kw))
    mine = whisper_tpu_torch.decode(torch_model, mel, whisper_tpu_torch.DecodingOptions(**kw))
    assert len(mine.tokens) > 0
    _assert_same(mine, ref)


def test_decode_two_audios_matches_jax(tpu_model, torch_model, mel):
    mels = np.stack([mel, (np.random.RandomState(9).randn(80, 3000) * 0.6).astype(np.float32)])
    for kw in (dict(language="en", sample_len=20), dict(language="en", beam_size=3, sample_len=20)):
        ref = whisper_tpu.decode(tpu_model, mels, whisper_tpu.DecodingOptions(**kw))
        mine = whisper_tpu_torch.decode(torch_model, mels, whisper_tpu_torch.DecodingOptions(**kw))
        assert len(mine) == 2
        for m, r in zip(mine, ref):
            _assert_same(m, r)


def test_detect_language_matches_jax(tpu_model, torch_model, mel):
    ref_tok, ref_probs = tpu_model.detect_language(mel)
    tok, probs = torch_model.detect_language(mel)
    assert int(tok) == int(ref_tok)
    assert probs.keys() == ref_probs.keys()
    assert max(abs(probs[k] - ref_probs[k]) for k in probs) < 1e-4
    # language=None detects inside decode() too
    ref = whisper_tpu.decode(tpu_model, mel, whisper_tpu.DecodingOptions(sample_len=10))
    mine = whisper_tpu_torch.decode(
        torch_model, mel, whisper_tpu_torch.DecodingOptions(sample_len=10)
    )
    _assert_same(mine, ref)


def test_sampling_runs_and_stops(torch_model, mel):
    """At T > 0 the two packages draw different random numbers, so only the
    shape of the result and the loop's end are checked."""
    np.random.seed(0)
    opts = whisper_tpu_torch.DecodingOptions(language="en", temperature=0.7, sample_len=20)
    res = whisper_tpu_torch.decode(torch_model, mel, opts)
    assert 0 < len(res.tokens) <= 20
    assert np.isfinite(res.avg_logprob)
    res = whisper_tpu_torch.decode(
        torch_model, mel,
        whisper_tpu_torch.DecodingOptions(language="en", temperature=1.0, best_of=3, sample_len=15),
    )  # fmt: skip
    assert 0 < len(res.tokens) <= 15
    beam, temp, steps = torch_model._fused_engine.history[-1][:3]
    assert (beam, temp) == (False, 1.0) and 0 < steps <= 15


def test_engine_rejects_long_prompts(torch_model):
    from whisper_tpu_torch.engine import FusedEngine

    kw = dict(
        sot_index=0, suppress_ids=[], blank_ids=[], max_initial_ts_index=None, sample_len=5,
        n_group=1, beam_search=False, max_candidates=0, use_timestamps=False,
        temperature=0.0, eot=50257, timestamp_begin=50364, no_timestamps=50363,
        no_speech=50362,
    )  # fmt: skip
    with pytest.raises(ValueError, match="prefill window"):
        FusedEngine(torch_model).run(np.zeros((1, 300), np.int32), None, None, **kw)


def test_invalid_options_raise(torch_model, mel):
    with pytest.raises(ValueError, match="best_of with greedy"):
        whisper_tpu_torch.decode(torch_model, mel, whisper_tpu_torch.DecodingOptions(best_of=2))
