"""The port's ContinuousBatcher on the CPU, the cases of
tests/test_continuous.py (bar the draft model, the mesh and the JAX
package's fixed-shape round windows): each ticket equals the JAX package's
batcher's ticket on the same weights and the port's transcribe() of its
audio, whatever shared its rounds and whenever it was admitted. Equal
tokens and text, times within 1e-6 s, log-probabilities within 1e-4."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.continuous import ContinuousBatcher as JaxContinuousBatcher
from whisper_tpu_torch import batch
from whisper_tpu_torch.continuous import ContinuousBatcher

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

SR = 16000
EN = dict(language="en", temperature=0.0)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture
def rounds(monkeypatch):
    """(rows, distinct prompts, language, temperature) of every
    _decode_window_batch call the port's batcher makes."""
    calls = []
    run = batch._decode_window_batch

    def watched(model, mels, prompts, lang, t, task, decode_options):
        assert len(mels) == len(prompts)
        calls.append((len(prompts), len({tuple(p) for p in prompts}), lang, t))
        return run(model, mels, prompts, lang, t, task, decode_options)

    monkeypatch.setattr(batch, "_decode_window_batch", watched)
    return calls


def _assert_same(mine, ref, words=False, cross=True):
    assert mine["language"] == ref["language"]
    assert mine["text"] == ref["text"]
    assert len(mine["segments"]) == len(ref["segments"])
    for m, r in zip(mine["segments"], ref["segments"]):
        assert m["tokens"] == r["tokens"] and m["text"] == r["text"]
        assert (m["id"], m["seek"], m["temperature"]) == (r["id"], r["seek"], r["temperature"])
        assert abs(m["start"] - r["start"]) < 1e-6 and abs(m["end"] - r["end"]) < 1e-6
        if cross:
            assert abs(m["avg_logprob"] - r["avg_logprob"]) < 1e-4
        if words:
            assert [w["word"] for w in m["words"]] == [w["word"] for w in r["words"]]
            for a, b in zip(m["words"], r["words"]):
                assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6
                assert abs(a["probability"] - b["probability"]) < 1e-5


def _run(cls, model, audios, slots, mid=None, **kw):
    """Submit `audios`, step once, submit `mid` (if any), drain; the
    results in submission order."""
    cb = cls(model, slots=slots, **kw)
    tickets = [cb.submit(a) for a in audios]
    if mid is not None:
        assert cb.step()
        tickets.append(cb.submit(mid))
    cb.drain()
    assert cb.pending() == 0
    return cb, [cb.result(t) for t in tickets]


def _three_ways(tpu_model, torch_model, audios, slots, mid=None, words=False, **kw):
    """Port batcher = JAX batcher = the port's transcribe() per audio."""
    cb, mine = _run(ContinuousBatcher, torch_model, audios, slots, mid, **kw)
    _, ref = _run(JaxContinuousBatcher, tpu_model, audios, slots, mid, **kw)
    everything = list(audios) + ([mid] if mid is not None else [])
    for m, r, a in zip(mine, ref, everything):
        _assert_same(m, r, words=words)
        assert m["duration"] == r["duration"] == round(len(a) / SR, 3)
        _assert_same(m, torch_model.transcribe(a, verbose=None, **kw), words=words, cross=False)
    return cb, mine


def test_continuous_matches_sequential(tpu_model, torch_model, jfk_audio, rounds):
    """Two streams in two slots: one round of both rows."""
    _three_ways(tpu_model, torch_model, [jfk_audio, jfk_audio[2 * SR :]], 2, **EN)
    assert rounds == [(2, 1, "en", 0.0)]


def test_continuous_staggered_admission(tpu_model, torch_model, jfk_audio, rounds):
    """slots=1 and three streams: each enters when the one before has
    finished, and one submitted mid-drain joins the queue."""
    long_audio = np.concatenate([jfk_audio, jfk_audio])  # 22 s: two windows at this sample_len
    kw = dict(EN, sample_len=24, condition_on_previous_text=False)
    cb, _ = _three_ways(tpu_model, torch_model, [long_audio, jfk_audio], 1, mid=jfk_audio[SR:], **kw)
    assert all(r[0] == 1 for r in rounds) and len(rounds) >= 3
    assert cb.stats["rounds"] == len(rounds) and cb.stats["windows_decoded"] == len(rounds)


def test_continuous_conditioned_rounds_with_two_prompts(tpu_model, torch_model, jfk_audio, rounds):
    """Two streams of two windows whose first windows decode to other
    tokens: with conditioning, round 2 holds two prompts (one engine call
    each), and each ticket is still its own transcribe()."""
    noise = (np.random.RandomState(3).randn(35 * SR) * 0.05).astype(np.float32)
    _three_ways(tpu_model, torch_model, [np.tile(jfk_audio, 3), noise], 2, **EN)
    assert [r[:2] for r in rounds] == [(2, 1), (2, 2)]


def test_continuous_rounds_hold_occupied_slots_only(tpu_model, torch_model, jfk_audio, rounds):
    """One stream in three slots decodes one row a round (no idle slot
    decodes silence) and equals transcribe()."""
    _three_ways(tpu_model, torch_model, [jfk_audio], 3, **EN)
    assert rounds == [(1, 1, "en", 0.0)]


def test_continuous_language_groups(tpu_model, torch_model, jfk_audio, rounds):
    """No pinned language: requests of two languages share a round as one
    decode per language, each equal to the JAX batcher's and to
    transcribe() in its language."""
    audios = [jfk_audio, jfk_audio[2 * SR :]]
    out = []
    for cls, model in ((ContinuousBatcher, torch_model), (JaxContinuousBatcher, tpu_model)):
        cb = cls(model, slots=2, temperature=0.0)
        tickets = [cb.submit(audios[0], language="en"), cb.submit(audios[1], language="French")]
        cb.drain()
        out.append([cb.result(t) for t in tickets])
    for m, r, a, lang in zip(out[0], out[1], audios, ("en", "fr")):
        assert m["language"] == lang
        _assert_same(m, r)
        _assert_same(m, torch_model.transcribe(a, verbose=None, language=lang, temperature=0.0), cross=False)
    assert sorted(r[:3] for r in rounds) == [(1, 1, "en"), (1, 1, "fr")]


def test_continuous_short_audio_resolves_immediately(torch_model):
    cb = ContinuousBatcher(torch_model, slots=2, language="en")
    t = cb.submit(np.zeros(4000, np.float32))  # 0.25 s: the sub-second tail is dropped
    assert cb.ready(t)
    assert cb.result(t)["text"] == "" and cb.result(t)["duration"] == 0.25
    assert cb.step() is False  # nothing to do
    assert cb.stats["requests_completed"] == 1 and cb.stats["rounds"] == 0


def test_continuous_result_before_done_raises(torch_model, jfk_audio):
    cb = ContinuousBatcher(torch_model, slots=1, **EN)
    t = cb.submit(jfk_audio)
    assert not cb.ready(t)
    with pytest.raises(KeyError):
        cb.result(t)
    cb.drain()
    assert cb.ready(t) and cb.result(t)["text"]


def test_continuous_word_timestamps(tpu_model, torch_model, jfk_audio):
    """Words and their times are transcribe(word_timestamps=True)'s and the
    JAX batcher's."""
    _three_ways(
        tpu_model, torch_model, [jfk_audio, jfk_audio[3 * SR :]], 2, words=True, word_timestamps=True,
        **EN,
    )  # fmt: skip


def test_continuous_pop_evicts(torch_model, jfk_audio):
    cb = ContinuousBatcher(torch_model, slots=1, **EN)
    t = cb.submit(jfk_audio)
    cb.drain()
    assert cb.pop(t)["text"]
    assert cb.pending() == 0
    with pytest.raises(KeyError):
        cb.result(t)
    assert not cb._streams and not cb._results and not cb._langs
    assert cb.stats["requests_submitted"] == cb.stats["requests_completed"] == 1


def test_continuous_beam_matches_sequential(tpu_model, torch_model, jfk_audio, rounds):
    _three_ways(tpu_model, torch_model, [jfk_audio, jfk_audio[2 * SR :]], 2, beam_size=2, **EN)
    assert rounds == [(2, 1, "en", 0.0)]


def test_continuous_stats_phase_sums(torch_model, jfk_audio):
    """The monotonic counters, and the three phases inside each round's
    wall time."""
    cb = ContinuousBatcher(torch_model, slots=2, **EN)
    cb.submit(np.tile(jfk_audio, 3))
    cb.submit(jfk_audio)
    cb.drain()
    s = cb.stats
    assert (s["requests_submitted"], s["requests_completed"]) == (2, 2)
    assert (s["rounds"], s["windows_decoded"]) == (2, 3)
    phases = s["mel_seconds_sum"] + s["decode_seconds_sum"] + s["apply_seconds_sum"]
    assert 0 < phases <= s["round_seconds_sum"]
    assert min(s["mel_seconds_sum"], s["decode_seconds_sum"], s["apply_seconds_sum"]) > 0


def test_submit_rejections_leave_no_state(torch_model, tmp_path):
    """A submission that raises leaves no stream state and does not count;
    per-request languages are checked against the tokenizer's table and
    the pin, aliases accepted."""
    cb = ContinuousBatcher(torch_model, slots=2, **EN)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"definitely not audio")
    with pytest.raises(ValueError, match="could not decode audio"):
        cb.submit(str(bad))
    with pytest.raises(ValueError, match="unsupported language"):
        cb.submit(np.zeros(SR, np.float32), language="xx")
    with pytest.raises(ValueError, match="pinned"):
        cb.submit(np.zeros(SR, np.float32), language="fr")
    assert cb.stats["requests_submitted"] == 0
    assert cb.pending() == 0 and cb._streams == {} and len(cb._queue) == 0 and cb._next_ticket == 0
    t = cb.submit(np.zeros(SR, np.float32), language="ENGLISH")
    assert cb.stats["requests_submitted"] == 1
    assert cb._langs[t] == "en"


def test_pinned_language_normalizes_like_requests(torch_model):
    cb = ContinuousBatcher(torch_model, slots=1, language="English", temperature=0.0)
    assert cb.language == "en"
    for alias in ("english", "EN"):
        assert cb._langs[cb.submit(np.zeros(SR, np.float32), language=alias)] == "en"
    with pytest.raises(ValueError):
        cb.submit(np.zeros(SR, np.float32), language="fr")
    with pytest.raises(ValueError):
        ContinuousBatcher(torch_model, slots=1, language="klingon")
    with pytest.raises(ValueError, match="slots"):
        ContinuousBatcher(torch_model, slots=0)
