"""The port's transcribe_batch / transcribe_chunked and its frontend against
the JAX package's on the CPU: equal text and segment tokens, segment and
word times within 1e-6 s; the batched mel within 2e-5 and its windows
exactly equal; the clip frontend within 2e-3 of the per-window encoder."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu_torch import decoding, frontend

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def streams(jfk_audio):
    """A 33 s stream (two rounds) and a 9 s one (done after the first)."""
    return [np.tile(jfk_audio, 3), jfk_audio[32000:]]


@pytest.fixture(scope="module")
def mixed_prompts(jfk_audio):
    """Two streams of two rounds whose first windows decode to different
    tokens, so that with conditioning the second round has two prompts."""
    noise = (np.random.RandomState(3).randn(35 * 16000) * 0.05).astype(np.float32)
    return [np.tile(jfk_audio, 3), noise]


@pytest.fixture(scope="module")
def jax_batch(tpu_model, streams):
    """The JAX package's transcribe_batch of `streams`, once per keyword set."""
    cache = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = whisper_tpu.transcribe_batch(tpu_model, streams, **kw)
        return cache[key]

    return run


@pytest.fixture
def loops(monkeypatch):
    """(loop, rows) of every decode loop a DecodingTask runs."""
    calls = []
    for kind in ("fused", "host"):
        run = getattr(decoding.DecodingTask, f"_main_loop_{kind}")

        def watched(self, tokens, run=run, kind=kind):
            calls.append((kind, tokens.shape[0]))
            return run(self, tokens)

        monkeypatch.setattr(decoding.DecodingTask, f"_main_loop_{kind}", watched)
    return calls


def _assert_same(mine, ref, words=False):
    assert mine["language"] == ref["language"]
    assert mine["text"] == ref["text"]
    assert len(mine["segments"]) == len(ref["segments"]) > 0
    for m, r in zip(mine["segments"], ref["segments"]):
        assert m["tokens"] == r["tokens"]
        assert m["text"] == r["text"]
        assert (m["id"], m["seek"], m["temperature"]) == (r["id"], r["seek"], r["temperature"])
        assert abs(m["start"] - r["start"]) < 1e-6 and abs(m["end"] - r["end"]) < 1e-6
        assert abs(m["avg_logprob"] - r["avg_logprob"]) < 1e-4
        assert abs(m["no_speech_prob"] - r["no_speech_prob"]) < 1e-4
        if words:
            assert [w["word"] for w in m["words"]] == [w["word"] for w in r["words"]]
            for a, b in zip(m["words"], r["words"]):
                assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6
                assert abs(a["probability"] - b["probability"]) < 1e-4


@pytest.mark.parametrize("fused", [True, False], ids=["engine", "host"])
@pytest.mark.parametrize("condition", [True, False], ids=["conditioned", "unconditioned"])
def test_batch_matches_jax(jax_batch, torch_model, streams, condition, fused, loops, monkeypatch):
    """Round 2 holds only the unfinished 33 s stream, on the model's loop
    (the engine, or the host loop when use_fused_decode is off)."""
    monkeypatch.setattr(torch_model, "use_fused_decode", fused)
    kw = dict(language="en", temperature=0.0, condition_on_previous_text=condition)
    ref = jax_batch(**kw)
    mine = whisper_tpu_torch.transcribe_batch(torch_model, streams, **kw)
    assert len(mine) == len(ref) == 2
    for m, r in zip(mine, ref):
        _assert_same(m, r)
    kind = "fused" if fused else "host"
    assert loops == [(kind, 2), (kind, 1)]


def test_batch_prompt_groups_match_jax(tpu_model, torch_model, mixed_prompts, loops):
    """Streams with different prompts decode in one engine call per prompt
    (the JAX package runs that round on its host loop): equal results."""
    kw = dict(language="en", temperature=0.0, condition_on_previous_text=True)
    ref = whisper_tpu.transcribe_batch(tpu_model, mixed_prompts, **kw)
    mine = whisper_tpu_torch.transcribe_batch(torch_model, mixed_prompts, **kw)
    for m, r in zip(mine, ref):
        _assert_same(m, r)
    assert loops == [("fused", 2), ("fused", 1), ("fused", 1)]


def test_finished_streams_leave_the_round(torch_model, streams, monkeypatch):
    """Under the default temperature ladder, a stream that is done decodes
    nothing more: round 2 and every fallback decode the 33 s stream's
    window alone."""
    rows = []
    run = decoding.DecodingTask.run

    def watched(self, mel):
        rows.append((self.options.temperature, mel.shape[0]))
        return run(self, mel)

    monkeypatch.setattr(decoding.DecodingTask, "run", watched)
    whisper_tpu_torch.transcribe_batch(torch_model, streams, language="en", sample_len=16)
    assert [n for t, n in rows if t == 0.0] == [2, 1]
    assert all(n == 1 for _, n in rows[1:])


def test_batch_word_timestamps_match_jax(tpu_model, torch_model, jfk_audio):
    kw = dict(language="en", temperature=0.0, word_timestamps=True)
    audios = [jfk_audio, jfk_audio[32000:]]
    ref = whisper_tpu.transcribe_batch(tpu_model, audios, **kw)
    mine = whisper_tpu_torch.transcribe_batch(torch_model, audios, **kw)
    for m, r in zip(mine, ref):
        _assert_same(m, r, words=True)
        assert sum(len(s["words"]) for s in m["segments"]) > 0


def test_batch_matches_port_sequential(torch_model, streams):
    batch = whisper_tpu_torch.transcribe_batch(torch_model, streams, language="en", temperature=0.0)
    for b, audio in zip(batch, streams):
        s = torch_model.transcribe(audio, language="en", temperature=0.0, verbose=None)
        assert b["text"] == s["text"]
        assert [seg["tokens"] for seg in b["segments"]] == [seg["tokens"] for seg in s["segments"]]
        assert [seg["start"] for seg in b["segments"]] == [seg["start"] for seg in s["segments"]]


def test_chunked_matches_jax(tpu_model, torch_model, streams):
    kw = dict(language="en", temperature=0.0, sample_len=24)
    ref = whisper_tpu.transcribe_chunked(tpu_model, streams[0], **kw)
    mine = whisper_tpu_torch.transcribe_chunked(torch_model, streams[0], **kw)
    _assert_same(mine, ref)
    assert [s["id"] for s in mine["segments"]] == list(range(len(mine["segments"])))
    assert any(s["seek"] >= 3000 and s["start"] >= 30.0 for s in mine["segments"])


def test_batch_accepts_verbose(torch_model, jfk_audio):
    """transcribe() and transcribe_batch share callers' keyword arguments;
    verbose must not reach DecodingOptions (it would raise TypeError)."""
    out = whisper_tpu_torch.transcribe_batch(
        torch_model, [jfk_audio], language="en", temperature=0.0, verbose=None, sample_len=8
    )
    assert len(out) == 1 and "segments" in out[0]
    res = whisper_tpu_torch.transcribe_chunked(
        torch_model, jfk_audio, language="en", temperature=0.0, verbose=False, sample_len=8
    )
    assert "segments" in res


def _waveforms():
    rng = np.random.RandomState(0)
    exact = (rng.randint(-3000, 3000, 16000 * 7) / 32768.0).astype(np.float32)
    inexact = (rng.randn(16000 * 4) * 0.1).astype(np.float32)
    return exact, inexact


def test_pack_audio_matches_jax():
    from whisper_tpu.frontend import pack_audio as jax_pack

    for audio in _waveforms():
        mine, ref = frontend.pack_audio(audio, 16000 * 30), jax_pack(audio, 16000 * 30)
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
    assert frontend.pack_audio(_waveforms()[0], 16000 * 30).dtype == np.int16


@pytest.mark.parametrize("mix", ["int16", "float32", "mixed"])
def test_batched_device_mel_matches_jax(mix):
    """On CPU tensors: within 2e-5 of the JAX batched mel, the same content
    frames; the windows at clamped seeks and zero masks exactly equal."""
    from whisper_tpu.frontend import batched_device_mel as jax_mel
    from whisper_tpu.frontend import batched_mel_windows as jax_windows

    exact, inexact = _waveforms()
    audios = {
        "int16": [exact, exact[: 16000 * 3]],
        "float32": [inexact, inexact[::-1].copy()],
        "mixed": [exact, inexact, exact[16000:]],
    }[mix]
    mine, content = frontend.batched_device_mel(audios, 80, "cpu")
    ref, ref_content = jax_mel(audios, 80)
    ref = np.asarray(ref)
    assert content == ref_content and tuple(mine.shape) == ref.shape
    assert np.abs(mine.numpy() - ref).max() < 2e-5

    F = ref.shape[-1]
    seeks = [0, 650, F][: len(audios)]  # the last one clamps to F - 3000
    sizes = [3000, 120, 0][: len(audios)]
    wm = frontend.batched_mel_windows(torch.from_numpy(ref.copy()), seeks, sizes)
    np.testing.assert_array_equal(wm.numpy(), np.asarray(jax_windows(ref, seeks, sizes)))


def test_encode_clip_matches_encode_windows(tpu_model, torch_model, jfk_audio):
    """The clip frontend (mel, windows, encoder, cross-K/V) within 2e-3 of
    the host mel's window through encode_with_cross_kv, and of the JAX
    package's clip frontend."""
    from whisper_tpu.frontend import encode_clip as jax_encode_clip
    from whisper_tpu_torch.audio import N_FRAMES, N_SAMPLES, log_mel_spectrogram, pad_or_trim

    audio = np.concatenate([jfk_audio, jfk_audio, jfk_audio])  # two windows
    ck, cv, n_windows = frontend.encode_clip(torch_model, audio)
    assert n_windows == 2 and ck.shape[1] == cv.shape[1] == 2

    mel = log_mel_spectrogram(audio, 80, padding=N_SAMPLES)
    windows = np.stack([pad_or_trim(mel[:, i * N_FRAMES : (i + 1) * N_FRAMES], N_FRAMES) for i in (0, 1)])
    _, ck_ref, cv_ref = torch_model.encode_with_cross_kv(windows.astype(np.float32))
    assert (ck - ck_ref).abs().max().item() < 2e-3
    assert (cv - cv_ref).abs().max().item() < 2e-3

    jck, jcv, _ = jax_encode_clip(tpu_model, audio)
    assert np.abs(ck.numpy() - np.asarray(jck)).max() < 2e-3
    assert np.abs(cv.numpy() - np.asarray(jcv)).max() < 2e-3
