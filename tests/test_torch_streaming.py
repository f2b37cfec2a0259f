"""The port's StreamingTranscriber on the CPU, the cases of
tests/test_streaming.py: the same audio fed in the same chunks gives the
JAX package's StreamingTranscriber's finals on the same weights (equal
tokens and text, segment and word times within 1e-6 s, log-probabilities
within 1e-4), and the port's transcribe() of the concatenated audio.
Partials are held against the JAX partials."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.streaming import StreamingTranscriber as JaxStreamingTranscriber
from whisper_tpu_torch.streaming import StreamingTranscriber

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

SR = 16000


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def audio33(jfk_audio):
    return np.concatenate([jfk_audio, jfk_audio, jfk_audio])


@pytest.fixture(scope="module")
def port_transcribe(torch_model):
    """The port's transcribe(), once per (audio, options)."""
    cache = {}

    def run(audio, **kw):
        key = (audio.tobytes(), tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = torch_model.transcribe(audio, verbose=None, **kw)
        return cache[key]

    return run


def _stream(st, audio, chunk_s):
    """Feed `audio` in chunks of `chunk_s` seconds, then flush: (finals,
    partials, whether a partial came before the first final)."""
    finals, partials, early = [], [], False
    step = int(chunk_s * SR)
    for i in range(0, len(audio), step):
        for seg in st.feed(audio[i : i + step]):
            if seg.get("partial"):
                partials.append(seg)
                early = early or not finals
            else:
                finals.append(seg)
    finals.extend(st.flush())
    return finals, partials, early


def _both(jax_model, torch_model, audio, chunk_s, **kw):
    """The port's and the JAX package's runs over the same chunks."""
    mine = StreamingTranscriber(torch_model, **kw)
    ref = JaxStreamingTranscriber(jax_model, **kw)
    return (mine, _stream(mine, audio, chunk_s)), (ref, _stream(ref, audio, chunk_s))


def _assert_segments(mine, ref, words=False, cross=True):
    """Equal tokens and text, times within 1e-6 s; with `cross` (the other
    package) the log-probabilities within 1e-4."""
    assert [s["tokens"] for s in mine] == [s["tokens"] for s in ref]
    assert [s["text"] for s in mine] == [s["text"] for s in ref]
    for a, b in zip(mine, ref):
        assert (a["id"], a["seek"]) == (b["id"], b["seek"])
        assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6
        if cross:
            assert abs(a["avg_logprob"] - b["avg_logprob"]) < 1e-4
        if words:
            wa, wb = a.get("words", []), b.get("words", [])
            assert [w["word"] for w in wa] == [w["word"] for w in wb]
            for x, y in zip(wa, wb):
                assert abs(x["start"] - y["start"]) < 1e-6 and abs(x["end"] - y["end"]) < 1e-6
                assert abs(x["probability"] - y["probability"]) < 1e-5


@pytest.mark.parametrize("chunk_seconds", [0.7, 3.0, 31.0])
def test_streaming_matches_jax_and_transcribe(tpu_model, torch_model, audio33, port_transcribe, chunk_seconds):
    kw = dict(language="en", temperature=0.0)
    (mine, (got, _, _)), (ref, (want, _, _)) = _both(tpu_model, torch_model, audio33, chunk_seconds, **kw)
    _assert_segments(got, want)
    assert mine.result["text"] == ref.result["text"]
    single = port_transcribe(audio33, **kw)
    assert mine.result["text"] == single["text"]
    _assert_segments(got, single["segments"], cross=False)


def test_streaming_incremental_emission(torch_model, audio33, port_transcribe):
    """The first window's segments come before the stream ends; a flushed
    stream refuses more audio."""
    st = StreamingTranscriber(torch_model, language="en", temperature=0.0)
    early = st.feed(audio33[: 31 * SR])  # one full window and the margin
    assert len(early) > 0
    late = st.feed(audio33[31 * SR :]) + st.flush()
    single = port_transcribe(audio33, language="en", temperature=0.0)
    _assert_segments(early + late, single["segments"], cross=False)
    with pytest.raises(RuntimeError):
        st.feed(np.zeros(10, np.float32))


def test_streaming_language_autodetect(tpu_model, torch_model, audio33, port_transcribe):
    """language=None: detected on the first final window, the window
    transcribe(language=None) detects on, then pinned."""
    assert torch_model.is_multilingual
    mine = StreamingTranscriber(torch_model, temperature=0.0)
    assert mine.result["language"] is None  # nothing pinned before a decode
    ref = JaxStreamingTranscriber(tpu_model, temperature=0.0)
    got, _, _ = _stream(mine, audio33, 3.0)
    want, _, _ = _stream(ref, audio33, 3.0)
    assert mine.result["language"] == ref.result["language"]
    _assert_segments(got, want)
    single = port_transcribe(audio33, temperature=0.0)
    assert mine.result["language"] == single["language"]
    assert mine.result["text"] == single["text"]


def test_streaming_autodetect_partials_before_pin(tpu_model, torch_model, jfk_audio, port_transcribe):
    """A partial before the pin detects for itself and pins nothing: the
    finals are still transcribe(language=None)'s, and the partial is the
    JAX package's."""
    out = []
    for cls, model in ((StreamingTranscriber, torch_model), (JaxStreamingTranscriber, tpu_model)):
        st = cls(model, temperature=0.0)
        st.feed(jfk_audio[: 5 * SR])
        partial = st.partial()
        assert st.result["language"] is None
        st.feed(jfk_audio[5 * SR :])
        out.append((st, partial, st.flush()))
    (mine, mine_partial, got), (ref, ref_partial, want) = out
    _assert_segments(mine_partial, ref_partial)
    _assert_segments(got, want)
    single = port_transcribe(jfk_audio, temperature=0.0)
    assert mine.result["language"] == ref.result["language"] == single["language"]
    _assert_segments(got, single["segments"], cross=False)


def test_streaming_word_timestamps(tpu_model, torch_model, audio33, port_transcribe):
    """Finals carry transcribe(word_timestamps=True)'s words, the word-end
    seek included, and the JAX package's."""
    kw = dict(language="en", temperature=0.0, word_timestamps=True)
    (mine, (got, _, _)), (ref, (want, _, _)) = _both(tpu_model, torch_model, audio33, 4.0, **kw)
    assert any(s.get("words") for s in got), "no words attached"
    _assert_segments(got, want, words=True)
    single = port_transcribe(audio33, **kw)
    assert mine.result["text"] == single["text"]
    _assert_segments(got, single["segments"], words=True, cross=False)


def test_streaming_partials_before_first_window(tpu_model, torch_model, audio33, port_transcribe):
    """partial_hop_s: advisories long before the first window completes,
    equal to the JAX package's, and finals unchanged by them (a partial
    every 4 s of 2 s chunks: seven before the first final)."""
    kw = dict(language="en", temperature=0.0, partial_hop_s=4.0)
    (mine, (got, partials, early)), (ref, (want, ref_partials, _)) = _both(
        tpu_model, torch_model, audio33, 2.0, **kw
    )
    assert partials and early, "no partial before the first final"
    assert all(p["partial"] and p["text"].strip() for p in partials)
    _assert_segments(partials, ref_partials)
    _assert_segments(got, want)
    single = port_transcribe(audio33, language="en", temperature=0.0)
    _assert_segments(got, single["segments"], cross=False)
    assert all(not s.get("partial") for s in mine.result["segments"])


def test_streaming_partial_on_demand(tpu_model, torch_model, jfk_audio, port_transcribe):
    """partial() decodes the open window now, twice the same, and leaves
    the stream's state alone."""
    st = StreamingTranscriber(torch_model, language="en", temperature=0.0)
    st.feed(jfk_audio[: 5 * SR])
    p1, p2 = st.partial(), st.partial()
    assert p1 and all(s["partial"] for s in p1)
    _assert_segments(p1, p2, cross=False)
    ref = JaxStreamingTranscriber(tpu_model, language="en", temperature=0.0)
    ref.feed(jfk_audio[: 5 * SR])
    _assert_segments(p1, ref.partial())
    st.feed(jfk_audio[5 * SR :])
    finals = st.flush()
    single = port_transcribe(jfk_audio, language="en", temperature=0.0)
    assert st.result["text"] == single["text"]
    _assert_segments(finals, single["segments"], cross=False)


def test_streaming_partial_hop_validation(torch_model):
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="partial_hop_s"):
            StreamingTranscriber(torch_model, language="en", partial_hop_s=bad)


def test_streaming_hallucination_silence(tpu_model, torch_model, jfk_audio, port_transcribe):
    """The silence pass runs per final window with transcribe()'s
    decisions (the silences lie away from window boundaries, so the
    causality note of StreamingTranscriber cannot apply)."""
    sil = np.zeros(8 * SR, np.float32)
    audio = np.concatenate([jfk_audio[: 5 * SR], sil, jfk_audio[5 * SR :], sil, jfk_audio[: 6 * SR]])
    kw = dict(language="en", temperature=0.0, word_timestamps=True, hallucination_silence_threshold=2.0)
    (mine, (got, _, _)), (ref, (want, _, _)) = _both(tpu_model, torch_model, audio, 3.0, **kw)
    _assert_segments(got, want, words=True)
    single = port_transcribe(audio, **kw)
    assert mine.result["text"] == single["text"]
    _assert_segments(got, single["segments"], words=True, cross=False)
