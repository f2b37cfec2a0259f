"""Port word timestamps (whisper_tpu_torch/timing.py, the alignment graphs,
transcribe's word branch and silence pass) vs the JAX package on its default
path (the device alignment replay, then the float64 DTW), at float32 on the
CPU, on the same weights and the same numpy inputs.

Tolerances: graphs within 1e-4 and the cost matrix within 1e-5 (the two CPU
backends sum matmuls and softmaxes in different orders; the measured
differences are ~1e-6); word times within 1e-6, i.e. equal DTW paths;
probabilities within 1e-5."""

import base64
import copy
import gzip
import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.timing as jtiming
import whisper_tpu_torch
import whisper_tpu_torch.timing as ttiming
from whisper_tpu.models import graphs as jg
from whisper_tpu.models.registry import ALIGNMENT_HEADS
from whisper_tpu.models.whisper import Whisper as JaxWhisper
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch.models import graphs as tg
from whisper_tpu_torch.models.dims import MODEL_DIMS
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer import get_tokenizer

# the packages export a function named `transcribe` over the module's name
jtranscribe = importlib.import_module("whisper_tpu.transcribe")
ttranscribe = importlib.import_module("whisper_tpu_torch.transcribe")

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
TEXT = " The quick brown fox jumps over the lazy dog."


@pytest.fixture(autouse=True)
def default_jax_path(monkeypatch):
    """The JAX package's default word-timing path: device replay, numpy DTW."""
    monkeypatch.delenv("WHISPER_TPU_DEVICE_ALIGN", raising=False)
    monkeypatch.delenv("WHISPER_TPU_PALLAS", raising=False)


@pytest.fixture(scope="module")
def port(tpu_model):
    """The port's model on the JAX model's weights, carried over by
    params_from_jax."""
    return whisper_tpu_torch.Whisper(
        tpu_model.dims, params_from_jax(tpu_model.params), device="cpu",
        compute_dtype=torch.float32,
    )  # fmt: skip


@pytest.fixture(scope="module")
def cross(tpu_model, port):
    xa = (np.random.RandomState(2).randn(1, 1500, 128) * 0.3).astype(np.float32)
    jck, jcv = tpu_model.cross_kv(jnp.asarray(xa))
    tck, tcv = port.cross_kv(torch.from_numpy(xa))
    return jck, jcv, tck, tcv


@pytest.fixture(scope="module")
def replay_tokens():
    tok = get_tokenizer(True, language="en", task="transcribe")
    text = tok.encode(TEXT)
    tokens = [*tok.sot_sequence, tok.no_timestamps, *text, tok.eot]
    return tok, text, np.array([tokens])


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **(tol or TOL))


def test_default_alignment_heads(tpu_model, port):
    assert port.alignment_heads == tpu_model.alignment_heads == [(1, 0), (1, 1)]


@pytest.mark.parametrize("name", ["tiny", "turbo"])
def test_set_alignment_heads(name):
    """A published dump gives the JAX package's list (both only read the
    model's dims)."""
    dims = MODEL_DIMS[name]
    mine, ref = SimpleNamespace(dims=dims), SimpleNamespace(dims=dims)
    whisper_tpu_torch.Whisper.set_alignment_heads(mine, ALIGNMENT_HEADS[name])
    JaxWhisper.set_alignment_heads(ref, ALIGNMENT_HEADS[name])
    assert mine.alignment_heads == ref.alignment_heads and len(mine.alignment_heads) > 0


def test_set_alignment_heads_on_the_model(port):
    mask = np.array([[False, True], [True, False]])
    dump = base64.b85encode(gzip.compress(mask.tobytes()))
    model = copy.copy(port)
    model.set_alignment_heads(dump)
    assert model.alignment_heads == [(0, 1), (1, 0)]


@pytest.mark.parametrize("num_frames", [3000, 1102])
def test_alignment_cost_matrix(num_frames):
    """Within 1e-5 of the JAX graph, including a reflect boundary that is
    not the array's edge (num_frames < 3000), on the valid rows and
    columns (tests/test_timing_ops.py:112-144)."""
    rng = np.random.RandomState(5)
    Hn, P, F, n = 6, 64, 1500, 39
    fv = num_frames // 2
    align = (rng.randn(Hn, P, F) * 2.0).astype(np.float32)
    want = jg._alignment_cost_matrix(
        jnp.asarray(align), jnp.int32(n), jnp.int32(fv), jnp.float32(1.0), 7
    )
    got = tg.alignment_cost_matrix(torch.from_numpy(align), n, fv, 1.0, 7)
    assert got.shape == (P, F)
    _close(got[:n, :fv], np.asarray(want)[:n, :fv], rtol=0, atol=1e-5)


def test_prefill_with_alignment(tpu_model, port, cross, replay_tokens):
    jck, jcv, tck, tcv = cross
    _, _, tokens = replay_tokens
    n = tokens.shape[1]
    jh, jkv, jal = tpu_model.prefill_align(tokens, n, jck, jcv)
    th, tkv, tal = tg.prefill_with_alignment(
        port.params["decoder"], torch.from_numpy(tokens), n, tck, tcv, n_head=2,
        alignment_heads=tuple(port.alignment_heads),
    )  # fmt: skip
    assert tal.dtype == torch.float32 and tuple(tal.shape) == (2, n, 1500)
    _close(th, np.asarray(jh)[:, :n])
    _close(tkv, np.asarray(jkv)[:, :, :, :n])
    _close(tal, np.asarray(jal)[:, :n])


@pytest.mark.parametrize("num_frames", [3000, 1102])
def test_alignment_outputs(tpu_model, port, cross, replay_tokens, num_frames):
    jck, jcv, tck, tcv = cross
    tok, text, tokens = replay_tokens
    n, sot_len = tokens.shape[1], len(tok.sot_sequence)
    row_ids = np.zeros(jg.PREFILL_LEN, np.int32)
    row_ids[sot_len : sot_len + len(text)] = text
    jp, jm = tpu_model.alignment_replay(tokens, n, jck, jcv, row_ids, num_frames, tok.eot)
    tp, tm = port.alignment_replay(tokens, n, tck, tcv, row_ids[:n], num_frames, tok.eot)
    assert tuple(tp.shape) == (n,) and tuple(tm.shape) == (n, 1500)
    _close(tp, np.asarray(jp)[:n])
    fv = num_frames // 2
    _close(tm[:n, :fv], np.asarray(jm)[:n, :fv])


def _assert_same_words(mine, ref):
    assert [w.word for w in mine] == [w.word for w in ref]
    assert [w.tokens for w in mine] == [w.tokens for w in ref]
    for a, b in zip(mine, ref):
        assert abs(a.start - b.start) < 1e-6 and abs(a.end - b.end) < 1e-6
        assert abs(a.probability - b.probability) < 1e-5


@pytest.mark.parametrize("num_frames", [3000, 1102])
def test_find_alignment(tpu_model, port, cross, num_frames):
    jck, jcv, tck, tcv = cross
    tok = get_tokenizer(True, language="en", task="transcribe")
    jtok = jax_tokenizer(True, language="en", task="transcribe")
    text = tok.encode(TEXT)
    assert text == jtok.encode(TEXT)
    ref = jtiming.find_alignment(tpu_model, jtok, text, num_frames, jck, jcv)
    mine = ttiming.find_alignment(port, tok, text, num_frames, tck, tcv)
    assert len(mine) == len(TEXT.split()) + 1  # the words, then EOT's
    _assert_same_words(mine, ref)
    assert ttiming.find_alignment(port, tok, [], num_frames, tck, tcv) == []


def _timings(words):
    return [(w, list(range(len(w.strip()) or 1)), s, e, 0.5) for w, s, e in words]


WORD_LISTS = [
    # opening quote and closing marks fold into their neighbours
    [(' "', 0.0, 0.1), (" Hello", 0.1, 0.5), (",", 0.5, 0.6), (" world", 0.6, 3.0),
     (".", 3.0, 5.0), (" Next", 5.0, 7.5), ("!", 7.5, 7.6), ('"', 7.6, 7.7)],
    # zero spans only: no typical span
    [(" a", 1.0, 1.0), (" b", 1.0, 1.0)],
    # an overlong word after a sentence mark, and a lone opening bracket
    [(" Go", 0.0, 0.3), ("?", 0.3, 0.4), (" Later", 0.4, 6.0), (" (", 6.0, 6.1), (" x", 6.1, 6.2)],
]  # fmt: skip


@pytest.mark.parametrize("words", WORD_LISTS, ids=["punctuation", "zero-spans", "sentence-mark"])
def test_merge_and_clamp_helpers(words):
    """merge_punctuations and the clamp and snap helpers on crafted lists:
    the port's and the JAX package's leave the same words and times."""
    mine = [ttiming.WordTiming(*w) for w in _timings(words)]
    ref = [jtiming.WordTiming(*w) for w in _timings(words)]
    tdur, jdur = ttiming._typical_and_cap_durations(mine), jtiming._typical_and_cap_durations(ref)
    assert tdur == jdur
    if tdur[2]:
        ttiming._clamp_at_sentence_marks(mine, tdur[1])
        jtiming._clamp_at_sentence_marks(ref, jdur[1])
    punct = dict(prepended="\"'“¿([{-", appended="\"'.。,，!！?？:：”)]}、")
    ttiming.merge_punctuations(mine, **punct)
    jtiming.merge_punctuations(ref, **punct)
    assert [vars(w) for w in mine] == [vars(w) for w in ref]

    as_dicts = [dict(word=w.word, start=w.start, end=w.end) for w in mine if w.word]
    tw, jw = copy.deepcopy(as_dicts), copy.deepcopy(as_dicts)
    ttiming._clamp_after_pause(tw, -10.0, tdur[0], tdur[1])
    jtiming._clamp_after_pause(jw, -10.0, jdur[0], jdur[1])
    tseg, jseg = dict(start=0.7, end=4.2), dict(start=0.7, end=4.2)
    ttiming._snap_segment_edges(tseg, tw, tdur[0])
    jtiming._snap_segment_edges(jseg, jw, jdur[0])
    assert (tw, tseg) == (jw, jseg)


def _assert_same_transcript(mine, ref):
    assert mine["text"] == ref["text"]
    assert len(mine["segments"]) == len(ref["segments"])
    for m, r in zip(mine["segments"], ref["segments"]):
        assert m["tokens"] == r["tokens"]
        for key in ("seek", "start", "end"):
            assert abs(m[key] - r[key]) < 1e-6, key
        _assert_same_word_dicts(m["words"], r["words"])


def _assert_same_word_dicts(mine, ref):
    assert [w["word"] for w in mine] == [w["word"] for w in ref]
    for a, b in zip(mine, ref):
        assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6
        assert abs(a["probability"] - b["probability"]) < 1e-5


BASE = dict(language="en", temperature=0.0, verbose=None, word_timestamps=True)


def test_transcribe_word_timestamps(tpu_model, port, jfk_audio):
    tpu_model.use_fused_decode = True
    ref = tpu_model.transcribe(jfk_audio, **BASE)
    mine = port.transcribe(jfk_audio, **BASE)
    _assert_same_transcript(mine, ref)
    assert sum(len(s["words"]) for s in mine["segments"]) > 0


def test_hallucination_silence_threshold(tpu_model, port, jfk_audio, monkeypatch):
    """jfk, 8 s of silence, jfk twice (~41 s; after
    tests/test_longform_adversarial.py:24-43). With random weights every
    word is improbable, so every segment is an anomaly and the silence pass
    culls and seeks again in every window. Each window's segments and words,
    recorded before the cull, and the final transcript are the JAX
    package's: the same seek chain, decision for decision."""
    sil = np.zeros(8 * 16000, np.float32)
    audio = np.concatenate([jfk_audio, sil, np.tile(jfk_audio, 2)]).astype(np.float32)

    def recorder(module, fn, log):
        def wrapped(**kw):
            fn(**kw)
            segs = kw["segments"]
            log.append([(s["seek"], s["tokens"], copy.deepcopy(s["words"])) for s in segs])

        monkeypatch.setattr(module, "add_word_timestamps", wrapped)

    ref_windows, my_windows = [], []
    recorder(jtranscribe, jtiming.add_word_timestamps, ref_windows)
    recorder(ttranscribe, ttiming.add_word_timestamps, my_windows)
    tpu_model.use_fused_decode = True
    kw = dict(BASE, hallucination_silence_threshold=2.0)
    ref = tpu_model.transcribe(audio, **kw)
    mine = port.transcribe(audio, **kw)
    _assert_same_transcript(mine, ref)
    assert len(my_windows) == len(ref_windows) > 2
    for m, r in zip(my_windows, ref_windows):
        assert [s[:2] for s in m] == [s[:2] for s in r]
        for (_, _, mw), (_, _, rw) in zip(m, r):
            _assert_same_word_dicts(mw, rw)
    assert sum(len(w) for win in my_windows for _, _, w in win) > 10
