"""The port's host decode loop (use_fused_decode = False) against the JAX
package's host loop and fused engine and the port's own engine, on the
configurations of tests/test_fused.py plus two audios: equal tokens and text,
avg_logprob and no_speech_prob within 1e-4. At temperature 0.5 the host
loops draw from numpy's global stream, so with the same seed they give the
same tokens. The shared `tpu_model` fixture's flag is set with monkeypatch
only, so no test leaves it changed."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu_torch import decoding, engine
from whisper_tpu_torch.ops import beam_kernel as bk

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


@pytest.fixture
def no_update_kernels(monkeypatch):
    """The host loop must not reach the update kernels' wrappers. (The
    engine module is imported at the top of this file: imported while the
    wrappers are patched, it would bind the patched names for good.)"""

    def refuse(*args, **kwargs):
        raise AssertionError("the host loop called an update kernel's wrapper")

    for module in (bk, engine):
        monkeypatch.setattr(module, "greedy_argmax", refuse)
        monkeypatch.setattr(module, "beam_update", refuse)


def _assert_same(mine, ref):
    assert mine.tokens == ref.tokens
    assert mine.text == ref.text
    assert mine.language == ref.language
    assert abs(mine.avg_logprob - ref.avg_logprob) < 1e-4
    assert abs(mine.no_speech_prob - ref.no_speech_prob) < 1e-4


def _four_ways(tpu_model, torch_model, mels, kw, monkeypatch):
    """(port host, port engine, JAX host, JAX fused) results."""
    out = []
    for fused in (False, True):
        monkeypatch.setattr(torch_model, "use_fused_decode", fused)
        out.append(whisper_tpu_torch.decode(torch_model, mels, whisper_tpu_torch.DecodingOptions(**kw)))
    for fused in (False, True):
        monkeypatch.setattr(tpu_model, "use_fused_decode", fused, raising=False)
        out.append(whisper_tpu.decode(tpu_model, mels, whisper_tpu.DecodingOptions(**kw)))
    return out


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_host_loop_matches_engines_and_jax(tpu_model, torch_model, mel, kw, monkeypatch):
    port_host, port_engine, jax_host, jax_fused = _four_ways(
        tpu_model, torch_model, mel, kw, monkeypatch
    )
    assert len(port_host.tokens) > 0
    for other in (port_engine, jax_host, jax_fused):
        _assert_same(port_host, other)


@pytest.mark.parametrize(
    "kw",
    [dict(language="en", sample_len=20), dict(language="en", beam_size=3, sample_len=20)],
    ids=["greedy", "beam3"],
)
def test_host_loop_two_audios(tpu_model, torch_model, mel, kw, monkeypatch):
    mels = np.stack([mel, (np.random.RandomState(9).randn(80, 3000) * 0.6).astype(np.float32)])
    port_host, port_engine, jax_host, jax_fused = _four_ways(
        tpu_model, torch_model, mels, kw, monkeypatch
    )
    assert len(port_host) == 2
    for other in (port_engine, jax_host, jax_fused):
        for m, r in zip(port_host, other):
            _assert_same(m, r)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("best_of", [None, 3], ids=["single", "best_of3"])
def test_host_loop_sampling_matches_jax_host(tpu_model, torch_model, mel, seed, best_of, monkeypatch):
    kw = dict(language="en", temperature=0.5, sample_len=20, best_of=best_of)
    monkeypatch.setattr(torch_model, "use_fused_decode", False)
    monkeypatch.setattr(tpu_model, "use_fused_decode", False, raising=False)
    np.random.seed(seed)
    mine = whisper_tpu_torch.decode(torch_model, mel, whisper_tpu_torch.DecodingOptions(**kw))
    np.random.seed(seed)
    ref = whisper_tpu.decode(tpu_model, mel, whisper_tpu.DecodingOptions(**kw))
    _assert_same(mine, ref)
    assert mine.temperature == ref.temperature == 0.5


def test_host_loop_launches_no_update_kernel(torch_model, mel, no_update_kernels, monkeypatch):
    monkeypatch.setattr(torch_model, "use_fused_decode", False)
    for kw in (dict(sample_len=8), dict(beam_size=3, sample_len=8)):
        res = whisper_tpu_torch.decode(
            torch_model, mel, whisper_tpu_torch.DecodingOptions(language="en", **kw)
        )
        assert len(res.tokens) > 0
    monkeypatch.setattr(torch_model, "use_fused_decode", True)
    with pytest.raises(AssertionError, match="update kernel"):
        whisper_tpu_torch.decode(torch_model, mel, whisper_tpu_torch.DecodingOptions(language="en"))


@pytest.mark.parametrize("fused", [True, False], ids=["engine", "host"])
def test_initial_tokens_past_the_prefill_window_raise(tpu_model, torch_model, mel, fused, monkeypatch):
    """A 300-token prefix is not trimmed at the default sample_len: the
    port's loop (the engine, or the host loop's prefill) raises, as the JAX
    package does."""
    kw = dict(language="en", prefix=[220] * 300)
    monkeypatch.setattr(torch_model, "use_fused_decode", fused)
    monkeypatch.setattr(tpu_model, "use_fused_decode", True, raising=False)
    task = decoding.DecodingTask(torch_model, whisper_tpu_torch.DecodingOptions(**kw))
    assert len(task.initial_tokens) > 256 and task._can_fuse() == fused
    with pytest.raises(ValueError, match="prefill window"):
        whisper_tpu_torch.decode(torch_model, mel, whisper_tpu_torch.DecodingOptions(**kw))
    with pytest.raises(ValueError, match="prefill window"):
        whisper_tpu.decode(tpu_model, mel, whisper_tpu.DecodingOptions(**kw))


def test_kv_to_cache_grouped_matches_jax(tpu_model, torch_model):
    """Each audio's prefill K/V in slots 0..P-1 of its group's rows,
    audio-major, zeros past P: the JAX layout."""
    import jax.numpy as jnp

    L, d = torch_model.dims.n_text_layer, torch_model.dims.n_text_state
    kv = np.random.RandomState(1).randn(L, 2, 3, 7, d).astype(np.float32)
    mine = torch_model.kv_to_cache_grouped(torch.from_numpy(kv), 4)
    ref = np.asarray(tpu_model.kv_to_cache_grouped(jnp.asarray(kv), 4))
    assert tuple(mine.shape) == ref.shape == (L, 2, 12, 448, d)
    np.testing.assert_array_equal(mine.numpy(), ref)


def test_rearrange_composes_pending_reorders(torch_model):
    inf = decoding.Inference(torch_model, 3)
    inf.rearrange_kv_cache([2, 0, 1])
    inf.rearrange_kv_cache([1, 1, 0])
    np.testing.assert_array_equal(inf.pending_src, [0, 0, 2])
    inf.cleanup_caching()
    assert inf.pending_src is None and inf.cache is None and inf.text_offset == 0


@pytest.mark.parametrize("step", [0, 1], ids=["at-sample-begin", "mid-pair"])
def test_filters_match_jax_filters(step):
    """Each filter's `apply` on the same logits and history as the JAX
    filter's, on rows in every timestamp state."""
    from whisper_tpu import decoding as jdec
    from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
    from whisper_tpu_torch.tokenizer import get_tokenizer

    tok, jtok = get_tokenizer(True, language="en"), jax_tokenizer(True, language="en")
    begin = len(tok.sot_sequence)
    rng = np.random.RandomState(step)
    logits = rng.randn(4, 51865).astype(np.float32) * 3
    logits[1, tok.timestamp_begin + 20 :] += 6.0  # timestamp mass wins in row 1
    tokens = np.tile(np.array(tok.sot_sequence, np.int64), (4, 1))
    if step:
        ts = tok.timestamp_begin
        tail = np.array(
            [[ts + 3, 400, 500], [ts + 3, ts + 9, 600], [700, 800, ts + 12], [ts + 2, ts + 5, ts + 8]]
        )
        tokens = np.concatenate([tokens, tail], axis=1)
    pairs = [
        (decoding.SuppressBlank(tok, begin), jdec.SuppressBlank(jtok, begin)),
        (decoding.SuppressTokens([1, 5, 220]), jdec.SuppressTokens([1, 5, 220])),
        (decoding.ApplyTimestampRules(tok, begin, 50), jdec.ApplyTimestampRules(jtok, begin, 50)),
        (decoding.ApplyTimestampRules(tok, begin, None), jdec.ApplyTimestampRules(jtok, begin, None)),
    ]
    for mine, ref in pairs:
        a, b = logits.copy(), logits.copy()
        mine.apply(a, tokens)
        ref.apply(b, tokens)
        np.testing.assert_array_equal(a, b)


# ---- the first-timestamp cap at max_initial_timestamp=None ---------------------------

TS_BEGIN = 50364  # the multilingual vocabulary's first timestamp
LATE_TS = 1000  # a first timestamp past the engine's cap at index 448 (20 s)


@pytest.fixture(scope="module")
def late_timestamp_checkpoint(synth_checkpoint, tmp_path_factory):
    """The synthetic checkpoint with planted logits: the decoder's final
    layer norm returns a constant vector b, and timestamp LATE_TS's
    embedding is 50 b, so that every step's logits are the same and its
    largest is that timestamp's."""
    ckpt = torch.load(synth_checkpoint, map_location="cpu", weights_only=False)
    sd = ckpt["model_state_dict"]
    b = torch.from_numpy(np.random.RandomState(2).randn(sd["decoder.ln.bias"].shape[0]).astype(np.float32))
    b /= b.norm()
    sd["decoder.ln.weight"] = torch.zeros_like(sd["decoder.ln.weight"])
    sd["decoder.ln.bias"] = b
    sd["decoder.token_embedding.weight"][TS_BEGIN + LATE_TS] = 50 * b
    path = tmp_path_factory.mktemp("planted") / "late_ts.pt"
    torch.save(ckpt, path)
    return str(path)


def _first_timestamp(result):
    return result.tokens[0] - TS_BEGIN


@pytest.mark.parametrize("cap", [None, 0.0], ids=["none", "zero"])
@pytest.mark.parametrize("planted", [False, True], ids=["synthetic", "planted"])
def test_no_max_initial_timestamp_matches_jax_per_loop(
    tpu_model, torch_model, mel, late_timestamp_checkpoint, cap, planted, monkeypatch
):
    """decode(max_initial_timestamp=None), and 0, which DecodingTask reads
    as None: the port's engine equals the JAX fused engine, which caps the
    first timestamp at index 448, and the port's host loop equals the JAX
    host loop, which does not. With planted logits the cap binds: the host
    loops open on timestamp 1000, the engines on one at or below 448."""
    if planted:
        jax_model = whisper_tpu.load_model(late_timestamp_checkpoint, compute_dtype="float32")
        port_model = whisper_tpu_torch.load_model(
            late_timestamp_checkpoint, device="cpu", compute_dtype=torch.float32
        )
    else:
        jax_model, port_model = tpu_model, torch_model
    kw = dict(language="en", sample_len=8, max_initial_timestamp=cap)
    out = {}
    for fused in (True, False):
        monkeypatch.setattr(port_model, "use_fused_decode", fused)
        monkeypatch.setattr(jax_model, "use_fused_decode", fused, raising=False)
        mine = whisper_tpu_torch.decode(port_model, mel, whisper_tpu_torch.DecodingOptions(**kw))
        ref = whisper_tpu.decode(jax_model, mel, whisper_tpu.DecodingOptions(**kw))
        assert len(mine.tokens) > 0
        _assert_same(mine, ref)
        out[fused] = mine
    if planted:
        assert _first_timestamp(out[False]) == LATE_TS
        assert 0 <= _first_timestamp(out[True]) <= 448
