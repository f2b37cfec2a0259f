"""The port's speculative greedy decoding (whisper_tpu_torch/speculative.py,
graphs.decode_chunk, the per-row form of the update filters) against the
JAX package's (whisper_tpu/speculative.py, graphs.decode_chunk,
engine_fused._apply_filters with a per-row n_tokens), and the JAX package's
contract (tests/test_speculative.py, tests/test_continuous.py's draft case)
held in the port: for any draft the tokens are those of the port's plain
greedy engine. float32 on the CPU, the synthetic checkpoint, mel from
RandomState(7).

Tolerances: filtered logits exactly; log-probabilities 1e-5; decode_chunk
logits and cache 1e-5 (measured 7.7e-7), and 5e-3 on int8 weights, where a
1-ulp float32 difference of an activation can round it to the other bf16
neighbour before the product (measured 1.95e-3 on one row); engine
sum_logprobs 2e-3 and no_speech 1e-5, the JAX tests' tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.engine_fused import FusedConfig, _apply_filters
from whisper_tpu.models import Whisper as JaxWhisper
from whisper_tpu.models import graphs as jg
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu.quant import quantize_cross_kv as jax_quantize_cross_kv
from whisper_tpu.quant import quantize_decoder as jax_quantize_decoder
from whisper_tpu.speculative import SpeculativeEngine as JaxSpeculativeEngine
from whisper_tpu.tokenizer import get_tokenizer
from whisper_tpu_torch.engine import FusedEngine
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.ops import beam_kernel as bk
from whisper_tpu_torch.quant import quantize_cross_kv, quantize_decoder
from whisper_tpu_torch.speculative import SpeculativeEngine

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

V, T, EOT, TS_BEGIN, NO_TS = 51865, 448, 50257, 50364, 50363
SAMPLE_BEGIN = 3
DRAFT_DIMS = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1,
)  # fmt: skip


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(7).randn(80, 3000) * 0.6).astype(np.float32)


@pytest.fixture(scope="module")
def drafts():
    """A smaller, independently initialized draft (1 layer x 64 wide vs the
    target's 2 x 128) in the JAX package, and the port's model on its
    weights."""
    jax_draft = JaxWhisper(JaxDims(**DRAFT_DIMS), params=None, name="spec-draft", compute_dtype="float32")
    port_draft = whisper_tpu_torch.Whisper(
        ModelDimensions(**DRAFT_DIMS), params_from_jax(jax_draft.params), device="cpu",
        compute_dtype=torch.float32,
    )  # fmt: skip
    return jax_draft, port_draft


@pytest.fixture(scope="module")
def draft_model(drafts):
    return drafts[1]


def _mels(mel, n_audio):
    rng = np.random.RandomState(13)
    return np.stack([mel + 0.05 * i * rng.randn(*mel.shape).astype(np.float32) for i in range(n_audio)])


def _cross_kv(model, mels):
    return model.cross_kv(model.encode(torch.from_numpy(mels)))


def _base(tok, suppress=None, **kw):
    base = dict(
        sot_index=0, suppress_ids=suppress if suppress is not None else [tok.eot],
        blank_ids=tok.encode(" ") + [tok.eot], max_initial_ts_index=50, eot=tok.eot,
        timestamp_begin=tok.timestamp_begin, no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech, temperature=0.0,
    )  # fmt: skip
    base.update(kw)
    return base


def _run_pair(model, draft, mel, *, k, n_audio=1, suppress=None, **kw):
    """The port's plain greedy engine and its speculative engine on the same
    windows: (fused, spec, spec engine)."""
    tok = get_tokenizer(True, language="en", task="transcribe")
    mels = _mels(mel, n_audio)
    ck, cv = _cross_kv(model, mels)
    dck, dcv = _cross_kv(draft, mels)
    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (n_audio, 1))
    base = _base(tok, suppress, **kw)
    fused = FusedEngine(model).run(
        initial, ck, cv, n_group=1, beam_search=False, max_candidates=0, **base
    )
    eng = SpeculativeEngine(model, draft, k=k)
    return fused, eng.run(initial, ck, cv, dck, dcv, **base), eng


def _assert_match(fused, spec):
    n = int(fused[1])
    assert int(spec[1]) == n
    assert np.array_equal(spec[0], fused[0])  # EOT-padded to n, zeros after, in both
    np.testing.assert_allclose(spec[2], fused[2], rtol=0, atol=2e-3)
    np.testing.assert_allclose(spec[3], fused[3], rtol=0, atol=1e-5)


# ---- the per-row filters ----------------------------------------------------


def _rows_inputs(seed, use_ts):
    """Eight rows at different lengths: row 0 at sample_begin, rows with a
    timestamp pair just closed, mid pair, a timestamp in the past only, and
    timestamps past every row's length (never read)."""
    rng = np.random.RandomState(seed)
    n = np.array([SAMPLE_BEGIN, 4, 9, 17, 12, 30, 6, 22], np.int32)
    tokens = rng.randint(100, 5000, size=(len(n), T)).astype(np.int32)
    tokens[:, 40::5] = TS_BEGIN + 90
    tokens[1, 3] = TS_BEGIN + 5  # one sampled token, a timestamp
    tokens[2, 7], tokens[2, 8] = TS_BEGIN + 7, TS_BEGIN + 12  # pair just closed
    tokens[3, 16] = TS_BEGIN + 30  # mid pair
    tokens[4, 5] = TS_BEGIN + 20  # a past timestamp
    tokens[5, 10], tokens[5, 11] = TS_BEGIN + 3, TS_BEGIN + 3
    logits = rng.randn(len(n), V).astype(np.float32)
    logits[6, TS_BEGIN + 40 :] += 4.0  # the timestamp-mass rule fires
    cfg = FusedConfig(
        n_group=len(n), n_audio=1, beam_search=False, use_timestamps=use_ts, max_candidates=0,
        eot=EOT, timestamp_begin=TS_BEGIN, no_timestamps=NO_TS, no_speech=NO_TS - 1,
    )  # fmt: skip
    sup, blank = [1, 2, 3, 11, 220], [220, EOT]
    pens = bk.build_penalty_vectors(
        V, sup, blank, use_timestamps=use_ts, no_timestamps=NO_TS, timestamp_begin=TS_BEGIN,
        max_initial_ts_index=50,
    )  # fmt: skip
    masks = [np.zeros(V, bool), np.zeros(V, bool)]
    masks[0][sup], masks[1][blank] = True, True
    jax_filtered = _apply_filters(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(n), jnp.int32(SAMPLE_BEGIN),
        jnp.asarray(masks[0]), jnp.asarray(masks[1]), jnp.int32(50), cfg,
    )  # fmt: skip
    port = (
        torch.from_numpy(logits), torch.from_numpy(tokens), torch.from_numpy(n), SAMPLE_BEGIN,
        *map(torch.from_numpy, pens),
    )  # fmt: skip
    return port, dict(use_timestamps=use_ts, eot=EOT, timestamp_begin=TS_BEGIN), jax_filtered


@pytest.mark.parametrize("use_ts", [True, False], ids=["ts", "no_ts"])
def test_per_row_filters_match_jax(use_ts):
    args, kw, jax_filtered = _rows_inputs(21, use_ts)
    filtered = bk.apply_filters(*args, **kw)
    assert np.array_equal(filtered.numpy(), np.asarray(jax_filtered))
    tok, lp = bk.greedy_argmax_plain(*args, **kw)
    jf = np.asarray(jax_filtered)
    want = jf.argmax(axis=-1)
    assert np.array_equal(tok.numpy(), want)
    lse = np.log(np.exp(jf - jf.max(-1, keepdims=True)).sum(-1)) + jf.max(-1)
    np.testing.assert_allclose(lp.numpy(), jf[np.arange(len(want)), want] - lse, rtol=0, atol=1e-5)
    # each row alone, at its own scalar length, gives the same row
    logits, tokens, n = args[:3]
    for r in range(len(n)):
        one = bk.apply_filters(logits[r : r + 1], tokens[r : r + 1], int(n[r]), *args[3:], **kw)
        assert torch.equal(one[0], filtered[r])


@pytest.mark.cuda
def test_per_row_greedy_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels have no CPU mode")
    args, kw, _ = _rows_inputs(22, True)
    dev = torch.device("cuda")
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    args[2] = args[2].to(torch.int32)
    tok, lp = bk.greedy_argmax(*args, **kw)
    ptok, plp = bk.greedy_argmax_plain(*args, **kw)
    assert torch.equal(tok, ptok)
    assert (lp - plp).abs().max().item() <= 1e-5


# ---- decode_chunk -----------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_decode_chunk_matches_jax(tpu_model, torch_model, mel, int8):
    """Three rows of one audio at divergent positions, row 2 inactive: the
    logits of every row, the active rows' slots written, and row 2's cache
    and every slot outside the chunks left as they were."""
    jdec, dec = tpu_model.params["decoder"], torch_model.params["decoder"]
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel[None]))
    ck, cv = torch.from_numpy(np.asarray(jck)), torch.from_numpy(np.asarray(jcv))
    if int8:
        jdec, dec = jax_quantize_decoder(jdec), quantize_decoder(dec)
        jck, jcv = jax_quantize_cross_kv(jck, jcv)
        ck, cv = quantize_cross_kv(ck, cv)
    rng = np.random.RandomState(3)
    cache = (rng.randn(2, 2, 3, T, 128) * 0.5).astype(np.float32)
    pos = np.array([9, 5, 7], np.int32)
    active = np.array([True, True, False])
    tokens = np.array([[440, 2068, 17, 11], [5, 6, 7, 8], [100, 200, 300, 400]], np.int32)
    jl, jc = jg.decode_chunk(
        jdec, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(cache), jck, jcv, n_head=2,
        active=jnp.asarray(active),
    )  # fmt: skip
    tl, tc = graphs.decode_chunk(
        dec, torch.from_numpy(tokens), torch.from_numpy(pos), torch.from_numpy(cache.copy()),
        ck, cv, n_head=2, active=torch.from_numpy(active),
    )  # fmt: skip
    atol = 5e-3 if int8 else 1e-5
    assert tuple(tl.shape) == (3, 4, V)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=atol)
    written = np.zeros((3, T), bool)
    for b in range(2):
        written[b, pos[b] : pos[b] + 4] = True
    assert np.array_equal(tc.numpy()[:, :, ~written], cache[:, :, ~written])
    assert not np.allclose(tc.numpy()[:, :, written], cache[:, :, written])


def test_decode_chunk_of_one_matches_decode_step(torch_model, mel):
    """A chunk of width 1 at every row's position equals the step there."""
    dec = torch_model.params["decoder"]
    ck, cv = _cross_kv(torch_model, mel[None])
    cache = torch.from_numpy((np.random.RandomState(4).randn(2, 2, 2, T, 128) * 0.5).astype(np.float32))
    tokens = torch.tensor([440, 2068])
    step, step_cache = graphs.decode_step(dec, tokens, 6, cache.clone(), None, ck, cv, n_head=2)
    chunk, chunk_cache = graphs.decode_chunk(
        dec, tokens[:, None], torch.tensor([6, 6]), cache.clone(), ck, cv, n_head=2
    )
    torch.testing.assert_close(chunk[:, 0], step, rtol=0, atol=1e-5)
    torch.testing.assert_close(chunk_cache, step_cache, rtol=0, atol=1e-6)


# ---- SpeculativeEngine against the JAX package's ----------------------------


@pytest.mark.parametrize("which", ["random", "self"])
def test_spec_matches_jax_spec(tpu_model, torch_model, drafts, mel, which):
    """Tokens, n_tokens and last_stats equal to the JAX SpeculativeEngine on
    the same target and draft weights, at three audios that accept at
    different rates."""
    jax_draft, port_draft = (tpu_model, torch_model) if which == "self" else drafts
    tok = get_tokenizer(True, language="en", task="transcribe")
    mels = _mels(mel, 3)
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mels))
    jdck, jdcv = jax_draft.cross_kv(jax_draft.encode(mels))
    ck, cv = _cross_kv(torch_model, mels)
    dck, dcv = _cross_kv(port_draft, mels)
    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (3, 1))
    kw = _base(tok, sample_len=18, use_timestamps=True)
    jeng = JaxSpeculativeEngine(tpu_model, jax_draft, k=4)
    want = jeng.run(initial, jck, jcv, jdck, jdcv, **kw)
    eng = SpeculativeEngine(torch_model, port_draft, k=4)
    got = eng.run(initial, ck, cv, dck, dcv, **kw)
    assert int(got[1]) == int(want[1])
    assert np.array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=0, atol=1e-5)
    assert eng.last_stats == jeng.last_stats
    launches, draft_steps, rounds, decoded, _ = eng.history[-1]
    assert launches == draft_steps + rounds + 1  # greedy updates: drafts, verifies, step 0
    assert rounds == max(eng.last_stats["rounds"])
    assert decoded == max(eng.last_stats["emitted"]) == int(got[1]) - initial.shape[1]


# ---- the JAX package's contract, held in the port -----------------------------


def test_spec_self_draft_matches_fused(torch_model, mel):
    """draft == target: every draft is accepted; strides of K + 1 still give
    exactly the sequential greedy tokens."""
    fused, spec, _ = _run_pair(torch_model, torch_model, mel, k=4, sample_len=24, use_timestamps=True)
    _assert_match(fused, spec)


def test_spec_random_draft_matches_fused(torch_model, draft_model, mel):
    fused, spec, _ = _run_pair(torch_model, draft_model, mel, k=3, sample_len=20, use_timestamps=True)
    _assert_match(fused, spec)


def test_spec_multi_audio_divergent_rows(torch_model, draft_model, mel):
    fused, spec, _ = _run_pair(
        torch_model, draft_model, mel, k=4, n_audio=3, sample_len=18, use_timestamps=True
    )
    _assert_match(fused, spec)


def test_spec_without_timestamps(torch_model, draft_model, mel):
    fused, spec, _ = _run_pair(torch_model, draft_model, mel, k=4, sample_len=16, use_timestamps=False)
    _assert_match(fused, spec)


def test_spec_eot_mid_sequence(torch_model, mel):
    """A vocabulary of one text token and EOT, EOT blank-suppressed at the
    first position: the sequence ends mid-chunk once EOT wins, and the
    acceptance stops there as the step loop does."""
    tok = get_tokenizer(True, language="en", task="transcribe")
    for cand in (tok.encode(" and")[0], 11, 220, 1000, 5000):
        suppress = [i for i in range(V) if i not in (cand, tok.eot)]
        fused, spec, _ = _run_pair(
            torch_model, torch_model, mel, k=4, sample_len=12, use_timestamps=False,
            suppress=suppress, blank_ids=[tok.eot],
        )  # fmt: skip
        _assert_match(fused, spec)
        emitted = fused[0][0, : int(fused[1])]
        if tok.eot in emitted and emitted[-1] == tok.eot and len(emitted) > 4:
            break
    else:
        pytest.fail("no probe token produced a mid-sequence EOT")


@pytest.mark.parametrize("sample_len", [1, 3, 7])
def test_spec_short_sample_len(torch_model, draft_model, mel, sample_len):
    fused, spec, _ = _run_pair(
        torch_model, draft_model, mel, k=4, sample_len=sample_len, use_timestamps=True
    )
    _assert_match(fused, spec)


def test_spec_refusals(torch_model, draft_model):
    """Beam, T > 0, a prompt past the prefill window and a sample_len past
    448 - K - 1 raise; so does a draft of another vocabulary."""
    eng = SpeculativeEngine(torch_model, draft_model, k=4)
    kw = dict(
        sot_index=0, suppress_ids=[1], blank_ids=[1], max_initial_ts_index=50, sample_len=8,
        use_timestamps=False, eot=EOT, timestamp_begin=TS_BEGIN, no_timestamps=NO_TS,
        no_speech=NO_TS - 1,
    )  # fmt: skip
    with pytest.raises(ValueError, match="greedy-only"):
        eng.run(np.zeros((1, 3), np.int32), None, None, None, None, **kw, beam_search=True, n_group=5)
    with pytest.raises(ValueError, match="temperature 0"):
        eng.run(np.zeros((1, 3), np.int32), None, None, None, None, **kw, temperature=0.5)
    with pytest.raises(ValueError, match="prefill"):
        eng.run(np.zeros((1, graphs.PREFILL_LEN + 10), np.int32), None, None, None, None, **kw)
    with pytest.raises(ValueError, match="K - 1"):
        eng.run(np.zeros((1, 100), np.int32), None, None, None, None, **dict(kw, sample_len=348))
    other = whisper_tpu_torch.Whisper(
        ModelDimensions(**dict(DRAFT_DIMS, n_vocab=V + 1)), device="cpu", compute_dtype=torch.float32
    )
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(torch_model, other)


def test_spec_int8_runs_and_tracks_fused_int8(torch_model, draft_model, mel):
    """int8 mode quantizes both decoders and both cross-K/V; the engine is
    deterministic and shares at least 2/3 of its prefix with the int8 step
    loop (the verify chunk's products have other shapes, so a near-tie may
    flip: int8 is not a parity mode)."""
    tok = get_tokenizer(True, language="en", task="transcribe")
    ck, cv = _cross_kv(torch_model, mel[None])
    dck, dcv = _cross_kv(draft_model, mel[None])
    initial = np.array([list(tok.sot_sequence)], np.int32)
    base = _base(tok, sample_len=24, use_timestamps=True)
    fused = FusedEngine(torch_model, weights="int8").run(
        initial, ck, cv, n_group=1, beam_search=False, max_candidates=0, **base
    )
    eng = SpeculativeEngine(torch_model, draft_model, k=4, weights="int8")
    assert eng._draft._decoder_params()["tok_emb"].dtype == torch.int8
    spec, spec2 = (eng.run(initial, ck, cv, dck, dcv, **base) for _ in range(2))
    assert np.array_equal(spec[0], spec2[0]) and int(spec[1]) == int(spec2[1])
    n = min(int(fused[1]), int(spec[1]))
    a, b = fused[0][0, :n], spec[0][0, :n]
    agree = n if np.all(a == b) else int(np.argmin(a == b))
    assert agree >= (2 * n) // 3, (agree, n, a.tolist(), b.tolist())


def test_acceptance_stats(torch_model, draft_model, mel):
    """A self-draft on a three-token vocabulary accepts every proposal:
    acceptance 1.0 in ceil((emitted - 1) / (K + 1)) rounds; a random draft
    accepts fewer and takes more rounds."""
    tok = get_tokenizer(True, language="en", task="transcribe")
    ck, cv = _cross_kv(torch_model, mel[None])
    dck, dcv = _cross_kv(draft_model, mel[None])
    initial = np.array([list(tok.sot_sequence)], np.int32)
    narrow = [i for i in range(V) if i not in (100, 200, 300)]
    base = _base(tok, narrow, blank_ids=[220], max_initial_ts_index=None, sample_len=13,
                 use_timestamps=False)  # fmt: skip
    eng = SpeculativeEngine(torch_model, torch_model, k=3)
    out = eng.run(initial, ck, cv, ck, cv, **base)
    assert eng.last_stats == {"rounds": [3], "emitted": [13], "draft_acceptance": [1.0], "k": 3}
    assert int(out[1]) == initial.shape[1] + 13
    # K draft steps in the first round, K + 1 after a round that accepted all
    assert eng.history[-1][:3] == (1 + 11 + 3, 3 + 4 + 4, 3)
    eng2 = SpeculativeEngine(torch_model, draft_model, k=3)
    eng2.run(initial, ck, cv, dck, dcv, **base)
    assert eng2.last_stats["emitted"] == [13] and eng2.last_stats["rounds"][0] >= 3
    assert 0.0 <= eng2.last_stats["draft_acceptance"][0] < 1.0
