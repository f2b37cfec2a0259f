"""The decode loop as a program (whisper_tpu_torch/engine.py): the loop body
(the step at a cache window, the update at the loop state, the token write,
the state's advance, the done flag) that the card captures and replays, run
eagerly here on the CPU, against the JAX package's fused engine
(whisper_tpu/engine_fused.py, its bucketed while_loop phases).

(a) decode() through the body equals whisper_tpu.decode with the fused
    engine on the configurations of tests/test_fused.py that cross the
    128-slot phase or start past it, on two audios at beam 3, and with int8
    weights on the terms of tests/test_torch_quant.py (the engines' tokens
    equal, sum_logprobs within 2e-3, the finished counts equal);
(b) the body run again after every row is done changes no output;
(c) the plain update forms with device-tensor loop scalars equal the
    host-int forms, and at live = 0 write nothing;
the step at a window against the step over the whole cache; and the
engine's record of its static buffers' keys, least recently used dropped.

Tolerances: float32 decodes agree token for token, avg_logprob and
no_speech_prob within 1e-4 (the two packages sum in other orders); (b) is
bit for bit (the same arithmetic on the same buffers); (c) exact (the same
operations, the scalars only change form); the windowed step within 1e-5
of the whole-cache step (masked slots add exact zeros, in another order).
"""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu.engine_fused import FusedEngine as JaxEngine
from whisper_tpu.tokenizer import get_tokenizer
from whisper_tpu_torch import engine as eng_module
from whisper_tpu_torch.engine import FusedEngine
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.ops import beam_kernel as bk

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

EOT = 50257
INITIAL = [50258, 50259, 50359]


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(5).randn(80, 3000) * 0.6).astype(np.float32)


def _same(mine, ref):
    assert mine.tokens == ref.tokens
    assert mine.text == ref.text
    assert abs(mine.avg_logprob - ref.avg_logprob) < 1e-4
    assert abs(mine.no_speech_prob - ref.no_speech_prob) < 1e-4


# ---- (a) decode() through the body against the JAX fused engine -------------

BUCKETS = [
    dict(language="en", temperature=0.0, sample_len=135),
    dict(language="en", beam_size=2, sample_len=135),
    # sample_begin > 128: the first phase never runs
    dict(language="en", temperature=0.0, sample_len=20, prompt=" ".join(["word"] * 130)),
]


@pytest.mark.parametrize("kw", BUCKETS, ids=["greedy-cross-128", "beam2-cross-128", "prompt-starts-past-128"])
def test_body_matches_jax_fused_phases(tpu_model, torch_model, mel, kw, monkeypatch):
    monkeypatch.setattr(tpu_model, "use_fused_decode", True, raising=False)
    want = whisper_tpu.decode(tpu_model, mel, whisper_tpu.DecodingOptions(**kw))
    got = whisper_tpu_torch.decode(torch_model, mel, whisper_tpu_torch.DecodingOptions(**kw))
    _same(got, want)
    run = torch_model._fused_engine.history[-1]
    # the passes decoded, and at most DONE_LAG after every row was done
    assert run.loop == "program" and run.replays == 0
    assert run.steps - 1 <= run.bodies <= run.steps - 1 + eng_module.DONE_LAG


def test_body_two_audios_beam3(tpu_model, torch_model, monkeypatch):
    mels = (np.random.RandomState(9).randn(2, 80, 3000) * 0.6).astype(np.float32)
    kw = dict(language="en", beam_size=3, sample_len=30)
    monkeypatch.setattr(tpu_model, "use_fused_decode", True, raising=False)
    want = whisper_tpu.decode(tpu_model, mels, whisper_tpu.DecodingOptions(**kw))
    got = whisper_tpu_torch.decode(torch_model, mels, whisper_tpu_torch.DecodingOptions(**kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, w)


@pytest.fixture(scope="module")
def engine_inputs(tpu_model, mel):
    tok = get_tokenizer(tpu_model.is_multilingual, language="en", task="transcribe")
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel[None]))
    initial = np.array([list(tok.sot_sequence)], np.int32)
    return tok, (jck, jcv), initial


def _engine_kwargs(tok, sample_len, beam, **kw):
    return dict(
        dict(
            sot_index=0, suppress_ids=[tok.eot], blank_ids=tok.encode(" ") + [tok.eot],
            max_initial_ts_index=50, sample_len=sample_len, n_group=beam,
            beam_search=beam > 1, max_candidates=beam if beam > 1 else 0, use_timestamps=True,
            temperature=0.0, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
            no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
        ),
        **kw,
    )  # fmt: skip


@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
def test_body_int8_matches_jax_int8_engine(tpu_model, torch_model, engine_inputs, beam):
    """The int8 engines on the terms of tests/test_torch_quant.py (16
    tokens), after a prompt that puts the 128-slot phase edge mid-decode."""
    tok, (jck, jcv), _ = engine_inputs
    prompt = [tok.sot_prev] + tok.encode(" word") * 118
    initial = np.array([prompt + list(tok.sot_sequence)], np.int32)
    kw = _engine_kwargs(tok, 16, beam, sot_index=len(prompt))
    want = JaxEngine(tpu_model, weights="int8").run(initial, jck, jcv, **kw)
    ck, cv = (torch.from_numpy(np.array(t)) for t in (jck, jcv))
    engine = FusedEngine(torch_model, weights="int8")
    got = engine.run(initial, ck, cv, **kw)
    n = int(want[1])
    assert int(got[1]) == n > 128 > initial.shape[1]
    assert np.array_equal(got[0][:, :n], np.asarray(want[0])[:, :n])
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=2e-3)
    if beam > 1:
        assert np.array_equal(got[7], np.asarray(want[7]))  # finished counts
    steps = n - initial.shape[1]
    assert steps - 1 <= engine.history[-1].bodies <= steps - 1 + eng_module.DONE_LAG


# ---- (b) passes after every row is done change nothing ----------------------

# only EOT, " " and "," remain: on the synthetic checkpoint every row ends
# well before sample_len in each mode
EARLY_END = [EOT, 220, 11]


@pytest.mark.parametrize(
    "beam,temperature", [(1, 0.0), (5, 0.0), (1, 1.0)], ids=["greedy", "beam5", "sampled"]
)
def test_passes_after_done_change_nothing(torch_model, beam, temperature, monkeypatch):
    mels = (np.random.RandomState(5).randn(2, 80, 3000) * 0.6).astype(np.float32)
    ck, cv = torch_model.cross_kv(torch_model.encode(torch.from_numpy(mels)))
    initial = np.tile(np.array([INITIAL], np.int32), (2, 1))
    kw = dict(
        sot_index=0, suppress_ids=[i for i in range(51865) if i not in EARLY_END],
        blank_ids=[EOT], max_initial_ts_index=None, sample_len=40, n_group=beam,
        beam_search=beam > 1, max_candidates=beam if beam > 1 else 0, use_timestamps=False,
        temperature=temperature, eot=EOT, timestamp_begin=50364, no_timestamps=50363,
        no_speech=50362, rng_seed=3,
    )  # fmt: skip
    runs = []
    for lag in (0, 3, 1000):  # read the done flag of each pass at once, 3 passes late, never
        monkeypatch.setattr(eng_module, "DONE_LAG", lag)
        engine = FusedEngine(torch_model)
        runs.append((engine.run(initial, ck, cv, **kw), engine.history[-1]))
    (stop, rec_stop), *late_runs = runs
    n = int(stop[1])
    steps = n - len(INITIAL)
    assert steps < 40 - 4  # every row ended before sample_len
    assert [r.bodies for _, r in runs] == [steps - 1, steps - 1 + 3, 40 - 1]
    assert len(stop) == 8
    for late, _ in late_runs:
        assert len(late) == 8
        for a, b in zip(stop, late):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_programs_are_recorded_and_bounded(torch_model, monkeypatch):
    """Each run records its static buffers' key (audios, group, pool size,
    last window); past MAX_PROGRAMS keys the least recently used buffers
    are dropped, and a key used again is moved to the back."""
    monkeypatch.setattr(eng_module, "MAX_PROGRAMS", 2)
    mels = (np.random.RandomState(4).randn(2, 80, 3000) * 0.6).astype(np.float32)
    ck, cv = torch_model.cross_kv(torch_model.encode(torch.from_numpy(mels)))
    engine = FusedEngine(torch_model)
    kw = dict(
        sot_index=0, suppress_ids=[], blank_ids=[EOT], max_initial_ts_index=None, n_group=1,
        beam_search=False, max_candidates=0, use_timestamps=False, temperature=0.0, eot=EOT,
        timestamp_begin=50364, no_timestamps=50363, no_speech=50362,
    )  # fmt: skip
    one, two = np.array([INITIAL], np.int32), np.tile(np.array([INITIAL], np.int32), (2, 1))
    k1, v1 = ck[:, :1].contiguous(), cv[:, :1].contiguous()  # (layers, audios, ...)
    runs = [(one, k1, v1, 4), (one, k1, v1, 140), (two, ck, cv, 4), (one, k1, v1, 4)]
    for initial, k, v, sample_len in runs:
        engine.run(initial, k, v, sample_len=sample_len, **kw)
    assert [r.program for r in engine.history] == [(1, 1, 1, 128), (1, 1, 1, 256), (2, 1, 1, 128), (1, 1, 1, 128)]
    assert [key[:4] for key in engine._programs] == [(2, 1, 1, 128), (1, 1, 1, 128)]
    assert all(r.captures == r.recaptures == r.replays == 0 for r in engine.history)


# ---- (c) loop scalars as device tensors --------------------------------------

V, T, TS, EOT_SMALL = 400, 64, 300, 250
KW = dict(eot=EOT_SMALL, timestamp_begin=TS)


def _inputs(rng, B, n_tokens, sample_begin, use_ts):
    logits = torch.from_numpy(rng.randn(B, V).astype(np.float32) * 3)
    tokens = torch.from_numpy(rng.randint(0, V, (B, T)).astype(np.int32))
    if use_ts:  # some sampled timestamps, in order
        tokens[:, sample_begin:n_tokens:3] = torch.from_numpy(
            np.sort(rng.randint(TS, V, (B, len(range(sample_begin, n_tokens, 3)))), axis=1)
        ).to(torch.int32)
    sup, beg = bk.build_penalty_vectors(
        V, [1, 7, 9], [5, EOT_SMALL], use_timestamps=use_ts, no_timestamps=TS - 1,
        timestamp_begin=TS, max_initial_ts_index=20,
    )  # fmt: skip
    return logits, tokens, torch.from_numpy(sup), torch.from_numpy(beg)


def _state(n_tokens, sample_begin, step, live):
    return torch.tensor([n_tokens, sample_begin, step, live], dtype=torch.int32)


SCALARS = [(12, 3, 9), (3, 3, 0)]  # (n_tokens, sample_begin, step): mid-loop, and at sample_begin


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("use_ts", [True, False], ids=["ts", "no-ts"])
@pytest.mark.parametrize("n,sb,step", SCALARS, ids=["mid", "at-begin"])
def test_greedy_plain_tensor_scalars(B, use_ts, n, sb, step):
    rng = np.random.RandomState(B * 10 + n)
    logits, tokens, sup, beg = _inputs(rng, B, n, sb, use_ts)
    kw = dict(KW, use_timestamps=use_ts)
    want = bk.greedy_argmax_plain(logits, tokens, n, sb, sup, beg, **kw)
    st = _state(n, sb, step, 1)
    for scalars in ((st[bk.N_TOKENS], st[bk.SAMPLE_BEGIN]), (st[0:1], st[1:2])):  # 0-d and (1,)
        got = bk.greedy_argmax_plain(logits, tokens, *scalars, sup, beg, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    f_int = bk.apply_filters(logits, tokens, n, sb, sup, beg, **kw)
    f_t = bk.apply_filters(logits, tokens, st[0], st[1], sup, beg, **kw)
    assert torch.equal(f_int, f_t)
    # the loop-state wrapper on the CPU: its plain version into the outputs
    tok_out, lp_out = torch.full((B,), -7, dtype=torch.int32), torch.full((B,), 0.5)
    bk.greedy_argmax_state(logits, tokens, st, sup, beg, tok_out, lp_out, **kw)
    assert torch.equal(tok_out, want[0]) and torch.equal(lp_out, want[1])
    tok_out.fill_(-7), lp_out.fill_(0.5)
    bk.greedy_argmax_state(logits, tokens, _state(n, sb, step, 0), sup, beg, tok_out, lp_out, **kw)
    assert (tok_out == -7).all() and (lp_out == 0.5).all()


def _pools(rng, A, MC, filled):
    pool_tokens = torch.from_numpy(rng.randint(0, V, (A, MC, T + 1)).astype(np.int32))
    pool_scores = torch.from_numpy(rng.randn(A, MC).astype(np.float32))
    pool_lengths = torch.from_numpy(rng.randint(1, T, (A, MC)).astype(np.int32))
    pool_count = torch.full((A,), filled, dtype=torch.int32)
    return [pool_tokens, pool_scores, pool_lengths, pool_count]


@pytest.mark.parametrize("A,G", [(1, 5), (2, 3)])
@pytest.mark.parametrize("use_ts", [True, False], ids=["ts", "no-ts"])
@pytest.mark.parametrize("n,sb,step", SCALARS, ids=["mid", "at-begin"])
def test_beam_plain_tensor_scalars(A, G, use_ts, n, sb, step):
    rng = np.random.RandomState(A * 100 + G * 10 + n)
    logits, tokens, sup, beg = _inputs(rng, A * G, n, sb, use_ts)
    logits[:, EOT_SMALL] += 20.0  # EOT candidates on top: the pools fill
    sum_lp = torch.from_numpy(rng.randn(A * G).astype(np.float32))
    MC = G
    kw = dict(KW, n_group=G, use_timestamps=use_ts)
    pools = _pools(rng, A, MC, 1)
    want_pools = [t.clone() for t in pools]
    want = bk.beam_update_plain(logits, tokens, sum_lp, *want_pools, n, sb, step, sup, beg, **kw)
    st = _state(n, sb, step, 1)
    got_pools = [t.clone() for t in pools]
    got = bk.beam_update_plain(
        logits, tokens, sum_lp, *got_pools, st[0], st[1], st[2], sup, beg, live=st[3], **kw
    )
    for g, w in zip(list(got) + got_pools, list(want) + want_pools):
        assert torch.equal(g, w)
    if step:  # mid-loop, the boosted EOT candidates reach the pools
        assert not torch.equal(want_pools[3], pools[3])
    # live = 0: the pools stay, and the result is (tokens, identity, sum_logprobs)
    still = [t.clone() for t in pools]
    got = bk.beam_update_plain(
        logits, tokens, sum_lp, *still, st[0], st[1], st[2], sup, beg, live=torch.tensor(0), **kw
    )
    assert all(torch.equal(a, b) for a, b in zip(still, pools))
    assert torch.equal(got[0], tokens) and torch.equal(got[2], sum_lp)
    assert torch.equal(got[1], torch.arange(A * G, dtype=torch.int32))
    # the loop-state wrapper: the results into the outputs, nothing at live = 0
    outs = [torch.full_like(tokens, -3), torch.full((A * G,), -3, dtype=torch.int32), torch.full((A * G,), 0.25)]
    state_pools = [t.clone() for t in pools]
    bk.beam_update_state(logits, tokens, sum_lp, *state_pools, st, sup, beg, *outs, **kw)
    for g, w in zip(outs + state_pools, list(want) + want_pools):
        assert torch.equal(g, w)
    outs = [torch.full_like(tokens, -3), torch.full((A * G,), -3, dtype=torch.int32), torch.full((A * G,), 0.25)]
    state_pools = [t.clone() for t in pools]
    bk.beam_update_state(logits, tokens, sum_lp, *state_pools, _state(n, sb, step, 0), sup, beg, *outs, **kw)
    assert all(torch.equal(a, b) for a, b in zip(state_pools, pools))
    assert (outs[0] == -3).all() and (outs[1] == -3).all() and (outs[2] == 0.25).all()


def test_draw_is_multinomials():
    """The body's draw (no host reads) gives torch.multinomial's ids from
    the same generator state."""
    probs = torch.softmax(torch.from_numpy(np.random.RandomState(1).randn(6, 5000).astype(np.float32)) * 2, -1)
    engine = FusedEngine.__new__(FusedEngine)
    for seed in (0, 7):
        a = torch.Generator().manual_seed(seed)
        b = torch.Generator().manual_seed(seed)
        for _ in range(3):
            want = torch.multinomial(probs, 1, generator=a)[:, 0]
            assert torch.equal(engine._draw(probs, b), want)


# ---- the step at a cache window ----------------------------------------------


@pytest.mark.parametrize("W", [128, 256])
def test_windowed_step_matches_whole_cache(torch_model, W):
    """decode_step_fixed at window W (with a beam reorder) against the
    same step over all 448 slots: the logits, and the cache's first W
    slots (the ones a window writes and reorders)."""
    dec = torch_model.params["decoder"]
    dims = torch_model.dims
    rng = np.random.RandomState(W)
    B, pos = 4, W - 5
    L, d = dims.n_text_layer, dims.n_text_state
    cache = torch.from_numpy(rng.randn(L, 2, B, graphs.CACHE_SLOTS, d).astype(np.float32) * 0.3)
    H, dh = dims.n_text_head, d // dims.n_text_head
    ck = torch.from_numpy(rng.randn(L, 2, H, dh, 1500).astype(np.float32) * 0.2)
    cv = torch.from_numpy(rng.randn(L, 2, H, dh, 1500).astype(np.float32) * 0.2)
    tokens = torch.from_numpy(rng.randint(0, 50000, B).astype(np.int32))
    src = torch.tensor([1, 1, 0, 3], dtype=torch.int32)
    p = torch.tensor([pos], dtype=torch.int32)
    whole, windowed = cache.clone(), cache.clone()
    want, _ = graphs.decode_step_fixed(dec, tokens, p, whole, src, ck, cv, n_head=H)
    got, _ = graphs.decode_step_fixed(dec, tokens, p, windowed, src, ck, cv, n_head=H, window=W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(windowed[:, :, :, : pos + 1], whole[:, :, :, : pos + 1])
    assert torch.equal(windowed[:, :, :, W:], cache[:, :, :, W:])  # past the window: untouched
