"""Speculative decoding as a program (whisper_tpu_torch/speculative.py): the
round body that the card captures and replays (K + 1 draft passes, the
verify pass, the acceptance on the device), run eagerly here on the CPU,
against the JAX package's SpeculativeEngine (whisper_tpu/speculative.py,
fused_decode_spec and its two while_loops).

(a) a random draft and the target as its own draft (every round accepts),
    at K = 1 and K = 4, on three audios whose prompts make them finish at
    different lengths; runs whose n_initial + sample_len + K + 1 falls just
    under and just over 128 (the 128- and 256-slot caches); int8 weights;
(b) the body run again after every row is done changes no output;
(c) the plain per-row loop-state update (greedy_argmax_rows_state) with its
    scalars on the device equals the host-int per-row form, and at
    live = 0 writes nothing;
(d) decode_chunk at the program's fixed window against the host width;
(e) the host loop (`_run_eager`, a comparison variant) against the body.

Tolerances, those of tests/test_torch_speculative.py: tokens and
`last_stats` equal, sum_logprobs 2e-3, no_speech 1e-5; (b) and (c) bit for
bit (the same arithmetic on the same buffers; the scalars only change
form); (d) 1e-5 (masked slots add exact zeros, in another order).
"""

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.models import Whisper as JaxWhisper
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu.speculative import SpeculativeEngine as JaxSpeculativeEngine
from whisper_tpu.tokenizer import get_tokenizer
from whisper_tpu_torch import engine as eng_module
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.ops import beam_kernel as bk
from whisper_tpu_torch.speculative import SpeculativeEngine

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

V = 51865
DRAFT_DIMS = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
    n_vocab=V, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1,
)  # fmt: skip


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(True, language="en", task="transcribe")


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def drafts():
    """An independently initialized draft (1 layer x 64 wide) in the JAX
    package, and the port's model on its weights."""
    jax_draft = JaxWhisper(JaxDims(**DRAFT_DIMS), params=None, name="spec-loop-draft", compute_dtype="float32")
    port_draft = whisper_tpu_torch.Whisper(
        ModelDimensions(**DRAFT_DIMS), params_from_jax(jax_draft.params), device="cpu",
        compute_dtype=torch.float32,
    )  # fmt: skip
    return jax_draft, port_draft


@pytest.fixture(scope="module")
def mels():
    return np.stack(
        [(np.random.RandomState(20 + 7 * i).randn(80, 3000) * (0.4 + 0.3 * i)).astype(np.float32) for i in range(3)]
    )


def _pair(tpu_model, torch_model, drafts, which):
    """(JAX target, JAX draft), (port target, port draft)."""
    if which == "self":
        return (tpu_model, tpu_model), (torch_model, torch_model)
    return (tpu_model, drafts[0]), (torch_model, drafts[1])


def _port_kv(port_models, mels):
    """The port's target's and draft's cross-K/V of the same mels."""
    return [m.cross_kv(m.encode(torch.from_numpy(mels))) for m in port_models]


def _kw(tok, sample_len, use_timestamps, keep=None):
    """The engine keywords; with `keep`, every other id is suppressed."""
    suppress = [tok.eot] if keep is None else [i for i in range(V) if i not in keep]
    return dict(
        sot_index=0, suppress_ids=suppress, blank_ids=tok.encode(" ") + [tok.eot] if keep is None else [tok.eot],
        max_initial_ts_index=50 if use_timestamps else None, sample_len=sample_len,
        use_timestamps=use_timestamps, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech, temperature=0.0,
    )  # fmt: skip


def _run_both(models, mels, initial, k, kw, weights=""):
    """The JAX SpeculativeEngine's and the port's outputs on the same inputs,
    and the port's engine."""
    (jt, jd), (pt, pd) = models
    (jck, jcv), (jdck, jdcv) = (m.cross_kv(m.encode(mels)) for m in (jt, jd))
    (ck, cv), (dck, dcv) = _port_kv((pt, pd), mels)
    jeng = JaxSpeculativeEngine(jt, jd, k=k, weights=weights)
    want = jeng.run(initial, jck, jcv, jdck, jdcv, **kw)
    eng = SpeculativeEngine(pt, pd, k=k, weights=weights)
    got = eng.run(initial, ck, cv, dck, dcv, **kw)
    return want, jeng, got, eng


def _assert_match(got, want, eng, jeng):
    n = int(want[1])
    assert int(got[1]) == n
    assert np.array_equal(got[0], np.asarray(want[0]))  # EOT-padded to n, zeros after, in both
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=0, atol=1e-5)
    assert eng.last_stats == jeng.last_stats
    run = eng.history[-1]
    assert run.loop == "program" and run.replays == 0 and run.captures == 0
    # one body pass a round, and at most DONE_LAG after the finish
    assert max(eng.last_stats["rounds"]) == run.rounds <= run.bodies <= run.rounds + eng_module.DONE_LAG
    assert run.launches == 1 + (run.k + 2) * run.bodies


# ---- (a) the body against fused_decode_spec -----------------------------------

# only EOT, " " and "," remain: under these three prompts the synthetic
# checkpoint ends its rows at three lengths (3, 5 and 10 tokens decoded)
EARLY_KEEP = (50257, 220, 11)


def _early_prompts(tok):
    return np.array(
        [[tok.sot, tok.sot + 4, tok.transcribe], [tok.sot, tok.sot + 1, tok.transcribe],
         [tok.sot, tok.sot + 5, tok.translate]], np.int32,
    )  # fmt: skip


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("which", ["random", "self"])
def test_body_matches_jax_spec_rows_finish_apart(tpu_model, torch_model, drafts, mels, tok, which, k):
    models = _pair(tpu_model, torch_model, drafts, which)
    kw = _kw(tok, 30, False, keep=EARLY_KEEP)
    want, jeng, got, eng = _run_both(models, mels, _early_prompts(tok), k, kw)
    _assert_match(got, want, eng, jeng)
    emitted = eng.last_stats["emitted"]
    assert len(set(emitted)) == 3 and max(emitted) < 30  # three rows, three finishes, all early


@pytest.mark.parametrize("which", ["random", "self"])
def test_body_matches_jax_spec_with_timestamps(tpu_model, torch_model, drafts, mels, tok, which):
    """Timestamp rules, 24 tokens, every row to the limit."""
    models = _pair(tpu_model, torch_model, drafts, which)
    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (3, 1))
    want, jeng, got, eng = _run_both(models, mels, initial, 4, _kw(tok, 24, True))
    _assert_match(got, want, eng, jeng)
    assert eng.history[-1].program == (3, 4, 128)


@pytest.mark.parametrize("over", [False, True], ids=["128-slots", "256-slots"])
def test_body_matches_jax_spec_at_window_edge(tpu_model, torch_model, drafts, mels, tok, over):
    """n_initial + sample_len + K + 1 = 128 (the 128-slot cache, full to its
    last slot) and 129 (the 256-slot one), behind a prompt."""
    models = _pair(tpu_model, torch_model, drafts, "random")
    k, sample_len = 4, 16
    n_prompt = 128 - sample_len - k - 1 - len(tok.sot_sequence) - 1 + int(over)
    prompt = [tok.sot_prev] + tok.encode(" word") * n_prompt
    initial = np.array([prompt + list(tok.sot_sequence)] * 2, np.int32)
    assert initial.shape[1] + sample_len + k + 1 == 128 + int(over)
    kw = dict(_kw(tok, sample_len, True), sot_index=len(prompt))
    want, jeng, got, eng = _run_both(models, mels[:2], initial, k, kw)
    _assert_match(got, want, eng, jeng)
    assert eng.history[-1].program == (2, k, 256 if over else 128)
    assert int(got[1]) == initial.shape[1] + sample_len  # every row to the limit


def test_body_int8_matches_jax_int8_spec(tpu_model, torch_model, drafts, mels, tok):
    """int8 weights on both decoders and both cross-K/V, on the terms of
    tests/test_torch_speculative.py (16 tokens; the engines' products are
    the JAX package's int8 products)."""
    models = _pair(tpu_model, torch_model, drafts, "random")
    initial = np.array([list(tok.sot_sequence)], np.int32)
    want, jeng, got, eng = _run_both(models, mels[:1], initial, 4, _kw(tok, 16, True), weights="int8")
    assert eng._draft._decoder_params()["tok_emb"].dtype == torch.int8
    _assert_match(got, want, eng, jeng)


# ---- (b) passes after every row is done change nothing ------------------------


def _buffers(p):
    return {k: v.clone() for k, v in vars(p).items() if isinstance(v, torch.Tensor)}


def test_passes_after_done_change_nothing(torch_model, drafts, mels, tok, monkeypatch):
    """The done flag read at once, 3 passes late and never (every pass to
    the sample_len - 1 bound): the same outputs bit for bit. Then one more
    body pass on the finished program's buffers leaves every buffer as it
    was."""
    initial = _early_prompts(tok)
    kw = _kw(tok, 30, False, keep=EARLY_KEEP)
    (ck, cv), (dck, dcv) = _port_kv((torch_model, drafts[1]), mels)
    runs = []
    for lag in (0, 3, 1000):
        monkeypatch.setattr(eng_module, "DONE_LAG", lag)
        eng = SpeculativeEngine(torch_model, drafts[1], k=4)
        runs.append((eng.run(initial, ck, cv, dck, dcv, **kw), eng.history[-1], eng))
    (first, rec, eng), *late = runs
    assert [r.bodies for _, r, _ in runs] == [rec.rounds, rec.rounds + 3, 30 - 1]
    for out, r, e in late:
        assert (r.draft_steps, r.rounds) == (rec.draft_steps, rec.rounds)
        assert e.last_stats == eng.last_stats
        for a, b in zip(first, out):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    (p,) = eng._programs.values()
    before = _buffers(p)
    assert int(p.state[bk.LIVE]) == 0 and bool(p.done.all())
    with torch.inference_mode():  # the buffers are the run's, made in inference mode
        eng._round(p, dict(use_timestamps=False, eot=tok.eot, timestamp_begin=tok.timestamp_begin))
    after = _buffers(p)
    assert before.keys() == after.keys()
    for name, t in before.items():
        assert torch.equal(t, after[name]), name


# ---- (c) the plain per-row loop-state update ----------------------------------

VS, T, TS, EOT_SMALL = 400, 64, 300, 250
KW = dict(eot=EOT_SMALL, timestamp_begin=TS)


def _rows_inputs(rng, lengths, sample_begin, use_ts):
    B = len(lengths)
    logits = torch.from_numpy(rng.randn(B, VS).astype(np.float32) * 3)
    tokens = torch.from_numpy(rng.randint(0, TS, (B, T)).astype(np.int32))
    if use_ts:  # sampled timestamps in order, a pair just closed in row 1, mid pair in row 2
        tokens[:, sample_begin + 1 :: 4] = torch.from_numpy(
            np.sort(rng.randint(TS, VS, (B, len(range(sample_begin + 1, T, 4)))), axis=1)
        ).to(torch.int32)
        if B > 2:
            tokens[1, lengths[1] - 2 : lengths[1]] = TS + 30
            tokens[2, lengths[2] - 1] = TS + 40
    sup, beg = bk.build_penalty_vectors(
        VS, [1, 7, 9], [5, EOT_SMALL], use_timestamps=use_ts, no_timestamps=TS - 1,
        timestamp_begin=TS, max_initial_ts_index=20,
    )  # fmt: skip
    return logits, tokens, torch.from_numpy(sup), torch.from_numpy(beg)


# row 0 at sample_begin (the begin penalty), the others past it; the verify
# layout's repeated lengths n + j, and the draft layout's one a row
ROW_LENGTHS = [[3, 9, 14, 4, 22], [3, 4, 5, 6, 11, 12, 13, 14], [7]]


@pytest.mark.parametrize("lengths", ROW_LENGTHS, ids=["mixed", "verify", "one-row"])
@pytest.mark.parametrize("use_ts", [True, False], ids=["ts", "no-ts"])
def test_rows_state_plain_matches_host_int_form(lengths, use_ts):
    sb = 3
    rng = np.random.RandomState(len(lengths) * 7 + use_ts)
    logits, tokens, sup, beg = _rows_inputs(rng, lengths, sb, use_ts)
    kw = dict(KW, use_timestamps=use_ts)
    n_rows = torch.tensor(lengths, dtype=torch.int32)
    want = bk.greedy_argmax_plain(logits, tokens, n_rows, sb, sup, beg, **kw)
    # each row alone at its host-int length gives the same row
    for r, n in enumerate(lengths):
        one = bk.greedy_argmax_plain(logits[r : r + 1], tokens[r : r + 1], n, sb, sup, beg, **kw)
        assert torch.equal(one[0][0], want[0][r]) and torch.equal(one[1][0], want[1][r])
    B = len(lengths)
    state = torch.tensor([0, sb, 0, 1], dtype=torch.int32)
    tok_out, lp_out = torch.full((B,), -7, dtype=torch.int32), torch.full((B,), 0.5)
    got = bk.greedy_argmax_rows_state(logits, tokens, n_rows, state, sup, beg, tok_out, lp_out, **kw)
    assert got[0] is tok_out and got[1] is lp_out
    assert torch.equal(tok_out, want[0]) and torch.equal(lp_out, want[1])
    tok_out.fill_(-7), lp_out.fill_(0.5)
    state[bk.LIVE] = 0
    bk.greedy_argmax_rows_state(logits, tokens, n_rows, state, sup, beg, tok_out, lp_out, **kw)
    assert (tok_out == -7).all() and (lp_out == 0.5).all()


def test_rows_state_refuses_other_devices():
    meta = dict(device="meta")
    t = torch.empty((2, VS), **meta)
    i = torch.empty((2, T), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bk.greedy_argmax_rows_state(
            t, i, i[:, 0], torch.empty(4, dtype=torch.int32, **meta), t[0], t[0], i[:, 0], t[:, 0],
            use_timestamps=False, **KW,
        )  # fmt: skip


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", ROW_LENGTHS, ids=["mixed", "verify", "one-row"])
def test_rows_state_kernel_matches_plain(lengths):
    """The card's launch (wtt_greedy_argmax_rows_state) at the synthetic
    vocabulary against its plain version: ids equal, log-probabilities
    within 1e-5; nothing written at live = 0; one launch counted on the
    card per call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    logits, tokens, sup, beg = (t.to(dev) for t in _rows_inputs(np.random.RandomState(5), lengths, 3, True))
    n_rows = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(KW, use_timestamps=True)
    state = torch.tensor([0, 3, 0, 1], dtype=torch.int32, device=dev)
    B = len(lengths)
    outs = torch.full((B,), -7, dtype=torch.int32, device=dev), torch.full((B,), 0.5, device=dev)
    before = bk.state_launches()["greedy_argmax_rows_state"]
    tok, lp = bk.greedy_argmax_rows_state(logits, tokens, n_rows, state, sup, beg, *outs, **kw)
    ptok, plp = bk.greedy_argmax_plain(logits, tokens, n_rows, 3, sup, beg, **kw)
    assert torch.equal(tok, ptok) and (lp - plp).abs().max().item() <= 1e-5
    state[bk.LIVE] = 0
    outs[0].fill_(-7), outs[1].fill_(0.5)
    bk.greedy_argmax_rows_state(logits, tokens, n_rows, state, sup, beg, *outs, **kw)
    torch.cuda.synchronize()
    assert (outs[0] == -7).all() and (outs[1] == 0.5).all()
    assert bk.state_launches()["greedy_argmax_rows_state"] == before + 2


# ---- (d) decode_chunk at the fixed window ---------------------------------------


@pytest.mark.parametrize("K", [1, 5])
def test_decode_chunk_fixed_window_matches_host_width(torch_model, mels, K):
    """Three rows at divergent positions, row 2 inactive, in a 128-slot
    cache: the chunk at the window (the captured round's) against the chunk
    at the host's max(pos) (the eager loop's)."""
    dec = torch_model.params["decoder"]
    ck, cv = torch_model.cross_kv(torch_model.encode(torch.from_numpy(mels[:1])))
    rng = np.random.RandomState(K)
    C = 128
    cache = torch.from_numpy((rng.randn(2, 2, 3, C, 128) * 0.5).astype(np.float32))
    pos = torch.tensor([9, 5, 121 - K], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    tokens = torch.from_numpy(rng.randint(0, 50000, (3, K)).astype(np.int32))
    host, fixed = cache.clone(), cache.clone()
    want, _ = graphs.decode_chunk(dec, tokens, pos, host, ck, cv, n_head=2, active=active, width=int(pos.max()))
    got, _ = graphs.decode_chunk(dec, tokens, pos, fixed, ck, cv, n_head=2, active=active, width=C)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fixed.numpy(), host.numpy(), rtol=0, atol=1e-5)
    written = torch.zeros((3, C), dtype=torch.bool)
    for b in range(2):
        written[b, pos[b] : pos[b] + K] = True
    assert torch.equal(fixed[:, :, ~written], cache[:, :, ~written])  # row 2 and every other slot


# ---- (e) the host loop ----------------------------------------------------------


@pytest.mark.parametrize("which", ["random", "self"])
def test_eager_loop_matches_body(torch_model, drafts, mels, tok, which):
    """The host loop (eager_loop, a comparison variant that no engine runs
    on its main path), on one device: the body's tokens, sums, statistics
    and loop counts."""
    draft = torch_model if which == "self" else drafts[1]
    (ck, cv), (dck, dcv) = _port_kv((torch_model, draft), mels)
    initial = _early_prompts(tok)
    kw = _kw(tok, 30, False, keep=EARLY_KEEP)
    outs, engines = [], []
    for eager in (False, True):
        eng = SpeculativeEngine(torch_model, draft, k=4)
        eng.eager_loop = eager
        outs.append(eng.run(initial, ck, cv, dck, dcv, **kw))
        engines.append(eng)
    (body, eager), (b_eng, e_eng) = outs, engines
    assert int(eager[1]) == int(body[1])
    assert np.array_equal(eager[0], body[0])
    np.testing.assert_allclose(eager[2], body[2], rtol=0, atol=2e-3)
    assert e_eng.last_stats == b_eng.last_stats
    b_run, e_run = b_eng.history[-1], e_eng.history[-1]
    assert e_run.loop == "eager" and e_run.launches == 1 + e_run.draft_steps + e_run.rounds
    assert (e_run.draft_steps, e_run.rounds, e_run.steps) == (b_run.draft_steps, b_run.rounds, b_run.steps)
