"""The port's mesh (whisper_tpu_torch/parallel/) on gloo worlds on the CPU,
the cases of tests/test_parallel.py and the mesh case of
tests/test_continuous.py: tp placement rules, dp_encode / dp_cross_kv,
the data-parallel engine (beam, indivisible batch, int8, T > 0), the
speculative engine, set_mesh under ContinuousBatcher with and without a
draft, decode() under (dp=2, sp=2, tp=2), and the word-timestamp replay
under tp = 2. Each is held against the JAX package on the synthetic
checkpoint: its single-device engines, and for the beam engine its
DataParallelEngine on the 8-device virtual mesh; and against the port's
own single-device run where the contract is port against port (T > 0
draws and int8 under sp, whose random streams and quantized trees are the
port's).

One world of 4 ranks (dp=2, tp=2) runs the file's mesh cases, and one of 8
ranks (dp=2, sp=2, tp=2) the sp cases (module-scoped fixtures); the ranks
import neither JAX nor the JAX package, and the port's single-device
references run once, in the test process. Tolerances as in the JAX tests:
encoder outputs atol 2e-5, tokens and step counts equal, sum-logprobs atol
1e-4, word times equal."""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

KW = dict(
    sot_index=0, suppress_ids=[11, 220], blank_ids=[220, 50257], max_initial_ts_index=50,
    sample_len=12, n_group=2, beam_search=True, max_candidates=2, use_timestamps=True,
    temperature=0.0, eot=50257, timestamp_begin=50365, no_timestamps=50364, no_speech=50363,
    rng_seed=0,
)  # fmt: skip
GREEDY = dict(KW, sample_len=8, n_group=1, beam_search=False, max_candidates=0)
SAMPLED = dict(GREEDY, sample_len=12, temperature=0.7, rng_seed=5)
INT8 = dict(KW, sample_len=10)
SPEC = {k: v for k, v in KW.items() if k not in ("n_group", "beam_search", "max_candidates", "rng_seed")}
SPEC_DRAFT = dict(n_audio_state=64, n_audio_head=2, n_audio_layer=1, n_text_state=64, n_text_head=2, n_text_layer=1)
COMPOSE_DRAFT = dict(SPEC_DRAFT, n_audio_head=1, n_text_head=1)
INITIAL = [[50258, 50259, 50359]]
WORDS = dict(language="en", temperature=0.0, word_timestamps=True, verbose=None)


def _mel(seed, n, scale=0.5):
    return (np.random.RandomState(seed).randn(n, 80, 3000) * scale).astype(np.float32)


def _random_ckv(seed=9, A=4, L=2, H=2, dh=64):
    rng = np.random.RandomState(seed)
    return [(rng.randn(L, A, H, dh, 1500) * 0.2).astype(np.float32) for _ in range(2)]


def _initial(A):
    return np.tile(np.array(INITIAL, np.int32), (A, 1))


def _draft_dims(base):
    return dict(base, n_vocab=51865, n_mels=80, n_audio_ctx=1500, n_text_ctx=448)


def _port_model(ckpt):
    import whisper_tpu_torch

    return whisper_tpu_torch.load_model(ckpt, device="cpu", compute_dtype=torch.float32)


def _port_draft(dims, flat):
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.params import unflatten_tree
    from whisper_tpu_torch.models.whisper import Whisper

    params = unflatten_tree((k, torch.from_numpy(v)) for k, v in flat.items())
    return Whisper(ModelDimensions(**dims), params, device="cpu", compute_dtype=torch.float32)


def _batcher(model, audio):
    from whisper_tpu_torch import ContinuousBatcher

    cb = ContinuousBatcher(model, slots=4, language="en", temperature=0.0)
    tickets = [cb.submit(audio), cb.submit(audio[16000 * 2 :])]
    cb.drain()
    return [
        {"text": r["text"], "tokens": [s["tokens"] for s in r["segments"]]}
        for r in (cb.result(t) for t in tickets)
    ]


def _words(result):
    return [(w["word"], w["start"], w["end"]) for s in result["segments"] for w in s["words"]]


def _engine_inputs(model, drafts):
    """The port's engine inputs of every case, {case: (args, keywords,
    weights mode)}, and the speculative case's (draft, args)."""
    draft = _port_draft(*drafts["spec"])
    mel5 = _mel(5, 4)
    sck, scv = model.cross_kv(model.encode(mel5))
    dck, dcv = draft.cross_kv(draft.encode(mel5))
    rck, rcv = (torch.from_numpy(t) for t in _random_ckv())
    cases = {
        "indivisible": ((_initial(3), *model.cross_kv(model.encode(_mel(7, 3)))), GREEDY, ""),
        "int8": ((_initial(4), rck, rcv), INT8, "int8"),
        "sampled": ((_initial(4), *model.cross_kv(model.encode(_mel(11, 4)))), SAMPLED, ""),
        "sp_beam": ((_initial(4), *model.cross_kv(model.encode(_mel(13, 4)))), KW, ""),
    }
    return cases, (draft, (_initial(4), sck, scv, dck, dcv))


def _world4(ckpt, jfk, drafts):
    """The (dp=2, tp=2) cases on this rank: {case: result}."""
    from whisper_tpu_torch import load_audio
    from whisper_tpu_torch.parallel import (
        DataParallelEngine, DataParallelSpeculativeEngine, dp_cross_kv, dp_encode, make_mesh,
        param_shardings, shard_params,
    )  # fmt: skip
    from whisper_tpu_torch.quant import quantize_decoder

    model = _port_model(ckpt)
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    out = {}
    dec = model.params["decoder"]
    specs = param_shardings(dec, mesh)
    qspecs = param_shardings(quantize_decoder(dec), mesh)
    local = shard_params(dec, mesh)
    out["rules"] = {
        "attn_q_w": specs["blocks"]["attn_q_w"], "attn_o_w": specs["blocks"]["attn_o_w"],
        "tok_emb": specs["tok_emb"], "attn_q_w@scale": qspecs["blocks"]["attn_q_w@scale"],
        "attn_o_w@scale": qspecs["blocks"]["attn_o_w@scale"],
        "shapes": {k: tuple(local["blocks"][k].shape) for k in ("attn_q_w", "attn_o_w", "attn_q_b")},
    }  # fmt: skip

    xa = dp_encode(model, mesh)(shard_params(model.params["encoder"], mesh), _mel(3, 4))
    ck, cv = dp_cross_kv(model, mesh)(local, xa)
    out["xa"], out["ck"], out["cv"] = xa.numpy(), ck.numpy(), cv.numpy()
    out["beam"] = DataParallelEngine(model, mesh).run(_initial(4), ck, cv, **KW)
    cases, (draft, spec_args) = _engine_inputs(model, drafts)
    for name in ("indivisible", "int8", "sampled"):
        args, kw, weights = cases[name]
        out[name] = DataParallelEngine(model, mesh, weights=weights).run(*args, **kw)
    out["spec"] = DataParallelSpeculativeEngine(model, draft, mesh, k=3).run(*spec_args, **SPEC)

    audio = load_audio(jfk)
    model.set_mesh(mesh)
    try:
        out["batcher_mesh"] = _batcher(model, audio)
        out["engine_type"] = type(model._fused_engine).__name__
        model.set_draft_model(_port_draft(*drafts["compose"]), k=4)
        out["batcher_mesh_draft"] = _batcher(model, audio)
        out["spec_engine_type"] = type(model._spec_engine).__name__
        model.set_draft_model(None)
        out["words"] = _words(model.transcribe(audio, **WORDS))
    finally:
        model.set_draft_model(None)
        model.set_mesh(None)
    return out


def _world8(ckpt, drafts):
    """The (dp=2, sp=2, tp=2) cases on this rank."""
    from whisper_tpu_torch import DecodingOptions, decode
    from whisper_tpu_torch.parallel import DataParallelEngine, DataParallelSpeculativeEngine, make_mesh

    model = _port_model(ckpt)
    mesh = make_mesh(dp=2, sp=2, tp=2, device_type="cpu")
    cases, (draft, spec_args) = _engine_inputs(model, drafts)
    out = {}
    for name in ("sp_beam", "int8"):
        args, kw, weights = cases[name]
        out[name] = DataParallelEngine(model, mesh, weights=weights).run(*args, **kw)
    out["spec"] = DataParallelSpeculativeEngine(model, draft, mesh, k=3).run(*spec_args, **SPEC)
    model.set_mesh(mesh)
    try:
        opts = DecodingOptions(language="en", temperature=0.0, sample_len=12)
        out["decode"] = [(r.tokens, r.text) for r in decode(model, _mel(9, 4, 0.6), opts)]
    finally:
        model.set_mesh(None)
    return out


def _same_everywhere(results):
    """SPMD: every rank returns the same outputs."""
    for r in results[1:]:
        for k, v in r.items():
            if isinstance(v, tuple) and any(isinstance(a, np.ndarray) for a in v):
                for a, b in zip(v, results[0][k]):
                    np.testing.assert_array_equal(a, b, err_msg=k)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, results[0][k], err_msg=k)
            else:
                assert v == results[0][k], k
    return results[0]


@pytest.fixture(scope="module")
def drafts():
    """The JAX tests' drafts (test_parallel's 2-head one, test_continuous's
    1-head one that tp = 2 keeps replicated): dims and JAX weights."""
    from whisper_tpu.models import Whisper
    from whisper_tpu.models.dims import ModelDimensions

    from whisper_tpu_torch.models.params import flatten_tree

    out = {}
    for name, base in (("spec", SPEC_DRAFT), ("compose", COMPOSE_DRAFT)):
        dims = _draft_dims(base)
        jax_draft = Whisper(ModelDimensions(**dims), params=None, name=name, compute_dtype="float32")
        out[name] = (dims, {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax_draft.params)})
        out[name + "_jax"] = jax_draft
    return out


@pytest.fixture(scope="module")
def world4(synth_checkpoint, jfk_flac_path, drafts):
    drafts4 = {k: drafts[k] for k in ("spec", "compose")}
    ranks = spawn(_world4, 4, synth_checkpoint, jfk_flac_path, drafts4, device_type="cpu")
    return _same_everywhere(ranks)


@pytest.fixture(scope="module")
def world8(synth_checkpoint, drafts):
    ranks = spawn(_world8, 8, synth_checkpoint, {"spec": drafts["spec"]}, device_type="cpu")
    return _same_everywhere(ranks)


@pytest.fixture(scope="module")
def port(synth_checkpoint, drafts, jfk_audio):
    """The port's single-device runs of the same cases, in this process."""
    from whisper_tpu_torch.engine import FusedEngine
    from whisper_tpu_torch.speculative import SpeculativeEngine

    model = _port_model(synth_checkpoint)
    cases, (draft, spec_args) = _engine_inputs(model, drafts)
    out = {
        name: FusedEngine(model, weights=weights).run(*args, **kw)
        for name, (args, kw, weights) in cases.items()
    }
    out["spec"] = SpeculativeEngine(model, draft, k=3).run(*spec_args, **SPEC)
    out["batcher"] = _batcher(model, jfk_audio)
    out["words"] = _words(model.transcribe(jfk_audio, **WORDS))
    opts = dict(language="en", temperature=0.0, sample_len=12)
    out["decode"] = [(r.tokens, r.text) for r in model.decode(_mel(9, 4, 0.6), **opts)]
    return out


def _same_run(got, want, scores=True, fcount=True):
    n = int(want[1])
    assert int(got[1]) == n
    np.testing.assert_array_equal(np.asarray(got[0])[:, :n], np.asarray(want[0])[:, :n])
    if scores:
        np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), atol=1e-4)
    if fcount:
        np.testing.assert_array_equal(np.asarray(got[7]), np.asarray(want[7]))


def test_param_shardings_tp_rules(world4, tpu_model, mesh8):
    from whisper_tpu.parallel.sharding import param_shardings, shard_params
    from whisper_tpu.quant import quantize_decoder

    rules = world4["rules"]
    sharded = shard_params(tpu_model.params["decoder"], mesh8)
    for name in ("attn_q_w", "attn_o_w"):
        assert rules[name] == tuple(sharded["blocks"][name].sharding.spec)
    assert rules["tok_emb"] == tuple(sharded["tok_emb"].sharding.spec) == ()
    qspecs = param_shardings(quantize_decoder(tpu_model.params["decoder"]), mesh8)["blocks"]
    for name in ("attn_q_w@scale", "attn_o_w@scale"):
        assert rules[name] == tuple(qspecs[name].spec)
    assert rules["shapes"] == {"attn_q_w": (2, 128, 64), "attn_o_w": (2, 64, 128), "attn_q_b": (2, 64)}


def test_dp_encode_and_cross_kv_match_jax(world4, tpu_model, mesh8):
    from whisper_tpu.parallel.serve import dp_cross_kv, dp_encode

    mel = _mel(3, 4)
    xa_ref = np.asarray(tpu_model.encode(mel))
    ck_ref, cv_ref = tpu_model.cross_kv(xa_ref)
    np.testing.assert_allclose(world4["xa"], xa_ref, atol=2e-5)
    np.testing.assert_allclose(world4["ck"], np.asarray(ck_ref), atol=2e-5)
    np.testing.assert_allclose(world4["cv"], np.asarray(cv_ref), atol=2e-5)
    xa = dp_encode(tpu_model, mesh8)(tpu_model.params["encoder"], mel)
    ck, _ = dp_cross_kv(tpu_model, mesh8)(tpu_model.params["decoder"], xa)
    np.testing.assert_allclose(world4["ck"], np.asarray(ck), atol=2e-5)


def test_dp_engine_matches_single_device_and_jax_mesh(world4, tpu_model, mesh8):
    from whisper_tpu.engine_fused import FusedEngine
    from whisper_tpu.parallel.serve import DataParallelEngine

    ck, cv = tpu_model.cross_kv(tpu_model.encode(_mel(3, 4)))
    _same_run(world4["beam"], FusedEngine(tpu_model).run(_initial(4), ck, cv, **KW))
    _same_run(world4["beam"], DataParallelEngine(tpu_model, mesh8).run(_initial(4), ck, cv, **KW))


def test_dp_engine_indivisible_batch(world4, port, tpu_model):
    """A = 3 on dp = 2: every dp rank decodes the whole batch, still over tp."""
    from whisper_tpu.engine_fused import FusedEngine

    ck, cv = tpu_model.cross_kv(tpu_model.encode(_mel(7, 3)))
    want = FusedEngine(tpu_model).run(_initial(3), ck, cv, **GREEDY)
    _same_run(world4["indivisible"], want, fcount=False)
    _same_run(world4["indivisible"], port["indivisible"], fcount=False)


def test_dp_engine_int8_matches_single_device_int8(world4, port, tpu_model):
    from whisper_tpu.engine_fused import FusedEngine

    want = FusedEngine(tpu_model, weights="int8").run(_initial(4), *_random_ckv(), **INT8)
    _same_run(world4["int8"], port["int8"], scores=False, fcount=False)
    _same_run(world4["int8"], want, scores=False, fcount=False)


def test_dp_engine_sampling_matches_single_device_port(world4, port):
    """T > 0 under dp: the whole batch's draw with the shared generator,
    so the port's single-device tokens at the same seed."""
    _same_run(world4["sampled"], port["sampled"])


def test_dp_speculative_matches_single_device(world4, port, tpu_model, drafts):
    from whisper_tpu.speculative import SpeculativeEngine

    jax_draft = drafts["spec_jax"]
    mel = _mel(5, 4)
    ck, cv = tpu_model.cross_kv(tpu_model.encode(mel))
    dck, dcv = jax_draft.cross_kv(jax_draft.encode(mel))
    want = SpeculativeEngine(tpu_model, jax_draft, k=3).run(_initial(4), ck, cv, dck, dcv, **SPEC)
    _same_run(world4["spec"], want, fcount=False)
    _same_run(world4["spec"], port["spec"], fcount=False)
    np.testing.assert_array_equal(world4["spec"][0], port["spec"][0])  # the EOT padding too


def test_set_mesh_product_surface(world4, port, tpu_model, jfk_audio):
    """set_mesh routes ContinuousBatcher (slots = 4, a multiple of dp)
    through the sharded engine, and with a 1-head draft (replicated over
    tp) through the sharded speculative engine: transcripts equal to the
    plain batcher's and to the JAX package's."""
    from whisper_tpu.continuous import ContinuousBatcher

    cb = ContinuousBatcher(tpu_model, slots=4, language="en", temperature=0.0)
    tickets = [cb.submit(jfk_audio), cb.submit(jfk_audio[16000 * 2 :])]
    cb.drain()
    jax_texts = [cb.result(t)["text"] for t in tickets]
    assert world4["engine_type"] == "DataParallelEngine"
    assert world4["spec_engine_type"] == "DataParallelSpeculativeEngine"
    for run in ("batcher_mesh", "batcher_mesh_draft"):
        assert world4[run] == port["batcher"], run
    assert [r["text"] for r in port["batcher"]] == jax_texts


def test_word_timestamps_under_tp(world4, port):
    """transcribe(word_timestamps=True) of one audio under the (dp=2, tp=2)
    mesh: dp does not split a batch of one, tp splits the heads, and the
    replay reads the gathered cross-K/V; words and times equal the plain
    port's."""
    assert world4["words"] and world4["words"] == port["words"]


def test_dp_sp_engine_matches_single_device(world8, port, tpu_model):
    """sp on the decode surface: the cross-K/V frames split over sp, the
    softmax assembled over the group."""
    from whisper_tpu.engine_fused import FusedEngine

    ck, cv = tpu_model.cross_kv(tpu_model.encode(_mel(13, 4)))
    _same_run(world8["sp_beam"], FusedEngine(tpu_model).run(_initial(4), ck, cv, **KW), fcount=False)
    _same_run(world8["sp_beam"], port["sp_beam"])


def test_dp_sp_int8_and_speculative(world8, port):
    """int8 with its per-frame scales split over sp, and the speculative
    engine with both models' frames split: the port's single-device
    tokens."""
    _same_run(world8["int8"], port["int8"], scores=False, fcount=False)
    _same_run(world8["spec"], port["spec"], fcount=False)


def test_set_mesh_tolerates_extra_axes(world8, port, tpu_model):
    """decode() under set_mesh of a (dp=2, sp=2, tp=2) mesh: the plain
    port's and the JAX package's tokens and texts."""
    from whisper_tpu.decoding import DecodingOptions, decode

    plain = decode(tpu_model, _mel(9, 4, 0.6), DecodingOptions(language="en", temperature=0.0, sample_len=12))
    assert world8["decode"] == port["decode"]
    assert [(list(r.tokens), r.text) for r in plain] == [(list(t), s) for t, s in world8["decode"]]
