"""The port's weight-only int8 decode (whisper_tpu_torch/quant.py, the int8
reads of models/graphs.py, FusedEngine's weights mode) against the JAX
package's (whisper_tpu/quant.py, graphs._dot, FusedEngine(weights="int8")),
on the synthetic checkpoint at float32 on the CPU.

Tolerances: the quantized trees are equal (int8 leaves exactly, scales
within 1 ulp). The int8 graphs round their operands to bf16 in both
packages and sum the products in float32, in other orders: measured
differences are below 2e-6 here; the bound is atol = 1e-4 (logits) and
1e-5 relative to the largest hidden value. The engines' tokens are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.engine_fused import FusedEngine as JaxEngine
from whisper_tpu.models import graphs as jg
from whisper_tpu.quant import quantize_cross_kv as jax_quantize_cross_kv
from whisper_tpu.quant import quantize_decoder as jax_quantize_decoder
from whisper_tpu.tokenizer import get_tokenizer
from whisper_tpu_torch.engine import FusedEngine
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.models.params import cast_params, params_from_jax
from whisper_tpu_torch.quant import DECODER_QUANT_KEYS, quantize_cross_kv, quantize_decoder

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(7).randn(80, 3000) * 0.6).astype(np.float32)


@pytest.fixture(scope="module")
def qtrees(tpu_model, torch_model):
    """(port quantize_decoder, JAX quantize_decoder) of the same decoder."""
    return quantize_decoder(torch_model.params["decoder"]), jax_quantize_decoder(
        tpu_model.params["decoder"]
    )


@pytest.fixture(scope="module")
def cross(tpu_model, torch_model, mel):
    """Both packages' cross-K/V of the same audio features (the JAX ones),
    so the int8 graph comparisons start from equal inputs."""
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel[None]))
    return (jck, jcv), (torch.from_numpy(np.asarray(jck)), torch.from_numpy(np.asarray(jcv)))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_quantized_equal(port, jax_leaf):
    want = params_from_jax({"x": jax_leaf})["x"]
    assert port.dtype == want.dtype
    if port.dtype == torch.int8:
        assert torch.equal(port, want)
    else:  # a scale: within one ulp
        ulp = torch.finfo(torch.float32).eps * want.abs()
        assert torch.all((port - want).abs() <= ulp)


def test_quantize_decoder_equals_jax(qtrees):
    port, jax_tree = qtrees
    p, j = dict(_flat(port)), dict(_flat(jax_tree))
    assert p.keys() == j.keys()
    quantized = [k for k in p if k.endswith("@scale")]
    assert len(quantized) == len(DECODER_QUANT_KEYS) + 1  # and the embedding
    for key in quantized:
        w = key[: -len("@scale")]
        assert p[w].dtype == torch.int8
        _assert_quantized_equal(p[w], j[w])
        _assert_quantized_equal(p[key], j[key])
    for key in set(p) - set(quantized) - {k[: -len("@scale")] for k in quantized}:
        assert torch.equal(p[key], params_from_jax({"x": j[key]})["x"]), key  # left as they were


def test_quantize_cross_kv_equals_jax(cross):
    (jck, jcv), (ck, cv) = cross
    (ck8, cks), (cv8, cvs) = quantize_cross_kv(ck, cv)
    (jck8, jcks), (jcv8, jcvs) = jax_quantize_cross_kv(jck, jcv)
    for got, want in ((ck8, jck8), (cks, jcks), (cv8, jcv8), (cvs, jcvs)):
        _assert_quantized_equal(got, want)
    assert cks.shape == ck.shape[:3] + ck.shape[4:]


def test_quantize_error_bound(torch_model):
    """Symmetric rounding: every element within half a scale, per output
    channel of a weight and per row of the embedding."""
    dec = torch_model.params["decoder"]
    q = quantize_decoder(dec)
    w, s = dec["blocks"]["mlp_fc1_w"], q["blocks"]["mlp_fc1_w@scale"]  # (L, K, N), (L, N)
    assert torch.all((w - q["blocks"]["mlp_fc1_w"] * s[:, None, :]).abs() <= s[:, None, :] / 2 + 1e-8)
    emb, es = dec["tok_emb"], q["tok_emb@scale"]
    assert torch.all((emb - q["tok_emb"] * es[:, None]).abs() <= es[:, None] / 2 + 1e-8)
    assert dec["blocks"]["mlp_fc1_w"].dtype == torch.float32  # the model's tree is untouched


def test_int8_prefill_and_logits_match_jax(tpu_model, torch_model, qtrees, cross):
    port_q, jax_q = qtrees
    (jck, jcv), (ck, cv) = cross
    H = tpu_model.dims.n_text_head
    tokens = np.array([[50258, 50259, 50359, 440, 2068, 17]])
    jh, jkv = jg.prefill(jax_q, jnp.asarray(tokens), 6, jck, jcv, n_head=H)
    h, kv = graphs.prefill(port_q, torch.from_numpy(tokens), 6, ck, cv, n_head=H)
    scale = float(np.abs(np.asarray(jh)).max())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jkv), rtol=0, atol=1e-5 * scale)
    # the int8 logits head on the same hidden state
    hid = np.asarray(jh)[0]
    np.testing.assert_allclose(
        graphs.hidden_to_logits(port_q, torch.from_numpy(hid)).numpy(),
        np.asarray(jg.hidden_to_logits(jax_q, jnp.asarray(hid))), rtol=0, atol=ATOL,
    )  # fmt: skip


def test_int8_decode_step_matches_jax(tpu_model, qtrees, cross):
    """Both packages' step on int8 weights and int8 cross-K/V, at B = 2 rows
    of one audio with different histories."""
    port_q, jax_q = qtrees
    (jck, jcv), (ck, cv) = cross
    dims = tpu_model.dims
    L, d, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    rng = np.random.RandomState(3)
    cache = (rng.randn(L, 2, 2, graphs.CACHE_SLOTS, d) * 0.5).astype(np.float32)
    tokens = np.array([440, 2068], np.int32)
    jq = jax_quantize_cross_kv(jck, jcv)
    q = quantize_cross_kv(ck, cv)
    jl, jc = jg.decode_step(
        jax_q, jnp.asarray(tokens), jnp.int32(7), jnp.asarray(cache), jnp.arange(2),
        jq[0], jq[1], n_head=H,
    )  # fmt: skip
    tl, tc = graphs.decode_step(
        port_q, torch.from_numpy(tokens), 7, torch.from_numpy(cache.copy()), None, q[0], q[1],
        n_head=H,
    )  # fmt: skip
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.numpy()[:, :, :, :8], np.asarray(jc)[:, :, :, :8], atol=1e-5)


@pytest.fixture(scope="module")
def engine_inputs(tpu_model, mel):
    tok = get_tokenizer(tpu_model.is_multilingual, language="en", task="transcribe")
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel[None]))
    initial = np.array([list(tok.sot_sequence)], np.int32)
    return tok, (jck, jcv), initial


def _engine_kwargs(tok, sample_len=12, beam=2):
    return dict(
        sot_index=0, suppress_ids=[tok.eot], blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50, sample_len=sample_len, n_group=beam,
        beam_search=beam > 1, max_candidates=beam, use_timestamps=True,
        temperature=0.0, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
    )  # fmt: skip


@pytest.mark.parametrize("beam", [1, 5], ids=["greedy", "beam5"])
def test_int8_engine_matches_jax(tpu_model, torch_model, engine_inputs, beam):
    tok, (jck, jcv), initial = engine_inputs
    kw = _engine_kwargs(tok, sample_len=16, beam=beam)
    want = JaxEngine(tpu_model, weights="int8").run(initial, jck, jcv, **kw)
    ck, cv = torch.from_numpy(np.asarray(jck)), torch.from_numpy(np.asarray(jcv))
    got = FusedEngine(torch_model, weights="int8").run(initial, ck, cv, **kw)
    n = int(want[1])
    assert int(got[1]) == n > initial.shape[1]
    assert np.array_equal(got[0][:, :n], np.asarray(want[0])[:, :n])
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=2e-3)
    if beam > 1:
        assert np.array_equal(got[7], np.asarray(want[7]))  # finished counts


def test_engine_int8_is_deterministic_and_close_to_plain(torch_model, engine_inputs):
    """Two int8 runs give the same tokens; on this short decode the int8
    engine agrees with the plain one on most tokens (a wiring fault such as
    a double scale would not)."""
    tok, (jck, jcv), initial = engine_inputs
    ck, cv = torch.from_numpy(np.asarray(jck)), torch.from_numpy(np.asarray(jcv))
    kw = _engine_kwargs(tok, sample_len=8, beam=1)
    eng = FusedEngine(torch_model, weights="int8")
    a, b = eng.run(initial, ck, cv, **kw), eng.run(initial, ck, cv, **kw)
    assert int(a[1]) == int(b[1]) and np.array_equal(a[0], b[0])
    plain = FusedEngine(torch_model).run(initial, ck, cv, **kw)
    m = min(int(a[1]), int(plain[1]))
    assert np.mean(a[0][0, :m] == plain[0][0, :m]) >= 0.75


def test_engine_int8_bf16_model(tiny_dims):
    """A bf16 model's int8 engine keeps its cache in bf16 (the layer norms
    stay f32 and must not set the dtype) and decodes beam 2."""
    model = whisper_tpu_torch.Whisper(tiny_dims, None, device="cpu", compute_dtype=torch.bfloat16)
    tok = get_tokenizer(True, language="en", task="transcribe")
    initial = np.array([list(tok.sot_sequence)], np.int32)
    L, H = tiny_dims.n_text_layer, tiny_dims.n_text_head
    ck = torch.zeros((L, 1, H, tiny_dims.n_text_state // H, tiny_dims.n_audio_ctx), dtype=torch.bfloat16)
    out = FusedEngine(model, weights="int8").run(initial, ck, ck, **_engine_kwargs(tok, 8, 2))
    assert int(out[1]) > len(tok.sot_sequence)


def test_weights_mode_is_an_argument(synth_checkpoint, torch_model, mel):
    """The mode is an argument of the engine and of load_model, which
    decode() passes to the engine it builds; an unknown mode raises; the
    plain engine reads the model's own tree and the model never holds int8
    leaves."""
    with pytest.raises(ValueError, match="weights mode"):
        FusedEngine(torch_model, weights="int4")
    with pytest.raises(ValueError, match="weights mode"):
        whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", weights="nope")
    assert FusedEngine(torch_model)._decoder_params() is torch_model.params["decoder"]
    with pytest.raises(ValueError, match="quantized"):
        cast_params({"decoder": quantize_decoder(torch_model.params["decoder"])}, torch.float32, "cpu")

    model = whisper_tpu_torch.load_model(
        synth_checkpoint, device="cpu", compute_dtype=torch.float32, weights="int8"
    )
    assert model.decode_weights == "int8"
    opts = whisper_tpu_torch.DecodingOptions(language="en", temperature=0.0, sample_len=10)
    result = whisper_tpu_torch.decode(model, mel, opts)
    eng = model._fused_engine
    assert eng.weights == "int8"
    assert eng._decoder_params()["blocks"]["attn_q_w"].dtype == torch.int8
    assert model.params["decoder"]["blocks"]["attn_q_w"].dtype == torch.float32
    assert result.tokens == whisper_tpu_torch.decode(model, mel, opts).tokens
    model.decode_weights = ""  # a new mode: decode() builds a plain engine
    whisper_tpu_torch.decode(model, mel, opts)
    assert model._fused_engine.weights == "" and model._fused_engine is not eng
