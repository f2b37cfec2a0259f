"""The port's engine-level tools (whisper_tpu_torch/spec_bench.py,
graph_bench.py, trace_ops.py) against the JAX package's modules and the
formulas of the tools/ of those names, float32 on the CPU with the
synthetic checkpoint as the target and a 1-layer, 64-wide draft (its
weights carried into the JAX package). The JAX tools are not imported (at
import they point JAX's compile cache into the repo): their formulas are
restated here from their source.

- spec_bench: the brackets' keywords are the JAX tool's; accept1 at K = 4
  accepts every draft (acceptance 1.0) and gives the JAX
  SpeculativeEngine's tokens; accept0 gives the plain engine's tokens, the
  port's and the JAX FusedEngine's;
- graph_bench: the analytic floors equal the JAX tool's formula over the
  JAX model's parameter bytes; the roofline arithmetic equals the tool's
  on fixed inputs; the FLOP counter counts the card's out_dtype products
  (on the meta device); the bare step loop gives the plain step loop's
  tokens; a run at tiny dims has every graph's row;
- trace_ops: the categories of listed kernel and op names; a --device cpu
  frontend run yields rows.

Tolerances: tokens and counts exactly; floors in bytes exactly; the
roofline arithmetic to 1e-12 relative."""

import json

import jax
import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.engine_fused import FusedEngine as JaxFusedEngine
from whisper_tpu.frontend import encode_clip as jax_encode_clip
from whisper_tpu.models import Whisper as JaxWhisper
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu.speculative import SpeculativeEngine as JaxSpeculativeEngine
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu_torch import graph_bench, spec_bench, trace_ops
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.params import map_tree
from whisper_tpu_torch.models.whisper import Whisper

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

DRAFT = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1,
)  # fmt: skip
SAMPLE_LEN = 21  # the tool's 96 cut for the CPU: 20 tokens after the first are 4 whole rounds at K = 4


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def draft():
    return Whisper(ModelDimensions(**DRAFT), None, name="draft", device="cpu", compute_dtype=torch.float32, seed=1)


def _to_jax(model):
    dims = JaxDims(**model.dims.__dict__)
    return JaxWhisper(dims, params=map_tree(model.params, lambda _, v: v.numpy()), compute_dtype="float32")


def _jax_brackets(tok, V, sample_len):
    # tools/spec_bench.py's base / accept_all / accept_none
    one_tok = tok.encode(" and")[0]
    base = dict(
        sot_index=0, blank_ids=tok.encode(" ") + [tok.eot], max_initial_ts_index=50, sample_len=sample_len,
        use_timestamps=False, temperature=0.0, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
    )  # fmt: skip
    return dict(base, suppress_ids=[i for i in range(V) if i != one_tok]), dict(base, suppress_ids=[tok.eot])


# ---- spec_bench ---------------------------------------------------------------


@pytest.fixture(scope="module")
def spec_out(torch_model, draft):
    mp = pytest.MonkeyPatch()
    mp.setattr(spec_bench, "SAMPLE_LEN", SAMPLE_LEN)
    try:
        return spec_bench.run(torch_model, draft, ks=(4,), trials=1)
    finally:
        mp.undo()


def test_spec_brackets_are_the_tools(torch_model):
    from whisper_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(True, language="en", task="transcribe")
    got = spec_bench.bracket_kwargs(tok, 51865, 96)
    want1, want0 = _jax_brackets(jax_get_tokenizer(True, language="en", task="transcribe"), 51865, 96)
    assert got["accept1"] == want1 and got["accept0"] == want0
    audio = spec_bench.clip_audio(2)
    i16 = (np.random.RandomState(0).randn(2 * 480000) * 3000).astype(np.int16)
    assert np.array_equal(audio, i16.astype(np.float32) / 32768.0)


def test_spec_records_have_the_tools_keys(spec_out):
    keys = {"engine", "bracket", "K", "p50_decode_s", "tokens", "tokens_per_s", "vs_fused",
            "measured_acceptance", "frontend_s"}  # fmt: skip
    recs = spec_out["records"]
    assert [(r["engine"], r["bracket"], r["K"]) for r in recs] == [
        ("fused_greedy", "accept1", None), ("fused_greedy", "accept0", None),
        ("speculative", "accept1", 4), ("speculative", "accept0", 4),
    ]  # fmt: skip
    for r in recs:
        assert keys <= set(r) and r["tokens"] == 2 * SAMPLE_LEN
        json.dumps(r)


def test_spec_accept1_accepts_every_draft_as_jax(tpu_model, torch_model, draft, spec_out):
    """The upper bracket: acceptance 1.0, every round K + 1 tokens, and the
    JAX SpeculativeEngine's tokens on the same clip and draft weights."""
    rec = spec_out["records"][2]
    assert rec["measured_acceptance"] == 1.0 and rec["all_accepted"] is True
    assert rec["rounds"] == [(SAMPLE_LEN - 1) // 5] * 2
    jax_draft = _to_jax(draft)
    tok = jax_get_tokenizer(True, language="en", task="transcribe")
    accept1, _ = _jax_brackets(tok, 51865, SAMPLE_LEN)
    audio = spec_bench.clip_audio(2)
    jck, jcv, n = jax_encode_clip(tpu_model, audio)
    jdck, jdcv, _ = jax_encode_clip(jax_draft, audio)
    assert n == 2
    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (2, 1))
    jeng = JaxSpeculativeEngine(tpu_model, jax_draft, k=4)
    want = jeng.run(initial, jck, jcv, jdck, jdcv, **accept1)
    ni = initial.shape[1]
    assert spec_out["tokens"][("speculative", "accept1", 4)] == [
        np.asarray(want[0])[a, ni : int(want[1])].tolist() for a in range(2)
    ]
    assert float(np.mean(jeng.last_stats["draft_acceptance"])) == 1.0


def test_spec_accept0_tokens_are_the_plain_engines(tpu_model, torch_model, spec_out):
    """The lower bracket: the speculative tokens equal the port's plain
    engine's and the JAX FusedEngine's."""
    rec = spec_out["records"][3]
    assert rec["tokens_equal_fused"] is True and 0.0 <= rec["measured_acceptance"] < 1.0
    tokens = spec_out["tokens"][("speculative", "accept0", 4)]
    assert tokens == spec_out["tokens"][("fused_greedy", "accept0", None)]
    tok = jax_get_tokenizer(True, language="en", task="transcribe")
    _, accept0 = _jax_brackets(tok, 51865, SAMPLE_LEN)
    jck, jcv, _ = jax_encode_clip(tpu_model, spec_bench.clip_audio(2))
    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (2, 1))
    want = JaxFusedEngine(tpu_model).run(initial, jck, jcv, n_group=1, beam_search=False, max_candidates=0,
                                         **accept0)  # fmt: skip
    ni = initial.shape[1]
    assert tokens == [np.asarray(want[0])[a, ni : int(want[1])].tolist() for a in range(2)]


# ---- graph_bench --------------------------------------------------------------


def _jax_floors(params, mel_b, xa_b, ckv_b, cache_b, kv_out_b, beam, V):
    # tools/graph_bench.py's analytic floors over the JAX model's trees
    def tree_nbytes(t):
        return sum(leaf.nbytes for leaf in jax.tree.leaves(t))

    dec_p = params["decoder"]
    blocks_w = tree_nbytes(dec_p["blocks"])
    cross_w = tree_nbytes({k: v for k, v in dec_p["blocks"].items() if k in ("cross_k_w", "cross_v_w", "cross_v_b")})
    floors = {
        "encoder": tree_nbytes(params["encoder"]) + mel_b + xa_b,
        "cross_kv": cross_w + xa_b + ckv_b,
        "prefill": blocks_w + ckv_b + kv_out_b,
        "decode_step": tree_nbytes(dec_p) + 2 * cache_b + ckv_b + beam * V * 4,
        "align_replay": blocks_w + ckv_b + kv_out_b + dec_p["tok_emb"].nbytes,
    }
    floors["decode_tok(fused)"] = floors["decode_step"]
    return floors


def test_floors_are_the_tools_on_the_jax_parameters(tpu_model, torch_model):
    args = (4 * 80 * 3000, 4 * 1500 * 128, 2 * 4 * 2 * 1500 * 128, 4 * 2 * 2 * 5 * 448 * 128, 4 * 2 * 2 * 3 * 128)
    got = graph_bench.analytic_floors(torch_model.params["encoder"], torch_model.params["decoder"], *args, 5, 51865)
    assert got == _jax_floors(tpu_model.params, *args, 5, 51865)


@pytest.mark.parametrize("steady, flops, floor", [(1e-3, 2e9, 1e8), (2.5e-2, 4e12, 3.1e8), (1e-3, 0.0, 0.0)])
def test_roofline_arithmetic_is_the_tools(steady, flops, floor):
    # tools/graph_bench.py's row, before its rounding, at the card's peaks
    peak_tflops, peak_gbs = 989.0, 3350.0
    t_mxu = flops / (peak_tflops * 1e12)
    t_hbm = floor / (peak_gbs * 1e9)
    t_sol = max(t_mxu, t_hbm)
    want = {
        "steady_ms": steady * 1e3, "gflop": flops / 1e9, "floor_mb": floor / 1e6, "mxu_bound_ms": t_mxu * 1e3,
        "hbm_bound_ms": t_hbm * 1e3, "bound": "mxu" if t_mxu >= t_hbm else "hbm",
        "pct_of_roofline": 100.0 * t_sol / steady if steady > 0 else 0.0,
    }  # fmt: skip
    got = graph_bench.roofline_row(steady, flops, floor, peak_tflops, peak_gbs)
    assert got.pop("xla_mb_accessed") is None
    assert got.keys() == want.keys() and got["bound"] == want["bound"]
    for k in want:
        if k != "bound":
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)


def test_flop_counter_counts_the_cards_products():
    """The out_dtype overloads of mm and bmm that graphs._mm_f32 runs on
    the card, on the meta device: 2 m k n a product."""
    a = torch.empty(3, 4, 5, dtype=torch.bfloat16, device="meta")
    b = torch.empty(5, 6, dtype=torch.bfloat16, device="meta")
    assert graph_bench.count_flops(lambda: graphs._mm_f32(a[0], b)) == 2 * 4 * 5 * 6
    c = torch.empty(3, 5, 6, dtype=torch.bfloat16, device="meta")
    assert graph_bench.count_flops(lambda: graphs._mm_f32(a, c)) == 3 * 2 * 4 * 5 * 6


@pytest.mark.parametrize("n_group", [1, 3])
def test_raw_step_loop_is_the_plain_step_loop(torch_model, n_group):
    """The bare loop at the engine's window gives the tokens of a loop of
    the plain decode_step (whole cache, host slot) and argmax."""
    from whisper_tpu_torch.engine import _last_window

    m = torch_model
    mel = torch.zeros((1, 80, 3000))
    ck, cv = m.cross_kv(m.encode(mel))
    _, kv = m.prefill(np.array([[50258, 50259, 50359]], np.int32), 3, ck, cv)
    steps = 12
    raw = graph_bench.RawStepLoop(m, kv, ck, cv, n_group, steps, 3, _last_window(3, steps))
    got = raw().clone()
    again = raw().clone()
    cache = m.kv_to_cache_grouped(kv, n_group)
    toks = np.zeros(n_group, np.int32)
    src = np.arange(n_group) if n_group > 1 else None
    for i in range(steps):
        logits, cache = m.decode_step(toks, 3 + i, cache, src, ck, cv)
        toks = logits.argmax(-1).numpy().astype(np.int32)
    assert got.tolist() == again.tolist() == toks.tolist()


def test_graph_bench_run_has_every_row(torch_model):
    out = graph_bench.run(torch_model, beam=2, trials=1, steps=6)
    names = ["encoder", "cross_kv", "prefill", "decode_step", "fused_decode[6 steps]", "raw_step_loop[6 steps]",
             "align_replay"]  # fmt: skip
    assert list(out["timings"]) == names
    assert set(out["roofline"]) == {"encoder", "cross_kv", "prefill", "decode_step", "align_replay",
                                    "decode_tok(fused)"}  # fmt: skip
    for name, row in out["roofline"].items():
        assert row["gflop"] > 0 and row["floor_mb"] > 0 and row["xla_mb_accessed"] is None, name
    assert out["card"] is None and out["kernel_build_s"] is None and out["device"] == "cpu"
    assert out["peaks"] == {"tflops": 989.0, "gbs": 3350.0}
    json.dumps(out)


# ---- trace_ops ----------------------------------------------------------------


@pytest.mark.parametrize("name, cat", [
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_align8>", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "gemm"),
    ("nvjet_tst_128x64_64x8_1x1_v_bz_coopA_NNT", "gemm"),
    ("void greedy_argmax_kernel<true, 1, 16>(float const*, int const*)", "repo kernels (csrc)"),
    ("void beam_update_kernel<(StateMode)2>(float const*, int const*)", "repo kernels (csrc)"),
    ("void median_filter_kernel<7, false>(float const*, float*, int, int)", "repo kernels (csrc)"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 11, false, false>", "attention and softmax"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float>", "attention and softmax"),
    ("Memcpy HtoD (Pageable -> Device)", "copy and memset"),
    ("Memset (Device)", "copy and memset"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda", "copy and memset"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::BFloat16>>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::ArgMaxOps<float>>>", "reduction"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float, true>", "other"),
    ("aten::bmm", "gemm"),
    ("aten::addmm", "gemm"),
    ("aten::_softmax", "attention and softmax"),
    ("aten::copy_", "copy and memset"),
    ("aten::add", "elementwise"),
    ("aten::amax", "reduction"),
    ("aten::native_layer_norm", "other"),
])  # fmt: skip
def test_trace_categories(name, cat):
    assert trace_ops.category(name) == cat


def test_trace_frontend_on_the_cpu_yields_rows(torch_model, capsys):
    out = trace_ops.run(torch_model, 1, "frontend")
    assert out["rows_from"] == "cpu aten ops (self time)" and out["device_ops"] == 0
    assert out["total_ms_per_iter"] > 0 and out["top_ops"]
    assert out["by_category_ms_per_iter"]["gemm"] > 0
    assert abs(sum(out["by_category_ms_per_iter"].values()) - out["total_ms_per_iter"]) < 1e-6
    assert trace_ops.main(["synthetic", "1", "--what", "frontend", "--device", "cpu"], model=torch_model) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["what"] == "frontend"
