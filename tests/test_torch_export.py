"""The port's graph export (whisper_tpu_torch/export.py, graphs.decode_step_fixed)
against the JAX package's export and graphs, on the synthetic checkpoint at
float32 on the CPU (the counterparts of tests/test_pjrt_runtime.py and
tests/test_native_pipeline.py's format tests).

The exported programs are run as torch.export.load(...).module(), flat
inputs first unflattened by the program's own call spec, the way the native
runner feeds them. Tolerances: rtol = 1e-5 with atol = 1e-5 for graph
outputs against the JAX graphs (the two CPU backends sum in other orders,
and the fixed-shape step sums its softmax over 448 masked slots where the
others stop at the position; measured differences are ~1e-6); the decode
loops' tokens exactly, their summed log-probabilities within rtol = 1e-4
(they reach ~160 in magnitude after 24 beam steps, and each step's logits
carry the ~1e-6 relative differences above)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import whisper_tpu_torch
from whisper_tpu.engine_fused import FusedConfig, _apply_filters
from whisper_tpu.engine_fused import FusedEngine as JaxEngine
from whisper_tpu.models import graphs as jg
from whisper_tpu_torch.engine import FusedEngine
from whisper_tpu_torch.export import export_graph, export_model_graphs, export_pipeline
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.ops.beam_kernel import beam_update_plain, greedy_argmax_plain

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAPHS = ("encoder", "cross_kv", "prefill", "step_greedy", "step_beam", "filters")
MODES = ("bf16", "int8")


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def pipelines(torch_model, tmp_path_factory):
    out = {}
    for weights in MODES:
        d = str(tmp_path_factory.mktemp(f"pipeline_{weights}"))
        export_pipeline(d, torch_model, weights=weights, compile=False)
        out[weights] = d
    return out


@pytest.fixture(scope="module")
def exported(pipelines):
    return {weights: _Exported(pdir) for weights, pdir in pipelines.items()}


@pytest.fixture(scope="module")
def jax_pipeline(tpu_model, tmp_path_factory):
    from whisper_tpu.export import export_pipeline as jax_export_pipeline

    d = str(tmp_path_factory.mktemp("jax_pipeline"))
    jax_export_pipeline(d, tpu_model)
    return d


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(7).randn(1, 80, 3000) * 0.6).astype(np.float32)


def _spec(pdir, name):
    with open(os.path.join(pdir, f"{name}.spec.json")) as f:
        return json.load(f)


def _manifest(pdir):
    with open(os.path.join(pdir, "pipeline.txt")) as f:
        return dict(line.rstrip("\n").split(" ", 1) for line in f)


def _program(pdir, name):
    return torch.export.load(os.path.join(pdir, f"{name}.export.pt2"))


class _Exported:
    """An export directory's programs called on flat inputs, the weights
    read from the blobs by the specs (the native runner's view)."""

    def __init__(self, pdir):
        self.pdir = pdir
        self.mods, self.specs, self.weights = {}, {}, {}
        n_dec = _spec(pdir, "cross_kv")["n_params"]
        for name in GRAPHS:
            ep = _program(pdir, name)
            self.mods[name] = (ep.module(), ep.call_spec.in_spec)
            spec = self.specs[name] = _spec(pdir, name)
            if name == "encoder":
                blob = "encoder"
            elif name == "cross_kv" or spec["n_params"] == n_dec:
                blob = "decoder"
            else:
                blob = "decoder_int8"
            self.weights[name] = _read_blob(pdir, blob, spec) if spec["n_params"] else []

    def __call__(self, name, *inputs):
        mod, in_spec = self.mods[name]
        args, kwargs = _pytree.tree_unflatten([*self.weights[name], *inputs], in_spec)
        out = mod(*args, **kwargs)
        return out if isinstance(out, (tuple, list)) else (out,)


def _read_blob(pdir, blob, spec):
    raw = open(os.path.join(pdir, f"{blob}.params.bin"), "rb").read()
    out, off = [], 0
    for s in spec["inputs"][: spec["n_params"]]:
        dtype = getattr(torch, s["dtype"])
        n = int(np.prod(s["shape"], dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        out.append(torch.frombuffer(bytearray(raw[off : off + n]), dtype=dtype).reshape(s["shape"]))
        off += n
    assert off == len(raw), blob
    return out


# ---- export_graph / export_model_graphs (test_pjrt_runtime.py) ---------------


def test_export_graph_format(tmp_path):
    spec = export_graph(str(tmp_path), lambda a: a * 2.0 + 1.0, (torch.zeros(4, 8),), name="double")
    assert (tmp_path / "double.export.pt2").exists()
    loaded = json.loads((tmp_path / "double.spec.json").read_text())
    assert loaded["inputs"] == [{"shape": [4, 8], "dtype": "float32", "scalar_type": 6}]
    assert loaded["outputs"][0]["dtype"] == "float32"
    assert loaded["outputs"][0]["nbytes"] == 4 * 8 * 4
    assert spec["inputs"] == loaded["inputs"]
    txt = (tmp_path / "double.spec.txt").read_text().splitlines()
    assert txt == [
        "graph double", "n_params 0", "n_inputs 1", "input 6 float32 2 4 8",
        "n_outputs 1", "output 6 float32 128 2 4 8",
    ]  # fmt: skip


def test_export_model_graphs(tmp_path, tpu_model, torch_model, mel):
    export_model_graphs(str(tmp_path), torch_model)
    for name in ("encoder", "cross_kv"):
        assert _spec(str(tmp_path), name)["n_params"] == 0
    xa = _program(str(tmp_path), "encoder").module()(torch.from_numpy(mel))
    jxa = jg.encode(tpu_model.params["encoder"], jnp.asarray(mel), n_head=2)
    np.testing.assert_allclose(xa.numpy(), np.asarray(jxa), **TOL)
    ck, cv = _program(str(tmp_path), "cross_kv").module()(torch.from_numpy(np.array(jxa)))
    jck, jcv = jg.cross_kv(tpu_model.params["decoder"], jxa, n_head=2)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), **TOL)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), **TOL)


# ---- the pipeline's files (test_native_pipeline.py) --------------------------


@pytest.mark.parametrize("weights", MODES)
def test_pipeline_files(pipelines, weights):
    pdir = pipelines[weights]
    names = [f"{g}.{ext}" for g in GRAPHS for ext in ("export.pt2", "spec.json", "spec.txt")]
    names += [
        "encoder.params.bin", "decoder.params.bin", "suppress_mask.bin", "blank_mask.bin",
        "suppress_pen.bin", "begin_pen.bin", "pipeline.txt", "multilingual.tiktoken", "timings.json",
    ]  # fmt: skip
    names += ["decoder_int8.params.bin"] if weights == "int8" else []
    for f in names:
        assert os.path.exists(os.path.join(pdir, f)), f
    assert not any(f.endswith(".aoti.pt2") for f in os.listdir(pdir))  # compile=False


@pytest.mark.parametrize("weights", MODES)
@pytest.mark.parametrize("name", GRAPHS)
def test_spec_matches_program_arity(pipelines, weights, name):
    """The spec lists exactly the exported program's inputs, unused weights
    included (cross_kv reads 3 of the decoder's leaves): the fault
    whisper_tpu/export.py:58-63 guards against is a spec out of step with
    what the compiled graph takes."""
    pdir = pipelines[weights]
    ep = _program(pdir, name)
    spec = _spec(pdir, name)
    placeholders = [n for n in ep.module().graph.nodes if n.op == "placeholder"]
    assert len(spec["inputs"]) == len(ep.graph_signature.user_inputs) == len(placeholders)
    assert ep.call_spec.in_spec.num_leaves == len(spec["inputs"])
    outputs = ep.graph_signature.user_outputs
    assert len(spec["outputs"]) == len(outputs)


@pytest.mark.parametrize("weights", MODES)
def test_params_blob_sizes(pipelines, weights):
    pdir = pipelines[weights]
    n_dec = _spec(pdir, "cross_kv")["n_params"]
    for name in GRAPHS:
        spec = _spec(pdir, name)
        if not spec["n_params"]:
            continue
        blob = "encoder" if name == "encoder" else "decoder"
        if name not in ("encoder", "cross_kv") and spec["n_params"] != n_dec:
            blob = "decoder_int8"
        total = sum(
            int(np.prod(i["shape"], dtype=np.int64)) * torch.empty((), dtype=getattr(torch, i["dtype"])).element_size()
            for i in spec["inputs"][: spec["n_params"]]
        )  # fmt: skip
        assert os.path.getsize(os.path.join(pdir, f"{blob}.params.bin")) == total, name
    assert (_spec(pdir, "prefill")["n_params"] == n_dec) == (weights == "bf16")


def test_params_blob_order_is_jax_leaves(pipelines, tpu_model):
    """The decoder blob holds the leaves in jax.tree.leaves' order: at
    float32 it is byte-equal to the JAX package's decoder blob."""
    import jax

    pdir = pipelines["bf16"]
    want = b"".join(np.asarray(l).tobytes() for l in jax.tree.leaves(tpu_model.params["decoder"]))
    assert open(os.path.join(pdir, "decoder.params.bin"), "rb").read() == want


@pytest.mark.parametrize("weights", MODES)
def test_spec_txt_roundtrip(pipelines, weights):
    pdir = pipelines[weights]
    for name in GRAPHS:
        spec = _spec(pdir, name)
        txt = open(os.path.join(pdir, f"{name}.spec.txt")).read().splitlines()
        assert txt[:2] == [f"graph {name}", f"n_params {spec['n_params']}"]
        n_inputs = int([l for l in txt if l.startswith("n_inputs")][0].split()[1])
        assert n_inputs == len(spec["inputs"])
        in_lines = [l for l in txt if l.startswith("input ")]
        for line, ispec in zip(in_lines, spec["inputs"]):
            parts = line.split()
            assert int(parts[1]) == ispec["scalar_type"]
            assert parts[2] == ispec["dtype"]
            assert int(parts[3]) == len(ispec["shape"])
            assert [int(d) for d in parts[4:]] == ispec["shape"]
        out_lines = [l for l in txt if l.startswith("output ")]
        for line, ospec in zip(out_lines, spec["outputs"]):
            parts = line.split()
            assert int(parts[3]) == ospec["nbytes"]
            assert [int(d) for d in parts[5:]] == ospec["shape"]


def test_pipeline_int8_format(pipelines):
    """weights="int8": prefill and the steps take the quantized decoder
    tree (int8 weights and their float32 scales) from its own, smaller
    blob; the encoder and cross-K/V graphs keep the model's dtype."""
    pdir = pipelines["int8"]
    for name in ("prefill", "step_greedy", "step_beam"):
        spec = _spec(pdir, name)
        dtypes = [i["dtype"] for i in spec["inputs"][: spec["n_params"]]]
        assert "int8" in dtypes and "float32" in dtypes
    for name in ("encoder", "cross_kv"):
        spec = _spec(pdir, name)
        assert all(i["dtype"] != "int8" for i in spec["inputs"][: spec["n_params"]])
    size = os.path.getsize
    assert size(os.path.join(pdir, "decoder_int8.params.bin")) < size(os.path.join(pdir, "decoder.params.bin"))


def test_manifest_equals_jax_export(pipelines, jax_pipeline):
    """The masks are byte-equal to whisper_tpu.export.export_pipeline's and
    pipeline.txt has its fields with its values; the penalty vectors are the
    ones the engine builds from those masks."""
    from whisper_tpu_torch.ops.beam_kernel import build_penalty_vectors

    for weights in MODES:
        pdir = pipelines[weights]
        for f in ("suppress_mask.bin", "blank_mask.bin"):
            assert open(os.path.join(pdir, f), "rb").read() == open(os.path.join(jax_pipeline, f), "rb").read()
        assert _manifest(pdir) == _manifest(jax_pipeline)
        m = _manifest(pdir)
        ts = int(m["timestamp_begin"])
        smask = np.fromfile(os.path.join(pdir, "suppress_mask.bin"), dtype=bool)
        bmask = np.fromfile(os.path.join(pdir, "blank_mask.bin"), dtype=bool)
        sup, beg = build_penalty_vectors(
            smask.size, np.nonzero(smask)[0], np.nonzero(bmask)[0], use_timestamps=True,
            no_timestamps=ts - 1, timestamp_begin=ts, max_initial_ts_index=50,
        )  # fmt: skip
        assert np.array_equal(np.fromfile(os.path.join(pdir, "suppress_pen.bin"), np.float32), sup)
        assert np.array_equal(np.fromfile(os.path.join(pdir, "begin_pen.bin"), np.float32), beg)


# ---- the fixed-shape step ------------------------------------------------------


@pytest.fixture(scope="module")
def step_inputs(tpu_model, mel):
    rng = np.random.RandomState(3)
    L, B, d, pos = 2, 3, 128, 9
    cache = np.zeros((L, 2, B, graphs.CACHE_SLOTS, d), np.float32)
    cache[:, :, :, :pos] = rng.randn(L, 2, B, pos, d).astype(np.float32) * 0.5
    tokens = rng.randint(0, 50000, size=B).astype(np.int32)
    src = np.array([2, 0, 0], np.int32)
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel))
    return tokens, pos, cache, src, np.asarray(jck), np.asarray(jcv)


@pytest.mark.parametrize("reorder", [False, True], ids=["no_reorder", "beam_reorder"])
def test_decode_step_fixed_matches_jax_and_eager(tpu_model, torch_model, step_inputs, reorder):
    tokens, pos, cache, src, ck, cv = step_inputs
    dec = torch_model.params["decoder"]
    jl, jc = jg.decode_step(
        tpu_model.params["decoder"], jnp.asarray(tokens), jnp.int32(pos), jnp.asarray(cache),
        jnp.asarray(src if reorder else np.arange(3, dtype=np.int32)), jnp.asarray(ck),
        jnp.asarray(cv), n_head=2,
    )  # fmt: skip
    tsrc = torch.from_numpy(src) if reorder else None
    fixed = torch.from_numpy(cache.copy())
    fl, fc = graphs.decode_step_fixed(
        dec, torch.from_numpy(tokens), torch.tensor(pos, dtype=torch.int32), fixed, tsrc,
        torch.from_numpy(ck), torch.from_numpy(cv), n_head=2,
    )  # fmt: skip
    assert fc is fixed  # written in place
    eager = torch.from_numpy(cache.copy())
    el, ec = graphs.decode_step(
        dec, torch.from_numpy(tokens), pos, eager, tsrc, torch.from_numpy(ck), torch.from_numpy(cv),
        n_head=2,
    )  # fmt: skip
    np.testing.assert_allclose(fl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(fl.numpy(), el.numpy(), **TOL)
    np.testing.assert_allclose(fc[:, :, :, : pos + 1].numpy(), np.asarray(jc)[:, :, :, : pos + 1], **TOL)
    np.testing.assert_allclose(fc[:, :, :, : pos + 1].numpy(), ec[:, :, :, : pos + 1].numpy(), **TOL)


def test_fixed_step_reads_no_host_value(torch_model, step_inputs):
    """The exported step's shapes do not depend on pos: one program serves
    every position, and tracing it reads nothing from the device (a host
    read of pos would raise under torch.export)."""
    tokens, pos, cache, src, ck, cv = step_inputs
    with torch.no_grad():
        ep = torch.export.export(
            _StepModule(torch_model.params["decoder"]),
            (torch.from_numpy(tokens), torch.tensor(pos, dtype=torch.int32),
             torch.from_numpy(cache.copy()), torch.from_numpy(src), torch.from_numpy(ck),
             torch.from_numpy(cv)),
        )  # fmt: skip
    a, b = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
    args = (torch.from_numpy(tokens), torch.from_numpy(src), torch.from_numpy(ck), torch.from_numpy(cv))
    for p in (pos, pos + 5):
        want = graphs.decode_step_fixed(
            torch_model.params["decoder"], args[0], torch.tensor(p, dtype=torch.int32), a, args[1],
            args[2], args[3], n_head=2,
        )[0]  # fmt: skip
        got = ep.module()(args[0], torch.tensor(p, dtype=torch.int32), b, *args[1:])
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


class _StepModule(torch.nn.Module):
    def __init__(self, dec):
        super().__init__()
        self.dec = dec

    def forward(self, tokens, pos, cache, src, ck, cv):
        return graphs.decode_step_fixed(self.dec, tokens, pos, cache, src, ck, cv, n_head=2)[0]


# ---- the exported prefill and filters against the JAX graphs -------------------


def test_exported_prefill_matches_jax(pipelines, exported, tpu_model, mel):
    pdir = pipelines["bf16"]
    run = exported["bf16"]
    m = _manifest(pdir)
    initial = np.array([[int(t) for t in m["initial_tokens"].split()]], np.int32)
    P = initial.shape[1]
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel))
    logits, nsp, kv = run("prefill", torch.from_numpy(initial), torch.from_numpy(np.asarray(jck)),
                          torch.from_numpy(np.asarray(jcv)))  # fmt: skip
    dec = tpu_model.params["decoder"]
    jh, jkv = jg.prefill(dec, jnp.asarray(initial), P, jck, jcv, n_head=2)
    jlogits = jg.hidden_to_logits(dec, jh)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, P - 1], **TOL)
    no_speech = int(m["timestamp_begin"]) - 2  # <|nospeech|> sits two below <|0.00|>
    jnsp = np.asarray(jnp.exp(jlogits[:, 0] - jnp.max(jlogits[:, 0], -1, keepdims=True)))
    jnsp = jnsp[:, no_speech] / jnsp.sum(-1)
    np.testing.assert_allclose(nsp.numpy(), jnsp, **TOL)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jkv), **TOL)


@pytest.mark.parametrize("n_tokens", [3, 6, 11])
def test_exported_filters_match_jax(pipelines, exported, n_tokens):
    pdir = pipelines["bf16"]
    run = exported["bf16"]
    m = _manifest(pdir)
    V, ts, eot, P = int(m["n_vocab"]), int(m["timestamp_begin"]), int(m["eot"]), int(m["sample_begin"])
    rng = np.random.RandomState(n_tokens)
    logits = (rng.randn(1, V) * 3).astype(np.float32)
    logits[0, ts : ts + 60] += 4.0  # timestamp mass competing with the text
    tokens = np.zeros((1, graphs.CACHE_SLOTS), np.int32)
    tokens[0, :P] = [int(t) for t in m["initial_tokens"].split()]
    tokens[0, P:n_tokens] = rng.choice([ts + 7, ts + 9, 400, 1200], size=n_tokens - P)
    pens = [torch.from_numpy(np.fromfile(os.path.join(pdir, f), np.float32)) for f in ("suppress_pen.bin", "begin_pen.bin")]
    (got,) = run("filters", torch.from_numpy(logits), torch.from_numpy(tokens),
                 torch.tensor([n_tokens], dtype=torch.int32), *pens)  # fmt: skip
    cfg = FusedConfig(
        n_group=1, n_audio=1, beam_search=False, use_timestamps=True, max_candidates=0, eot=eot,
        timestamp_begin=ts, no_timestamps=ts - 1, no_speech=ts - 2,
    )  # fmt: skip
    smask = np.fromfile(os.path.join(pdir, "suppress_mask.bin"), dtype=bool)
    bmask = np.fromfile(os.path.join(pdir, "blank_mask.bin"), dtype=bool)
    want = _apply_filters(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.int32(n_tokens), jnp.int32(P),
        jnp.asarray(smask), jnp.asarray(bmask), jnp.int32(50), cfg,
    )  # fmt: skip
    want = np.asarray(want)
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


# ---- a decode loop over the exported programs -----------------------------------


def _exported_decode(run, pdir, ck, cv, beam, sample_len, temperature=0.0, seed=0):
    """The native runner's per-window loop (csrc/wtt_transcribe.cpp
    decode_window) in Python over the exported programs, with the update
    kernels' plain versions. Returns FusedEngine.run's output tuple."""
    m = _manifest(pdir)
    P, eot, ts, V = int(m["sample_begin"]), int(m["eot"]), int(m["timestamp_begin"]), int(m["n_vocab"])
    G = int(m["beam_size"]) if beam else 1
    MC = G
    pens = [torch.from_numpy(np.fromfile(os.path.join(pdir, f), np.float32)) for f in ("suppress_pen.bin", "begin_pen.bin")]
    first = torch.zeros((1, graphs.CACHE_SLOTS), dtype=torch.int32)
    first[0, :P] = torch.tensor([int(t) for t in m["initial_tokens"].split()])
    logits, nsp, kv = run("prefill", first[:, :P].contiguous(), ck, cv)
    L, d = kv.shape[0], kv.shape[-1]
    cache = torch.zeros((L, 2, G, graphs.CACHE_SLOTS, d), dtype=kv.dtype)
    cache[:, :, :, :P] = kv
    logits = logits.expand(G, V).contiguous()
    toks = first.repeat(G, 1)
    sum_lp = torch.zeros(G)
    pool = (torch.zeros((1, MC, graphs.CACHE_SLOTS + 1), dtype=torch.int32),
            torch.full((1, MC), float("-inf")), torch.zeros((1, MC), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))  # fmt: skip
    gen = torch.Generator().manual_seed(seed)
    filt = dict(use_timestamps=True, eot=eot, timestamp_begin=ts)
    n, step, src = P, 0, None
    while True:
        if step > 0:
            pos = torch.tensor(n - 1, dtype=torch.int32)
            last = toks[:, n - 1].contiguous()
            if beam:
                (logits,) = run("step_beam", last, pos, cache, src, ck, cv)
            else:
                (logits,) = run("step_greedy", last, pos, cache, ck, cv)
        if beam:
            toks, src, sum_lp = beam_update_plain(
                logits, toks, sum_lp, *pool, n, P, step, *pens, n_group=G, **filt
            )
            done = pool[3] >= MC
        else:
            if temperature == 0:
                nxt, cur = greedy_argmax_plain(logits, toks, n, P, *pens, **filt)
            else:
                (filtered,) = run("filters", logits, toks, torch.tensor([n], dtype=torch.int32), *pens)
                probs = torch.softmax(filtered / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
                cur = torch.log_softmax(filtered, dim=-1).gather(1, nxt[:, None].long())[:, 0]
            already = toks[:, n - 1] == eot
            sum_lp = sum_lp + torch.where(already, 0.0, cur)
            nxt = torch.where(already, eot, nxt)
            toks[:, n] = nxt
            done = nxt == eot
        n, step = n + 1, step + 1
        if bool(done.all()) or step >= sample_len or n >= graphs.CACHE_SLOTS:
            break
    return (toks.numpy(), n, sum_lp.numpy(), nsp.numpy(), *(t.numpy() for t in pool))


def _engine_kwargs(pdir, beam, sample_len, temperature=0.0, seed=0):
    m = _manifest(pdir)
    ts = int(m["timestamp_begin"])
    G = int(m["beam_size"]) if beam else 1
    smask = np.fromfile(os.path.join(pdir, "suppress_mask.bin"), dtype=bool)
    bmask = np.fromfile(os.path.join(pdir, "blank_mask.bin"), dtype=bool)
    return dict(
        sot_index=0, suppress_ids=np.nonzero(smask)[0].tolist(),
        blank_ids=np.nonzero(bmask)[0].tolist(), max_initial_ts_index=50,
        sample_len=sample_len, n_group=G, beam_search=beam, max_candidates=G if beam else 0,
        use_timestamps=True, temperature=temperature, eot=int(m["eot"]), timestamp_begin=ts,
        no_timestamps=ts - 1, no_speech=ts - 2, rng_seed=seed,
    )  # fmt: skip


SAMPLE_LEN = 24  # steps of the loops (the manifest's 446 would make them slow)


@pytest.mark.parametrize("weights", MODES)
@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_exported_loop_matches_engines(pipelines, exported, tpu_model, torch_model, mel, weights, beam):
    """Encoder -> cross-K/V -> prefill -> steps over the exported programs
    with the plain updates: the port's engine's tokens and the JAX
    FusedEngine's, greedy and beam 5, float32 and int8 weights."""
    pdir = pipelines[weights]
    run = exported[weights]
    m = _manifest(pdir)
    (xa,) = run("encoder", torch.from_numpy(mel))
    ck, cv = run("cross_kv", xa)
    got = _exported_decode(run, pdir, ck, cv, beam, SAMPLE_LEN)
    kw = _engine_kwargs(pdir, beam, SAMPLE_LEN)
    mode = "int8" if weights == "int8" else ""
    port = FusedEngine(torch_model, weights=mode).run(
        np.array([[int(t) for t in m["initial_tokens"].split()]], np.int32), ck, cv, **kw
    )
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel))
    jax_out = JaxEngine(tpu_model, weights=mode).run(
        np.array([[int(t) for t in m["initial_tokens"].split()]], np.int32), jck, jcv, **kw
    )
    n = int(port[1])
    assert int(got[1]) == n == int(jax_out[1]) > int(m["sample_begin"])
    assert np.array_equal(got[0][:, :n], port[0][:, :n])
    assert np.array_equal(got[0][:, :n], np.asarray(jax_out[0])[:, :n])
    np.testing.assert_allclose(got[2], port[2], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got[3], port[3], **TOL)
    if beam:
        assert np.array_equal(got[7], port[7]) and np.array_equal(got[7], np.asarray(jax_out[7]))
        for i in (4, 6):  # finished tokens, lengths
            assert np.array_equal(got[i], port[i])


def test_exported_loop_samples_like_the_engine(pipelines, exported, torch_model, mel):
    """At T > 0 the filters program and the engine's draw (softmax of the
    filtered logits over T, torch.multinomial from a generator seeded with
    the seed, the log-softmax gather) give the engine's tokens."""
    pdir = pipelines["bf16"]
    run = exported["bf16"]
    m = _manifest(pdir)
    (xa,) = run("encoder", torch.from_numpy(mel))
    ck, cv = run("cross_kv", xa)
    got = _exported_decode(run, pdir, ck, cv, False, 2 * SAMPLE_LEN, temperature=0.6, seed=13)
    kw = _engine_kwargs(pdir, False, 2 * SAMPLE_LEN, temperature=0.6, seed=13)
    port = FusedEngine(torch_model).run(
        np.array([[int(t) for t in m["initial_tokens"].split()]], np.int32), ck, cv, **kw
    )
    n = int(port[1])
    assert int(got[1]) == n
    assert np.array_equal(got[0][:, :n], port[0][:, :n])
    np.testing.assert_allclose(got[2], port[2], rtol=1e-4, atol=0)
