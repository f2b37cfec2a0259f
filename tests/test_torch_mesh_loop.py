"""The mesh engines' decode loops as the loop-body program
(whisper_tpu_torch/parallel/serve.py on engine.py's and speculative.py's
programs): DataParallelEngine and DataParallelSpeculativeEngine run the
single-device engines' loop bodies on each rank's shard, with the
collectives inside the body (the tp reductions of the step, the done
flag's not-done count all-reduced over dp, the draw's gather over dp at
T > 0). Here, on gloo over the CPU, the body runs uncaptured, as it does
over gloo on a card.

One spawned world of 4 ranks (dp = 2, tp = 2) runs every case; its ranks
import neither JAX nor the JAX package, and every case's inputs (the
cross-K/V of the JAX model, the initial tokens) are made once in the test
process, so the JAX package's engines, the port's single-device engines
and the mesh read the same arrays. The cases:

  * greedy across the 128-slot phase edge (a prompt of 122 tokens) and
    beam 3 on two audios, against the JAX package's DataParallelEngine on
    the 8-device virtual mesh and against the port's single-device engine;
    T = 0.7 (the draw's gather inside the body) against the port's
    single-device draw at the same seed; int8 against the JAX package's
    int8 engine and the port's, on the terms of tests/test_torch_quant.py;
  * a batch whose two dp halves finish at different steps (only EOT, " "
    and "," allowed, as tests/test_torch_engine_loop.py's EARLY_END): the
    single-device engine's n_tokens, and passes after every row is done
    (the done flag read 3 passes late, or never) change no output;
  * one engine runs a batch that dp splits and a single audio that it
    does not (one audio a rank both times): the two keep separate program
    keys, since a graph bakes in its collectives, and each gives the
    single-device outputs, greedy and at T = 0.7;
  * every rank's EngineRun shows the program loop, uncaptured, and the
    same passes; the capture rule (comm.capturable) is false for a gloo
    group of two ranks and true for a group of one;
  * DataParallelSpeculativeEngine at tp = 2 against the port's and the JAX
    package's single-device speculative greedy;
  * graphs.decode_step_fixed with tp = 2 and sp = 2 against the unsharded
    step on the same inputs.

Tolerances: float32 tokens and step counts equal, sum_logprobs and
no_speech_prob within 1e-4 (the packages sum in other orders); int8 tokens
equal, sum_logprobs within 2e-3; the passes after the finish bit for bit
(the same arithmetic on the same buffers); the sharded step within 1e-5
(the row-parallel products add their partial sums in another order)."""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.engine import DONE_LAG
from whisper_tpu_torch.parallel.launch import spawn

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

EOT = 50257
SOT = [50258, 50259, 50359]  # <|startoftranscript|><|en|><|transcribe|>
SOT_PREV, WORD = 50361, 1349  # <|startofprev|>, " word"
# only EOT, " " and ",": on the synthetic checkpoint the two audios of
# EARLY_MELS end at different steps (4 and 6 tokens after the prompt)
EARLY_END = [EOT, 220, 11]
EARLY_MELS = 10
SPEC_DRAFT = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=1,
)  # fmt: skip


def _kw(sample_len, beam=1, **kw):
    return dict(
        dict(
            sot_index=0, suppress_ids=[EOT], blank_ids=[220, EOT], max_initial_ts_index=50,
            sample_len=sample_len, n_group=beam, beam_search=beam > 1,
            max_candidates=beam if beam > 1 else 0, use_timestamps=True, temperature=0.0, eot=EOT,
            timestamp_begin=50364, no_timestamps=50363, no_speech=50362, rng_seed=0,
        ),
        **kw,
    )  # fmt: skip


def _mels(seed, n):
    return (np.random.RandomState(seed).randn(n, 80, 3000) * 0.6).astype(np.float32)


def _initial(A, prompt=()):
    return np.tile(np.array([list(prompt) + SOT], np.int32), (A, 1))


EDGE_PROMPT = [SOT_PREV] + [WORD] * 118  # n_initial 122: the decode crosses slot 128


def _cases():
    """{case: (mel seed, audios, initial tokens, engine keywords, weights)}."""
    early = _kw(40, suppress_ids=[i for i in range(51865) if i not in EARLY_END], blank_ids=[EOT],
                max_initial_ts_index=None, use_timestamps=False)  # fmt: skip
    return {
        "greedy_edge": (3, 4, _initial(4, EDGE_PROMPT), _kw(16, sot_index=len(EDGE_PROMPT)), ""),
        "beam3": (9, 2, _initial(2), _kw(30, 3, suppress_ids=[11]), ""),
        "sampled": (11, 4, _initial(4), _kw(24, suppress_ids=[11], temperature=0.7, rng_seed=5), ""),
        "int8": (4, 2, _initial(2, EDGE_PROMPT), _kw(16, sot_index=len(EDGE_PROMPT)), "int8"),
        "early": (EARLY_MELS, 2, _initial(2), early, ""),
    }


# one engine's runs over batches that dp splits and one it does not (a
# single audio: every dp rank takes it whole), at the same local shapes
REUSE = [(A, _kw(12, suppress_ids=[11], temperature=t, rng_seed=5)) for t in (0.0, 0.7) for A in (2, 1, 2)]


def _reuse_inputs(inputs, A):
    _, ck, cv, _, _ = inputs["engine"]["sampled"]
    return _initial(A), *(torch.from_numpy(np.ascontiguousarray(t[:, :A])) for t in (ck, cv))


def _record(run):
    return {k: v for k, v in run._asdict().items() if k not in ("seconds", "capture_s")}


def _world(ckpt, inputs, draft_dims, draft_flat):
    """Every case on this rank of the (dp = 2, tp = 2) world."""
    import torch.distributed as dist

    import whisper_tpu_torch
    from whisper_tpu_torch import comm
    from whisper_tpu_torch import engine as eng_module
    from whisper_tpu_torch.models import graphs
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.params import unflatten_tree
    from whisper_tpu_torch.parallel import (
        DataParallelEngine, DataParallelSpeculativeEngine, make_mesh, shard_params,
    )  # fmt: skip

    model = whisper_tpu_torch.load_model(ckpt, device="cpu", compute_dtype=torch.float32)
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    out = {}
    for name, (initial, ck, cv, kw, weights) in inputs["engine"].items():
        lags = (eng_module.DONE_LAG, 3, 1000) if name == "early" else (eng_module.DONE_LAG,)
        default = eng_module.DONE_LAG
        for lag in lags:  # the done flag read at once, 3 passes late, never
            eng_module.DONE_LAG = lag
            try:
                engine = DataParallelEngine(model, mesh, weights=weights)
                got = engine.run(initial, torch.from_numpy(ck), torch.from_numpy(cv), **kw)
            finally:
                eng_module.DONE_LAG = default
            key = name if lag == default else f"{name}_lag{lag}"
            out[key] = (got, _record(engine.history[-1]), comm.capturable((engine._tp, engine._dp)))

    reuse = DataParallelEngine(model, mesh)
    out["reuse"] = [
        (reuse.run(*_reuse_inputs(inputs, A), **kw), _record(reuse.history[-1])) for A, kw in REUSE
    ]
    out["reuse_programs"] = len(reuse._programs)

    # the capture rule on this world's gloo groups: two ranks, then one
    one = make_mesh(dp=4, tp=1, device_type="cpu").get_group("tp")
    out["capturable"] = (
        comm.capturable((mesh.get_group("dp"),)), comm.capturable((one,)), comm.capturable((None,)),
    )  # fmt: skip

    params = unflatten_tree((k, torch.from_numpy(v)) for k, v in draft_flat.items())
    draft = whisper_tpu_torch.Whisper(ModelDimensions(**draft_dims), params, device="cpu",
                                      compute_dtype=torch.float32)  # fmt: skip
    spec = DataParallelSpeculativeEngine(model, draft, mesh, k=3)
    initial, *ckv = inputs["spec"]
    out["spec"] = (
        spec.run(initial, *(torch.from_numpy(t) for t in ckv), **inputs["spec_kw"]),
        _record(spec.history[-1]), spec._target._tp is not None and spec._draft._tp is not None,
    )  # fmt: skip

    # the step at fixed shapes with tp = 2 and sp = 2 against the unsharded one
    mesh_sp = make_mesh(dp=1, sp=2, tp=2, device_type="cpu")
    tp, sp = mesh_sp.get_group("tp"), mesh_sp.get_group("sp")
    dec = model.params["decoder"]
    _, ck, cv, _, _ = inputs["engine"]["beam3"]
    ck, cv = torch.from_numpy(ck), torch.from_numpy(cv)
    rng = np.random.RandomState(2)
    B, C, W = 6, 128, 64  # two audios at beam 3; the step reads the first W slots
    cache = torch.from_numpy((rng.randn(2, 2, B, C, 128) * 0.5).astype(np.float32))
    src = torch.from_numpy(rng.permutation(B).astype(np.int32))
    tokens = torch.from_numpy(rng.randint(0, 50000, B).astype(np.int32))
    pos = torch.tensor([37], dtype=torch.int32)
    want, full = graphs.decode_step_fixed(dec, tokens, pos, cache.clone(), src, ck, cv, n_head=2, window=W)
    local = comm.local_slice(cache, tp, 4).clone()
    lck, lcv = (comm.local_slice(comm.local_slice(t, tp, 2), sp, 4) for t in (ck, cv))
    got, local = graphs.decode_step_fixed(
        shard_params(dec, mesh_sp), tokens, pos, local, src, lck, lcv, n_head=2, window=W, tp=tp, sp=sp,
    )  # fmt: skip
    out["step_logits_err"] = float((got - want).abs().max())
    out["step_cache_err"] = float((local - comm.local_slice(full, tp, 4)).abs().max())
    out["rank"] = dist.get_rank()
    return out


@pytest.fixture(scope="module")
def draft(tpu_model):
    """A 2-head draft (tp = 2 shards it) in the JAX package: the JAX model
    and its weights for the ranks."""
    from whisper_tpu.models import Whisper
    from whisper_tpu.models.dims import ModelDimensions

    from whisper_tpu_torch.models.params import flatten_tree

    jax_draft = Whisper(ModelDimensions(**SPEC_DRAFT), params=None, name="mesh-loop-draft", compute_dtype="float32")
    return jax_draft, {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax_draft.params)}


@pytest.fixture(scope="module")
def inputs(tpu_model, draft):
    """Every case's inputs, from the JAX model's encoder and cross-K/V."""
    engine = {}
    for name, (seed, A, initial, kw, weights) in _cases().items():
        ck, cv = (np.array(t, np.float32) for t in tpu_model.cross_kv(tpu_model.encode(_mels(seed, A))))
        engine[name] = (initial, ck, cv, kw, weights)
    jax_draft, _ = draft
    mels = _mels(6, 2)
    ck, cv = tpu_model.cross_kv(tpu_model.encode(mels))
    dck, dcv = jax_draft.cross_kv(jax_draft.encode(mels))
    spec_kw = {k: v for k, v in _kw(20).items() if k not in ("n_group", "beam_search", "max_candidates", "rng_seed")}
    spec = (_initial(2), *(np.array(t, np.float32) for t in (ck, cv, dck, dcv)))
    return {"engine": engine, "spec": spec, "spec_kw": spec_kw}


@pytest.fixture(scope="module")
def world(synth_checkpoint, inputs, draft):
    ranks = spawn(_world, 4, synth_checkpoint, inputs, dict(SPEC_DRAFT), draft[1], device_type="cpu")
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    return ranks


@pytest.fixture(scope="module")
def port(synth_checkpoint, inputs, draft):
    """The port's single-device runs of the same cases, in this process."""
    import whisper_tpu_torch
    from whisper_tpu_torch.engine import FusedEngine
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.params import unflatten_tree
    from whisper_tpu_torch.speculative import SpeculativeEngine

    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    out = {}
    for name, (initial, ck, cv, kw, weights) in inputs["engine"].items():
        engine = FusedEngine(model, weights=weights)
        out[name] = engine.run(initial, torch.from_numpy(ck), torch.from_numpy(cv), **kw)
        out[name + "_run"] = engine.history[-1]
    engine = FusedEngine(model)
    out["reuse"] = [engine.run(*_reuse_inputs(inputs, A), **kw) for A, kw in REUSE]
    params = unflatten_tree((k, torch.from_numpy(v)) for k, v in draft[1].items())
    port_draft = whisper_tpu_torch.Whisper(ModelDimensions(**SPEC_DRAFT), params, device="cpu",
                                           compute_dtype=torch.float32)  # fmt: skip
    initial, *ckv = inputs["spec"]
    spec = SpeculativeEngine(model, port_draft, k=3)
    out["spec"] = spec.run(initial, *(torch.from_numpy(t) for t in ckv), **inputs["spec_kw"])
    return out


def _same_run(got, want, atol=1e-4, fcount=True):
    n = int(want[1])
    assert int(got[1]) == n
    np.testing.assert_array_equal(np.asarray(got[0])[:, :n], np.asarray(want[0])[:, :n])
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), rtol=0, atol=atol)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]), rtol=0, atol=1e-4)
    if fcount:
        np.testing.assert_array_equal(np.asarray(got[7]), np.asarray(want[7]))


def _same_bits(a, b):
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_every_rank_returns_the_same_outputs(world):
    """SPMD: the outputs are gathered over dp, so every rank holds the
    whole batch's."""
    for r in world[1:]:
        for name in _cases():
            _same_bits(r[name][0], world[0][name][0])
        _same_bits(r["spec"][0], world[0]["spec"][0])


@pytest.mark.parametrize("name", ["greedy_edge", "beam3"])
def test_body_matches_jax_mesh_and_single_device(world, port, inputs, tpu_model, mesh8, name):
    from whisper_tpu.parallel.serve import DataParallelEngine

    initial, ck, cv, kw, _ = inputs["engine"][name]
    want = DataParallelEngine(tpu_model, mesh8).run(initial, ck, cv, **kw)
    got = world[0][name][0]
    _same_run(got, want, fcount=kw["beam_search"])
    _same_run(got, port[name])
    if name == "greedy_edge":
        assert int(got[1]) > 128 > initial.shape[1]  # both cache phases ran


def test_sampling_gathers_the_draw_inside_the_body(world, port):
    """T = 0.7: the body all-gathers each step's probabilities over dp and
    draws for the whole batch with the shared generator: the single-device
    draws at the same seed."""
    _same_run(world[0]["sampled"][0], port["sampled"], fcount=False)


def test_int8_matches_jax_int8_engine(world, port, inputs, tpu_model):
    from whisper_tpu.engine_fused import FusedEngine as JaxEngine

    initial, ck, cv, kw, _ = inputs["engine"]["int8"]
    want = JaxEngine(tpu_model, weights="int8").run(initial, ck, cv, **kw)
    got = world[0]["int8"][0]
    assert int(got[1]) > 128 > initial.shape[1]
    _same_run(got, want, atol=2e-3, fcount=False)
    _same_run(got, port["int8"], fcount=False)


def test_halves_finishing_apart_keep_stepping(world, port, inputs):
    """The two dp halves' rows end at different steps; the rank whose row
    ended first keeps stepping until the other's has: the single-device
    engine's n_tokens and outputs."""
    got, want = world[0]["early"][0], port["early"]
    n_initial = inputs["engine"]["early"][0].shape[1]
    ends = [int(np.argmax(row[n_initial:] == EOT)) for row in np.asarray(want[0])]
    assert ends[0] != ends[1]  # one audio on each dp half
    assert int(want[1]) < n_initial + 40 - 4  # every row ended well before sample_len
    _same_run(got, want, fcount=False)
    steps = int(want[1]) - n_initial
    passes = steps - 1 + DONE_LAG  # and the passes behind the done read
    assert all(r["early"][1]["bodies"] == port["early_run"].bodies == passes for r in world)


@pytest.mark.parametrize("lag", [3, 1000], ids=["lag3", "never-read"])
def test_passes_after_done_change_nothing(world, lag):
    """Passes after every row is done (the flag read 3 passes late, or
    never, so the loop runs to sample_len) change no output, bit for bit,
    and every rank runs them."""
    steps = world[0]["early"][1]["steps"]
    for r in world:
        _same_bits(r[f"early_lag{lag}"][0], r["early"][0])
        assert r[f"early_lag{lag}"][1]["bodies"] == (steps - 1 + 3 if lag == 3 else 40 - 1)


def test_every_rank_runs_the_program_in_lockstep(world):
    """Each run's record on every rank: the loop-body program, uncaptured
    (gloo), the same passes, done reads and program key on every rank."""
    for name in _cases():
        runs = [r[name][1] for r in world]
        assert all(run["loop"] == "program" and not run["captured"] for run in runs), name
        assert all(run["captures"] == run["replays"] == 0 for run in runs), name
        for k in ("steps", "bodies", "done_reads", "program"):
            assert len({repr(run[k]) for run in runs}) == 1, (name, k)
        assert runs[0]["bodies"] > 0
    spec = [r["spec"][1] for r in world]
    assert all(run["loop"] == "program" and not run["captured"] and run["bodies"] > 0 for run in spec)
    # the ranks of one dp group (neighbours: tp innermost) run the same rounds
    for a, b in ((0, 1), (2, 3)):
        assert spec[a]["bodies"] == spec[b]["bodies"] and spec[a]["rounds"] == spec[b]["rounds"]


def test_one_engine_over_split_and_whole_batches(world, port):
    """One engine runs 2 audios (split over dp), 1 audio (every dp rank
    takes it whole), then 2 again, greedy and at T = 0.7. Both kinds of
    run have one audio a rank, so only the dp group's size in the program
    key keeps them on separate buffers and graphs (a graph bakes in its
    collectives: the done flag's reduction, the draw's gather). Each run
    gives the single-device engine's outputs."""
    for r in world:
        runs = [run for _, run in r["reuse"]]
        split, whole = runs[0], runs[1]
        assert split["program"] == whole["program"]  # the same local shapes
        assert split["groups"] == (2, 1, 2) and whole["groups"] == (2, 1, 1)
        assert r["reuse_programs"] == 2
        for (A, kw), (got, run), want in zip(REUSE, r["reuse"], port["reuse"]):
            assert run["groups"] == (split if A == 2 else whole)["groups"]
            _same_run(got, want, fcount=False)


def test_capture_rule(world):
    """comm.capturable: a gloo group of more than one rank cannot be
    captured, a group of one (or none) can; the engines' groups in this
    world are gloo groups of two."""
    for r in world:
        assert r["capturable"] == (False, True, True)
        assert all(r[name][2] is False for name in _cases())


def test_speculative_at_tp2_matches_single_device(world, port, inputs, tpu_model, draft):
    from whisper_tpu.speculative import SpeculativeEngine

    initial, ck, cv, dck, dcv = inputs["spec"]
    want = SpeculativeEngine(tpu_model, draft[0], k=3).run(initial, ck, cv, dck, dcv, **inputs["spec_kw"])
    got, _, sharded = world[0]["spec"]
    assert sharded  # both decoders' heads split over tp
    _same_run(got, want, fcount=False)
    _same_run(got, port["spec"], fcount=False)
    np.testing.assert_array_equal(got[0], port["spec"][0])  # the EOT padding too


def test_decode_step_fixed_tp_sp_matches_unsharded(world):
    for r in world:
        assert r["step_logits_err"] <= 1e-5
        assert r["step_cache_err"] <= 1e-5
