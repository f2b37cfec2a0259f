"""The native runner's decode loop (csrc/wtt_transcribe.cpp decode_window) as
a Python twin over the exported programs, on the synthetic checkpoint at
float32 on the CPU: the same static buffers, the loop state, the phases and
step packages loop.txt names (export.pipeline_graphs' step_*_w128 / _w256
beside the whole-cache steps), the update kernels' plain loop-state forms
and the done read loop.txt's done_lag passes late. The card captures this
body once per (mode, window) and replays it; here it runs eagerly, as the
port's engine runs its body on the CPU (tests/test_torch_engine_loop.py).
This file holds the float32 weights; tests/test_torch_runner_loop_int8.py
runs (a) and (d) on an int8 pipeline with this file's twin and checks.

(a) The twin equals the JAX package's fused_decode under the export's
    FusedConfig (whisper_tpu/export.py's fused_greedy / fused_beam) at
    greedy and beam 5 over a decode that crosses the 128- and 256-slot
    phase edges (EOT suppressed in both, so that every phase's package
    runs);
(b) at T > 0 it draws the port engine's tokens at the same seed;
(c) a pass after every row is done changes no output, bit for bit;
(d) each window's step package, run eagerly, against the whole-cache step
    on the same inputs; the new graphs' specs and loop.txt; the runner's
    build naming the capture's unit (csrc/wtt_graph.cpp), whose source is
    checked for syntax where the CUDA toolkit's headers are installed.

Tolerances are tests/test_torch_export.py's: tokens equal, summed
log-probabilities within rtol = 1e-4 (~1e-6 relative differences a step
between the two CPU backends), (c) bit for bit (the same arithmetic on the
same buffers), (d) rtol = atol = 1e-5 (masked slots add exact zeros, in
another order)."""

import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_export import GRAPHS, _engine_kwargs, _Exported, _manifest, _spec

import whisper_tpu_torch
from whisper_tpu.engine_fused import FusedConfig, fused_decode
from whisper_tpu.quant import quantize_decoder as jax_quantize_decoder
from whisper_tpu_torch import engine as eng_module
from whisper_tpu_torch.engine import PHASES, FusedEngine
from whisper_tpu_torch.export import export_pipeline, loop_manifest, pipeline_graphs, step_graph_name
from whisper_tpu_torch.kernels import build as kernels_build
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.ops import beam_kernel as bk
from whisper_tpu_torch.ops.beam_kernel import LIVE, N_TOKENS, build_penalty_vectors
from whisper_tpu_torch.runtime import build

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("bf16",)  # the weights here; tests/test_torch_runner_loop_int8.py runs "int8"
WINDOW_GRAPHS = [step_graph_name(beam, w) for beam in (False, True) for w in PHASES[:-1]]
assert set(WINDOW_GRAPHS) <= set(GRAPHS)  # tests/test_torch_export.py's exported programs
CROSSING_LEN = 262  # P = 3 initial tokens + 262 steps: the decode ends past slot 256
SLOTS = graphs.CACHE_SLOTS


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


def export_for(torch_model, tmp_path_factory, weights):
    d = str(tmp_path_factory.mktemp(f"runner_loop_{weights}"))
    export_pipeline(d, torch_model, weights=weights, compile=False)
    return d


@pytest.fixture(scope="module")
def pipelines(torch_model, tmp_path_factory):
    return {weights: export_for(torch_model, tmp_path_factory, weights) for weights in MODES}


@pytest.fixture(scope="module")
def exported(pipelines):
    return {weights: _Exported(pdir) for weights, pdir in pipelines.items()}


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(7).randn(1, 80, 3000) * 0.6).astype(np.float32)


@pytest.fixture(scope="module")
def ckv(exported, mel):
    """The window's cross-K/V through the exported encoder and cross-K/V
    (an int8 pipeline's are the float32 graphs)."""
    run = next(iter(exported.values()))
    (xa,) = run("encoder", torch.from_numpy(mel))
    return run("cross_kv", xa)


def _masks(pdir, suppress_eot):
    smask = np.fromfile(os.path.join(pdir, "suppress_mask.bin"), dtype=bool).copy()
    bmask = np.fromfile(os.path.join(pdir, "blank_mask.bin"), dtype=bool)
    if suppress_eot:
        smask[int(_manifest(pdir)["eot"])] = True
    return smask, bmask


def _loop(pdir):
    """loop.txt as the runner parses it: the done lag, and the phases in
    order as (cache window, greedy step package, beam step package)."""
    lag, phases = None, []
    for line in open(os.path.join(pdir, "loop.txt")):
        key, *rest = line.split()
        if key == "done_lag":
            lag = int(rest[0])
        elif key == "phase":
            phases.append((int(rest[0]), rest[1], rest[2]))
    return lag, phases


def _penalties(pdir, smask, bmask):
    """The update kernels' penalty vectors of the masks (what the export
    writes into suppress_pen.bin / begin_pen.bin for its own masks)."""
    ts = int(_manifest(pdir)["timestamp_begin"])
    sup, beg = build_penalty_vectors(
        smask.size, np.nonzero(smask)[0], np.nonzero(bmask)[0], use_timestamps=True,
        no_timestamps=ts - 1, timestamp_begin=ts, max_initial_ts_index=50,
    )  # fmt: skip
    return torch.from_numpy(sup), torch.from_numpy(beg)


# ---- the twin -------------------------------------------------------------------


class RunnerTwin:
    """decode_window of csrc/wtt_transcribe.cpp, line for line, over the
    exported programs (`run`): Program's static buffers (made from the
    whole-cache step's spec), start, update (step 0 at the kernels' scalar
    launches, later passes at their loop-state forms), body (pos and the
    last tokens from the state, the phase's step package), and the phases
    and the done flag's lag as loop.txt gives them. At T > 0 the logits are scaled as the engine scales them on the
    buffers' device (on the card by the reciprocal of T, as the runner
    does; here divided by T, as the port's engine does on the CPU)."""

    def __init__(self, run, pdir, beam, pens=None):
        m = _manifest(pdir)
        self.run, self.beam = run, beam
        self.P, self.eot, self.V = int(m["sample_begin"]), int(m["eot"]), int(m["n_vocab"])
        self.filt = dict(use_timestamps=True, eot=self.eot, timestamp_begin=int(m["timestamp_begin"]))
        self.G = self.MC = int(m["beam_size"]) if beam else 1
        self.done_lag, self.phases = _loop(pdir)
        spec = run.specs[self.phases[0][2 if beam else 1]]
        n, ins = spec["n_params"], spec["inputs"]

        def zeros(s):
            return torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]))

        G, i32 = self.G, torch.int32
        self.last, self.pos, self.cache = zeros(ins[n]), zeros(ins[n + 1]), zeros(ins[n + 2])
        self.ck, self.cv = zeros(ins[-2]), zeros(ins[-1])
        self.tokens = torch.zeros((G, SLOTS), dtype=i32)
        self.sum_lp = torch.zeros(G)
        self.pool_tokens = torch.zeros((1, self.MC, SLOTS + 1), dtype=i32)
        self.pool_scores = torch.zeros((1, self.MC))
        self.pool_lengths = torch.zeros((1, self.MC), dtype=i32)
        self.pool_count = torch.zeros(1, dtype=i32)
        self.state = torch.zeros(4, dtype=i32)
        self.live_host = torch.zeros(1, dtype=i32)
        self.identity = torch.arange(G, dtype=i32)
        self.src = self.identity.clone()
        self.advance = torch.tensor([1, 0, 1, 0], dtype=i32)
        self.t_scale = torch.ones(1)
        self.tok_out, self.lp_out = torch.zeros(G, dtype=i32), torch.zeros(G)
        self.new_tokens, self.src_out, self.new_lp = torch.zeros_like(self.tokens), torch.zeros(G, dtype=i32), torch.zeros(G)
        self.first = torch.zeros((1, SLOTS), dtype=i32)
        self.first[0, : self.P] = torch.tensor([int(t) for t in m["initial_tokens"].split()])
        self.pens = pens or [torch.from_numpy(np.fromfile(os.path.join(pdir, f), np.float32))
                             for f in ("suppress_pen.bin", "begin_pen.bin")]  # fmt: skip
        self.gen = torch.Generator()
        self.passes = self.done_reads = 0
        self.ran = set()  # the step packages the body called

    def start(self, kv, ck, cv, temperature, seed):
        P, G = self.P, self.G
        self.tokens.copy_(self.first.expand(G, SLOTS))
        self.cache.zero_()
        self.cache[:, :, :, :P] = kv.expand(kv.shape[0], 2, G, P, kv.shape[4])
        self.sum_lp.zero_()
        self.pool_tokens.zero_()
        self.pool_scores.fill_(float("-inf"))
        self.pool_lengths.zero_()
        self.pool_count.zero_()
        self.src.copy_(self.identity)
        self.state.copy_(torch.tensor([P, P, 0, 1], dtype=torch.int32))
        self.ck.copy_(ck)
        self.cv.copy_(cv)
        t = np.float32(max(temperature, 1e-6))
        self.t_scale.fill_(float(np.float32(1) / t) if self.t_scale.is_cuda else float(t))
        self.gen.manual_seed(int(seed))

    def greedy_tail(self, tok, lp, live):
        nt = self.state[N_TOKENS : N_TOKENS + 1].long().expand(self.G)[:, None]
        already = self.tokens.gather(1, nt - 1)[:, 0] == self.eot
        self.sum_lp.copy_(torch.where(live, self.sum_lp + torch.where(already, 0.0, lp), self.sum_lp))
        nxt = torch.where(already, self.eot, tok)
        nxt = torch.where(live, nxt, self.tokens.gather(1, nt)[:, 0])
        self.tokens.scatter_(1, nt, nxt[:, None])
        return nxt == self.eot

    def update(self, mode, logits, first_n=None):
        st = self.state
        live = st[LIVE : LIVE + 1] != 0
        pools = (self.pool_tokens, self.pool_scores, self.pool_lengths, self.pool_count)
        outs = (self.new_tokens, self.src_out, self.new_lp)
        if mode == "beam":
            if first_n is not None:
                got = bk.beam_update(logits, self.tokens, self.sum_lp, *pools, first_n, self.P, 0,
                                     *self.pens, n_group=self.G, **self.filt)  # fmt: skip
                for out, value in zip(outs, got):
                    out.copy_(value)
            else:
                bk.beam_update_state(logits, self.tokens, self.sum_lp, *pools, st, *self.pens, *outs,
                                     n_group=self.G, **self.filt)  # fmt: skip
            self.tokens.copy_(torch.where(live[:, None], self.new_tokens, self.tokens))
            self.src.copy_(torch.where(live, self.src_out, self.identity))
            self.sum_lp.copy_(torch.where(live, self.new_lp, self.sum_lp))
            done = self.pool_count >= self.MC
        else:
            tok, lp = self.tok_out, self.lp_out
            if mode == "greedy" and first_n is not None:
                got = bk.greedy_argmax(logits, self.tokens, first_n, self.P, *self.pens, **self.filt)
                tok.copy_(got[0]), lp.copy_(got[1])
            elif mode == "greedy":
                bk.greedy_argmax_state(logits, self.tokens, st, *self.pens, tok, lp, **self.filt)
            else:
                (filtered,) = self.run("filters", logits, self.tokens, st[N_TOKENS : N_TOKENS + 1], *self.pens)
                scaled = filtered * self.t_scale if self.t_scale.is_cuda else filtered / self.t_scale
                probs = torch.softmax(scaled, dim=-1)
                noise = torch.empty_like(probs).exponential_(1, generator=self.gen)
                tok = (probs / noise).argmax(dim=-1).to(torch.int32)
                lp = torch.log_softmax(filtered, dim=-1).gather(1, tok[:, None].long())[:, 0]
            done = self.greedy_tail(tok, lp, live)
        live_now = st[LIVE : LIVE + 1]
        st.add_(self.advance * live_now)
        live_now.mul_((~done.all()).to(torch.int32))
        self.live_host.copy_(live_now)

    def body(self, mode, phase):
        self.pos.copy_(self.state[N_TOKENS] - 1)
        self.last.copy_(self.tokens.gather(1, self.pos.long().reshape(1, 1).expand(self.G, 1))[:, 0])
        src = (self.src,) if mode == "beam" else ()
        name = phase[2] if mode == "beam" else phase[1]
        self.ran.add(name)
        (logits,) = self.run(name, self.last, self.pos, self.cache, *src, self.ck, self.cv)
        self.update(mode, logits)
        self.passes += 1

    def decode(self, ck, cv, sample_len, temperature=0.0, seed=0):
        """One window; FusedEngine.run's output tuple (no_speech included)."""
        mode = "beam" if self.beam else "sample" if temperature > 0 else "greedy"
        P = self.P
        logits, no_speech, kv = self.run("prefill", self.first[:, :P].contiguous(), ck, cv)
        self.start(kv, ck, cv, temperature, seed)
        self.update(mode, logits.expand(self.G, self.V).contiguous(), first_n=P)
        n, step, pending, done = P + 1, 1, [], False
        for i, phase in enumerate(self.phases):
            limit = phase[0] if i + 1 < len(self.phases) else SLOTS
            while step < sample_len and n < limit:
                self.body(mode, phase)
                n, step = n + 1, step + 1
                pending.append(int(self.live_host[0]))  # the pinned flag the pass left
                if len(pending) <= self.done_lag:
                    continue
                done = not pending.pop(0)
                self.done_reads += 1
                if done:
                    break
            if done:
                break
        return self.outputs(no_speech)

    def outputs(self, no_speech):
        host = (self.tokens, self.sum_lp, self.pool_tokens, self.pool_scores, self.pool_lengths, self.pool_count)
        tokens, sum_lp, *pools = (t.clone().numpy() for t in host)
        return (tokens, int(self.state[N_TOKENS]), sum_lp, no_speech.numpy(), *pools)


# ---- (a) against the JAX package's fused_decode ---------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fused(beam, int8, G, eot, ts):
    """fused_decode under the export's FusedConfig (whisper_tpu/export.py:
    fused_greedy, and fused_beam at n_group = max_candidates = beam_size)."""
    cfg = FusedConfig(
        n_group=G, n_audio=1, beam_search=beam, use_timestamps=True, max_candidates=G if beam else 0,
        eot=eot, timestamp_begin=ts, no_timestamps=ts - 1, no_speech=ts - 2, quantize_ckv=int8,
    )  # fmt: skip
    return jax.jit(functools.partial(fused_decode, n_head=2, cfg=cfg, cache_dtype=jnp.float32))


def _jax_decode(tpu_model, pdir, mel, beam, weights, sample_len, smask, bmask):
    m = _manifest(pdir)
    P, ts = int(m["sample_begin"]), int(m["timestamp_begin"])
    G = int(m["beam_size"]) if beam else 1
    dec = tpu_model.params["decoder"]
    dec = jax_quantize_decoder(dec) if weights == "int8" else dec
    initial = np.zeros((1, SLOTS), np.int32)
    initial[0, :P] = [int(t) for t in m["initial_tokens"].split()]
    jck, jcv = tpu_model.cross_kv(tpu_model.encode(mel))
    fn = _jax_fused(beam, weights == "int8", G, int(m["eot"]), ts)
    out = fn(dec, initial, np.int32(P), jck, jcv, np.int32(0), jnp.asarray(smask), jnp.asarray(bmask),
             np.int32(50), np.int32(sample_len), np.float32(0), np.int32(0))  # fmt: skip
    return [np.asarray(o) for o in out]


def check_twin_matches_jax(pipelines, exported, tpu_model, mel, ckv, weights, beam):
    """(a) for one weights mode and step mode."""
    pdir = pipelines[weights]
    smask, bmask = _masks(pdir, suppress_eot=True)
    twin = RunnerTwin(exported[weights], pdir, beam, pens=_penalties(pdir, smask, bmask))
    got = twin.decode(*ckv, CROSSING_LEN)
    want = _jax_decode(tpu_model, pdir, mel, beam, weights, CROSSING_LEN, smask, bmask)
    n = got[1]
    assert n == int(want[1]) == twin.P + CROSSING_LEN > PHASES[1]
    assert [w for w, *_ in twin.phases] == list(PHASES)
    assert twin.ran == {phase[2 if beam else 1] for phase in twin.phases}  # every phase's package ran
    assert np.array_equal(got[0][:, :n], want[0][:, :n])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got[3], want[3], **TOL)
    if beam:
        for i in (4, 6, 7):  # finished tokens, lengths, counts
            assert np.array_equal(got[i], want[i])
    # one body pass a token after step 0, each read done_lag passes late
    assert twin.passes == CROSSING_LEN - 1
    assert twin.done_lag == eng_module.DONE_LAG
    assert twin.done_reads == twin.passes - twin.done_lag


@pytest.mark.parametrize("weights", MODES)
@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_twin_matches_jax_fused_decode_across_phases(pipelines, exported, tpu_model, mel, ckv, weights, beam):
    check_twin_matches_jax(pipelines, exported, tpu_model, mel, ckv, weights, beam)


# ---- (b) T > 0 ------------------------------------------------------------------


def test_twin_samples_like_the_engine(pipelines, exported, torch_model, ckv):
    """The filters package, the engine's draw from a generator seeded with
    the seed and the log-softmax gather, across the 128-slot edge: the port
    engine's tokens at T = 0.6."""
    pdir = pipelines["bf16"]
    m = _manifest(pdir)
    sample_len = 140
    smask, bmask = _masks(pdir, suppress_eot=True)
    twin = RunnerTwin(exported["bf16"], pdir, beam=False, pens=_penalties(pdir, smask, bmask))
    got = twin.decode(*ckv, sample_len, temperature=0.6, seed=13)
    kw = _engine_kwargs(pdir, False, sample_len, temperature=0.6, seed=13)
    kw["suppress_ids"] = np.nonzero(smask)[0].tolist()
    port = FusedEngine(torch_model).run(
        np.array([[int(t) for t in m["initial_tokens"].split()]], np.int32), *ckv, **kw
    )
    n = int(port[1])
    assert got[1] == n > PHASES[0]
    assert np.array_equal(got[0][:, :n], port[0][:, :n])
    np.testing.assert_allclose(got[2], port[2], rtol=1e-4, atol=0)


# ---- (c) a pass after every row is done -----------------------------------------


def out_buffers(twin):
    return (twin.pool_tokens, twin.pool_scores, twin.pool_lengths, twin.pool_count, twin.live_host)


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_pass_after_done_changes_nothing(pipelines, exported, ckv, beam):
    """Only EOT, " ", "," and the timestamps left unsuppressed: every row
    ends early. The done read already lets done_lag passes run after the
    finish; more passes at the last phase change no output, no buffer, bit
    for bit."""
    pdir = pipelines["bf16"]
    m = _manifest(pdir)
    eot, ts = int(m["eot"]), int(m["timestamp_begin"])
    smask = np.ones(int(m["n_vocab"]), bool)
    smask[[eot, 220, 11]] = False
    smask[ts:] = False
    bmask = np.zeros_like(smask)
    bmask[eot] = True
    twin = RunnerTwin(exported["bf16"], pdir, beam, pens=_penalties(pdir, smask, bmask))
    mode = "beam" if beam else "greedy"
    out = twin.decode(*ckv, 60)
    n = out[1]
    assert n - twin.P < 60 - 4 and int(twin.state[LIVE]) == 0  # every row ended before sample_len
    assert twin.passes == n - twin.P - 1 + twin.done_lag
    before = [b.clone() for b in (twin.tokens, twin.sum_lp, twin.src, twin.state, *out_buffers(twin))]
    for _ in range(3):
        twin.body(mode, twin.phases[0])
    after = (twin.tokens, twin.sum_lp, twin.src, twin.state, *out_buffers(twin))
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(out, twin.outputs(torch.from_numpy(out[3]))))


# ---- (d) the window graphs ---------------------------------------------------------


def check_window_step(exported, ckv, weights, name):
    """A window's package against the whole-cache step on the same inputs:
    every slot of the cache filled (the masks, not zeros, hide what lies
    past pos), pos below the window; the logits within 1e-5, the cache's
    window equal (beam: reordered by the same src)."""
    run = exported[weights]
    beam = name.startswith("step_beam")
    W = int(name.rsplit("_w", 1)[1])
    full = step_graph_name(beam, SLOTS)
    spec = run.specs[full]
    cache_spec = spec["inputs"][spec["n_params"] + 2]
    rng = np.random.RandomState(W + beam)
    cache = torch.from_numpy((rng.randn(*cache_spec["shape"]) * 0.5).astype(np.float32))
    G = cache.shape[2]
    tokens = torch.from_numpy(rng.randint(0, 50000, size=G).astype(np.int32))
    src = (torch.from_numpy(rng.permutation(G).astype(np.int32)),) if beam else ()
    pos = torch.tensor(W - 9, dtype=torch.int32)
    a, b = cache.clone(), cache.clone()
    (want,) = run(full, tokens, pos, a, *src, *ckv)
    (got,) = run(name, tokens, pos, b, *src, *ckv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(b[:, :, :, :W].numpy(), a[:, :, :, :W].numpy(), **TOL)
    assert torch.equal(b[:, :, :, W:], cache[:, :, :, W:])  # the window's step reads and writes below W


@pytest.mark.parametrize("weights", MODES)
@pytest.mark.parametrize("name", WINDOW_GRAPHS)
def test_window_step_matches_whole_cache_step(exported, ckv, weights, name):
    check_window_step(exported, ckv, weights, name)


def check_window_graph_specs(pipelines, weights):
    """The window packages take what the whole-cache step takes (the cache
    at 448 slots) and give the same logits; the spec names each; the
    pipeline lists each with its export seconds, and loop.txt names each
    phase's packages and the engine's done lag."""
    import json

    pdir = pipelines[weights]
    with open(os.path.join(pdir, "timings.json")) as f:
        timings = json.load(f)
    for name in WINDOW_GRAPHS:
        full = _spec(pdir, "step_beam" if name.startswith("step_beam") else "step_greedy")
        spec = _spec(pdir, name)
        assert spec["name"] == name and spec["n_params"] == full["n_params"]
        assert spec["inputs"] == full["inputs"] and spec["outputs"] == full["outputs"]
        assert open(os.path.join(pdir, f"{name}.spec.txt")).readline().strip() == f"graph {name}"
        assert timings[name]["export_s"] > 0
    assert list(timings)[-len(WINDOW_GRAPHS) :] == WINDOW_GRAPHS
    P = int(_manifest(pdir)["sample_begin"])
    assert open(os.path.join(pdir, "loop.txt")).read() == loop_manifest(P, int(_manifest(pdir)["sample_len"]))
    lag, phases = _loop(pdir)
    assert lag == eng_module.DONE_LAG
    assert phases == [(w, step_graph_name(False, w), step_graph_name(True, w)) for w in PHASES]
    assert all(name in timings for _, *names in phases for name in names)


@pytest.mark.parametrize("weights", MODES)
def test_window_graph_specs(pipelines, weights):
    check_window_graph_specs(pipelines, weights)


@pytest.mark.parametrize("sample_len", [446, 253, 125, 100])
def test_pipeline_graphs_name_the_phases_reached(torch_model, sample_len):
    """Each step mode's package at the whole cache (its name kept for the
    export tool and the runner's checks), and at each lower cache window
    that a decode of sample_len reaches after the 3 initial tokens
    (engine._last_window), as fused_decode skips the phases past its
    cache; loop.txt lists those phases, the last one's window the one
    that holds the decode, with their packages."""
    names = list(pipeline_graphs(torch_model, sample_len=sample_len))
    below = {446: PHASES[:2], 253: PHASES[:2], 125: PHASES[:1], 100: PHASES[:1]}[sample_len]
    windows = [step_graph_name(beam, w) for beam in (False, True) for w in below]
    assert names == ["encoder", "cross_kv", "prefill", "step_greedy", "step_beam", "filters", *windows]
    assert [step_graph_name(False, w) for w in PHASES] == ["step_greedy_w128", "step_greedy_w256", "step_greedy"]
    phases = loop_manifest(3, sample_len).splitlines()
    assert phases[0] == f"done_lag {eng_module.DONE_LAG}"
    reached = {446: PHASES, 253: PHASES[:2], 125: PHASES[:1], 100: PHASES[:1]}[sample_len]
    assert phases[1:] == [f"phase {w} {step_graph_name(False, w)} {step_graph_name(True, w)}" for w in reached]
    assert all(name in names for line in phases[1:] for name in line.split()[2:])


def test_runner_command_names_the_graph_unit(tmp_path):
    """The runner's build compiles csrc/wtt_graph.cpp beside it, with the
    CUDA toolkit's headers, links cudart where it is needed, and keys the
    binary by its source too."""
    cmd = build.runner_command(str(tmp_path / "runner"), kernels_build.library_path())
    assert build.GRAPH_SOURCE.endswith(os.path.join("csrc", "wtt_graph.cpp"))
    assert build.GRAPH_SOURCE in cmd and build.RUNNER_SOURCE in cmd
    assert f"-I{os.path.join(build.cuda_home(), 'include')}" in cmd and "-lcudart" in cmd
    assert f"-Wl,-rpath,{os.path.join(build.cuda_home(), 'lib64')}" in cmd
    runner_text, graph_text = open(build.RUNNER_SOURCE).read(), open(build.GRAPH_SOURCE).read()
    for fn in ("wtt_graph_side_stream", "wtt_graph_new", "wtt_graph_register_generator",
               "wtt_graph_capture_begin", "wtt_graph_capture_end", "wtt_graph_replay"):  # fmt: skip
        assert f"int {fn}(" in runner_text and f"int {fn}(" in graph_text  # declared by hand
    for fn in ("wtt_greedy_argmax_state", "wtt_beam_update_state"):
        assert f"{fn}(" in runner_text
    assert "cuda_runtime" not in runner_text and "ATen/cuda" not in runner_text


def test_graph_unit_source_compiles(tmp_path):
    """csrc/wtt_graph.cpp with the build's flags, -fsyntax-only, where the
    CUDA toolkit's headers are installed (a CPU build of torch leaves them
    out: then it skips)."""
    cmd = build.runner_command(str(tmp_path / "runner"), kernels_build.library_path())
    if not os.path.isfile(os.path.join(build.cuda_home(), "include", "cuda_runtime_api.h")):
        pytest.skip(f"no CUDA headers under {build.cuda_home()}: the unit compiles on the card's machine")
    flags = [a for a in cmd[1:] if a.startswith(("-std=", "-D", "-I", "-W")) and not a.startswith("-Wl,")]
    out = subprocess.run([cmd[0], "-fsyntax-only", *flags, build.GRAPH_SOURCE],
                         capture_output=True, text=True, timeout=300)  # fmt: skip
    assert out.returncode == 0, out.stderr[-4000:]
