"""The decoding loop: prefill, then one decoder step and one filtered update
per token, on the model's device.

The counterpart of whisper_tpu/engine_fused.py (FusedEngine.run keeps its
arguments and output contract). Prefill runs once per audio and its K/V is
broadcast to the audio's G rows; step 0 updates on the prefill's logits
(the greedy_argmax or beam_update kernel's scalar launch at temperature 0,
the plain filters and a draw when sampling). Every later token is one pass
of the loop body, a function on static buffers (`_Program`):

    step at the cache window W (graphs.decode_step_fixed: the beam reorder,
    the K/V write and the attention over the first W slots) -> update (the
    kernels' loop-state launches, greedy_argmax_state / beam_update_state,
    or the filters and a draw) -> token write -> the loop state's advance
    (n_tokens, step) -> the done flag

whose loop scalars live in a device int32 array, the loop state (n_tokens,
sample_begin, step, live; ops/beam_kernel.py). On CUDA the body is captured
as a torch.cuda.CUDAGraph once per key (audios, group, mode, window, weights
mode, timestamp rules, pool size) and replayed once per token, in the JAX
engine's bucketed cache phases (128, 256, 448 slots; the cache is allocated
at the smallest bucket that holds the decode). The host knows n_tokens =
n_initial + steps, so it stops at sample_len, at 448 and at each phase's
edge without reading the card; only "every row is done" comes from the card,
as a pinned copy of the live flag that each pass writes. After each pass
the host reads the flag as the pass DONE_LAG passes back left it, waiting
on that pass's CUDA event only, so DONE_LAG passes stay queued on the card
while it reads. Once every row is done, live is 0: the update kernels
write nothing, the state stops advancing, and a replay changes no output.
On the CPU the same body runs eagerly (the port's parity tests run the
body the card captures); `capture = False` runs it eagerly on the card
too. A capture or a replay
that fails raises: nothing falls back to the uncaptured body.

On a mesh (parallel/serve.py) the body carries the mesh's collectives: the
tp / sp reductions of the step, the done flag's not-done count all-reduced
over dp (`_live`), and at T > 0 the draw's gather over dp. Whether a run
captures is decided before it starts, from the groups' backends
(comm.capturable): it captures when every group the body uses is NCCL or
has one rank; over gloo, whose collectives run on host threads, the body
runs uncaptured on the card. `EngineRun.captured` records which. Every
rank must issue the same collectives in the same order, so every rank
runs the same passes: the host stops on n (the same on every rank) and on
the whole batch's done flag, the same on every rank, read DONE_LAG passes
late; the program keys, captures and evictions follow the same calls. A
rank whose rows are all done keeps stepping (live writes nothing) until
every row of the batch is done, as the JAX while_loop's cond runs over
the sharded batch.

`FusedEngine(model, weights="int8")` decodes with weight-only int8 (quant.py):
the engine quantizes the model's decoder once, on first use, and keeps the
quantized tree; each run quantizes the window's cross-K/V before the
prefill. The model's own parameters are left as they are. `model_engine`
gives a model's cached engine, one quantized tree per model and mode: a
parallel.serve.DataParallelEngine when the model has a mesh (set_mesh).

The host loop (`_run_eager`, `eager_loop = True`: `graphs.decode_step`,
the kernels' scalar launches and a host read of the done flag each step)
stays as a comparison variant; no engine runs it on its main path.
"""

import collections
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import profiling, quant
from .comm import all_gather, all_reduce, capturable, group_size, local_slice
from .models import graphs
from .ops.beam_kernel import (
    LIVE, N_TOKENS, SAMPLE_BEGIN, STATE_LEN, apply_filters, beam_update, beam_update_state,
    build_penalty_vectors, greedy_argmax, greedy_argmax_state,
)  # fmt: skip

HISTORY_RUNS = 1024  # runs kept in FusedEngine.history; the oldest drop out
PHASES = (128, 256, graphs.CACHE_SLOTS)  # the cache windows of the loop's phases
# passes queued behind the host's read of the done flag: at 0 the card
# idles for a host round trip each pass; a finish is seen up to DONE_LAG
# passes late, and those passes change nothing (PERF.md §6 has the card's
# numbers behind the choice)
DONE_LAG = 1
MAX_PROGRAMS = 8  # static buffer sets (with their graphs) kept per engine


class EngineRun(NamedTuple):
    """One FusedEngine.run, as `history` keeps it."""

    beam_search: bool
    temperature: float
    steps: int  # tokens decoded per row (step 0 included)
    seconds: float  # host wall of the run, the final read included
    loop: str = "program"  # "program" (the loop body) or "eager" (the host loop, eager_loop)
    replays: int = 0  # replays of a captured body
    bodies: int = 0  # uncaptured body passes: the CPU, capture off, capture warm-ups
    captures: int = 0
    capture_s: float = 0.0
    done_reads: int = 0  # host reads of the done flag
    program: tuple = ()  # the static buffers' key (audios, group, pool size, last window)
    groups: tuple = ()  # the sizes of the groups the body reduces over (tp, sp, dp), in the key
    recaptures: int = 0  # captures of a graph this engine had made before (its buffers dropped)
    captured: bool = False  # the body replayed from graphs (decided before the run), else run uncaptured


def _last_window(n_initial: int, sample_len: int) -> int:
    """The smallest bucket that holds the decode (engine_fused.py's
    last_window): the cache slots a run allocates."""
    max_tokens = min(n_initial + sample_len, graphs.CACHE_SLOTS)
    return next(w for w in PHASES if max_tokens <= w)


def _like(x):
    """A zeroed buffer of x's structure (a tensor or an int8 pair)."""
    return tuple(torch.zeros_like(t) for t in x) if isinstance(x, tuple) else torch.zeros_like(x)


def _copy(dst, src):
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


class _Program:
    """The static buffers of one (audios, group, pool size, last window,
    cross-K/V layout) that the loop body reads and writes, and the body's
    graphs by (mode, window, filters). A graph replays at the buffers'
    addresses, so every run of the key copies its inputs in."""

    def __init__(self, model, dec, A, G, MC, last_window, ck, cv, d):
        """A: this rank's audios; d: the cache's width, the model's d / tp."""
        dev = model.device
        B = A * G
        L, V = model.dims.n_text_layer, model.dims.n_vocab
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.dec = dec  # the tree the graphs read: kept alive with them
        self.G, self.MC = G, MC
        self.tokens = torch.zeros((B, graphs.CACHE_SLOTS), **i32)
        self.cache = torch.zeros((L, 2, B, last_window, d), dtype=model.compute_dtype, device=dev)
        self.sum_lp = torch.zeros(B, **f32)
        self.pool_tokens = torch.zeros((A, MC, graphs.CACHE_SLOTS + 1), **i32)
        self.pool_scores = torch.zeros((A, MC), **f32)
        self.pool_lengths = torch.zeros((A, MC), **i32)
        self.pool_count = torch.zeros(A, **i32)
        self.state = torch.zeros(STATE_LEN, **i32)
        self.state_host = torch.zeros(STATE_LEN, dtype=torch.int32, pin_memory=dev.type == "cuda")
        self.identity = torch.arange(B, **i32)
        self.src = torch.arange(B, **i32)
        self.advance = torch.tensor([1, 0, 1, 0], **i32)  # + live: n_tokens and step
        self.suppress = torch.zeros(V, **f32)
        self.begin = torch.zeros(V, **f32)
        # sampling: logits scaled by 1 / T as a division by the Python float
        # is on the device (CUDA: times the f32 reciprocal; CPU: divided)
        self.t_scale = torch.ones(1, **f32)
        self.gen = torch.Generator(device=dev)
        self.ck, self.cv = _like(ck), _like(cv)
        # the update kernels' outputs (a replay writes the same addresses)
        self.tok_out = torch.zeros(B, **i32)
        self.lp_out = torch.zeros(B, **f32)
        self.new_tokens = torch.zeros_like(self.tokens)
        self.src_out = torch.zeros(B, **i32)
        self.new_lp = torch.zeros(B, **f32)
        self.live_host = torch.zeros(1, dtype=torch.int32, pin_memory=dev.type == "cuda")
        self.graphs = {}  # (mode, window, filters) -> CUDAGraph

    def start(self, first, G, kv, n_initial, ck, cv, suppress, begin, temperature, seed):
        """This run's inputs into the buffers: tokens, the prefill's K/V
        (every audio's in its G rows), zeroed sums and pools, the loop
        state at step 0, the penalties, the cross-K/V, T and the seed."""
        self.tokens.zero_()
        self.tokens[:, :n_initial] = first.repeat_interleave(G, dim=0)
        self.cache.zero_()
        self.cache[:, :, :, :n_initial] = kv.repeat_interleave(G, dim=2)
        self.sum_lp.zero_()
        self.pool_tokens.zero_()
        self.pool_scores.fill_(float("-inf"))
        self.pool_lengths.zero_()
        self.pool_count.zero_()
        self.src.copy_(self.identity)
        # from pinned memory, without a synchronization: the last run's copy
        # ended before its outputs were read
        self.state_host.copy_(torch.tensor([n_initial, n_initial, 0, 1], dtype=torch.int32))
        self.state.copy_(self.state_host, non_blocking=True)
        self.suppress.copy_(suppress)
        self.begin.copy_(begin)
        _copy(self.ck, ck)
        _copy(self.cv, cv)
        t = np.float32(max(temperature, 1e-6))
        self.t_scale.fill_(float(np.float32(1) / t) if self.t_scale.is_cuda else float(t))
        self.gen.manual_seed(int(seed))

    def scaled(self, logits):
        return logits * self.t_scale if self.t_scale.is_cuda else logits / self.t_scale


class FusedEngine:
    """Runs decode windows for one model; keeps the penalty vectors of the
    last suppression sets on the device, and the loop's static buffers and
    graphs of the latest MAX_PROGRAMS keys."""

    # the process groups the loop reduces over (parallel/serve.py sets
    # them): tensor parallel over heads, the frame split of the cross-K/V,
    # the batch split (the done flag and the draw)
    _tp = None
    _sp = None
    _dp = None
    eager_loop = False  # True: the host loop (_run_eager), a comparison variant
    capture = True  # on CUDA, replay the captured body (False: run it eagerly)

    def __init__(self, model, weights: str = ""):
        self.model = model
        self.weights = quant.check_weights_mode(weights)
        self._dec_params = None
        self._pen_cache = {}
        self._programs = collections.OrderedDict()
        self._captured = set()  # (program key, graph key) of every capture made
        self._pool = None  # the graphs' shared memory pool
        self._stream = None  # the side stream of warm-ups and captures
        # EngineRun of the latest runs: callers read it to count the updates
        # that went through each kernel (steps, replays, uncaptured passes)
        self.history = collections.deque(maxlen=HISTORY_RUNS)

    def _penalties(self, suppress_ids, blank_ids, **kw):
        key = (tuple(suppress_ids), tuple(blank_ids), tuple(sorted(kw.items())))
        if key not in self._pen_cache:
            V = self.model.dims.n_vocab
            sup, beg = build_penalty_vectors(V, suppress_ids, blank_ids, **kw)
            dev = self.model.device
            self._pen_cache = {key: (torch.from_numpy(sup).to(dev), torch.from_numpy(beg).to(dev))}
        return self._pen_cache[key]

    def _decoder_params(self):
        """The decoder tree the loop reads: the model's own, or in int8 mode
        a quantized copy made on first use."""
        if self._dec_params is None:
            dec = self.model.params["decoder"]
            self._dec_params = quant.quantize_decoder(dec) if self.weights == "int8" else dec
        return self._dec_params

    def _live(self, done):
        """int32 (1,) on the device: 1 while some row of the whole batch is
        not done. The not-done count is all-reduced over dp on the device,
        so every rank holds the same flag."""
        left = (~done).sum(dtype=torch.int32).reshape(1)
        return (all_reduce(left, self._dp) > 0).to(torch.int32)

    def _all_done(self, done) -> bool:
        """Whether the host loop may stop: every row is done (its per-step
        host read)."""
        return not int(self._live(done))

    def _draw(self, probs, gen):
        """One sampled token id per row of `probs` (B, V): torch.multinomial's
        draw of one sample (argmax of probs over Exp(1) noise from `gen`),
        without its host-side checks, so that a graph can capture it. Over
        dp, the whole batch's draw (probs all-gathered) with the shared
        generator, then this rank's rows: the single-device engine's draws."""
        probs = all_gather(probs, self._dp)
        q = torch.empty_like(probs).exponential_(1, generator=gen)
        return local_slice((probs / q).argmax(dim=-1), self._dp, 0)

    @profiling.timed("fused_decode")
    @torch.inference_mode()
    def run(
        self,
        initial_tokens,
        ck,
        cv,
        *,
        sot_index: int,
        suppress_ids,
        blank_ids,
        max_initial_ts_index: Optional[int],
        sample_len: int,
        n_group: int,
        beam_search: bool,
        max_candidates: int,
        use_timestamps: bool,
        temperature: float,
        eot: int,
        timestamp_begin: int,
        no_timestamps: int,
        no_speech: int,
        rng_seed: int = 0,
    ):
        """Returns numpy (tokens (B, 448), n_tokens, sum_logprobs (B,),
        no_speech (A,), finished_tokens (A, MC, 449), finished_scores,
        finished_lengths, finished_count (A,)) with B = A * n_group
        audio-major, as the JAX engine's FusedEngine.run returns."""
        t0 = time.perf_counter()
        model = self.model
        dev = model.device
        dec = self._decoder_params()
        n_ctx = graphs.CACHE_SLOTS
        G = n_group

        initial_tokens = np.asarray(initial_tokens, dtype=np.int32)
        if initial_tokens.ndim == 1:
            initial_tokens = initial_tokens[None, :]
        A, n_initial = initial_tokens.shape
        if n_initial > graphs.PREFILL_LEN:
            raise ValueError(
                f"initial tokens ({n_initial}) exceed the "
                f"{graphs.PREFILL_LEN}-token prefill window; trim the prompt"
            )
        # the JAX engine caps the first timestamp at n_ctx when no maximum
        # is set; the port keeps that behaviour
        pens = self._penalties(
            suppress_ids, blank_ids, use_timestamps=use_timestamps,
            no_timestamps=no_timestamps, timestamp_begin=timestamp_begin,
            max_initial_ts_index=(
                max_initial_ts_index if max_initial_ts_index is not None else n_ctx
            ),
        )  # fmt: skip
        filt = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)
        MC = max(max_candidates, 1)
        mode = "beam" if beam_search else "greedy" if temperature == 0 else "sample"

        toks = np.zeros((A, n_ctx), dtype=np.int32)
        toks[:, :n_initial] = initial_tokens
        first = torch.from_numpy(toks).to(dev)

        if self.weights == "int8":
            ck, cv = quant.quantize_cross_kv(ck, cv)

        # ---- prefill, once per audio ----
        hidden, kv = graphs.prefill(
            dec, first[:, :n_initial], n_initial, ck, cv, n_head=model.dims.n_text_head,
            tp=self._tp, sp=self._sp,
        )  # fmt: skip
        logits = graphs.hidden_to_logits(dec, hidden[:, n_initial - 1])  # (A, V)
        sot_logits = graphs.hidden_to_logits(dec, hidden[:, sot_index])
        no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, no_speech]
        logits = logits.repeat_interleave(G, dim=0)

        args = (dec, first, kv, logits, ck, cv, pens, filt, mode, G, MC, n_initial, sample_len)
        if self.eager_loop:
            out, record = self._run_eager(*args, temperature, rng_seed)
        else:
            out, record = self._run_program(*args, temperature, rng_seed)
        out = (out[0], out[1], out[2], no_speech_prob.float().cpu().numpy(), *out[3:])
        self.history.append(EngineRun(
            beam_search, float(temperature), record.pop("steps"), time.perf_counter() - t0, **record
        ))  # fmt: skip
        return out

    # ---- the loop as a program ---------------------------------------------

    def _program(self, dec, A, G, MC, last_window, ck, cv, sizes):
        """The static buffers of this key (least recently used dropped past
        MAX_PROGRAMS, with their graphs). `sizes`, of the groups the body
        reduces over, is in the key: a graph bakes in its collectives, so a
        run that splits its batch over dp never replays a graph captured by
        one that did not (or the reverse) at the same local shapes."""
        layout = tuple((t.shape, t.dtype) for t in (ck if isinstance(ck, tuple) else (ck,)))
        key = (A, G, MC, last_window, layout, sizes, id(dec))
        p = self._programs.pop(key, None)
        if p is None:
            d = self.model.dims.n_text_state // group_size(self._tp)
            p = _Program(self.model, dec, A, G, MC, last_window, ck, cv, d)
        self._programs[key] = p
        while len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
        return key, p

    def _step(self, p, W, beam):
        """The decoder step at cache window W: the previous update's reorder
        (beam), the K/V of the last token at slot n_tokens - 1, the logits."""
        B = p.tokens.shape[0]
        pos = p.state[N_TOKENS : N_TOKENS + 1] - 1
        last = p.tokens.gather(1, pos.long().expand(B)[:, None])[:, 0]
        logits, _ = graphs.decode_step_fixed(
            p.dec, last, pos, p.cache, p.src if beam else None, p.ck, p.cv,
            n_head=self.model.dims.n_text_head, window=W, tp=self._tp, sp=self._sp,
        )  # fmt: skip
        return logits

    def _update(self, p, logits, mode, filt, first_n=None):
        """The update on `logits`, the token write, the loop state's advance
        and the done flag (the whole batch's, `_live`). first_n: step 0's
        n_tokens, a host int (the kernels' scalar launches); None: the loop
        state's launches."""
        st = p.state
        live = st[LIVE : LIVE + 1] != 0
        pens = (p.suppress, p.begin)
        pools = (p.pool_tokens, p.pool_scores, p.pool_lengths, p.pool_count)
        if mode == "beam":
            if first_n is not None:
                new_tokens, src, new_lp = beam_update(
                    logits, p.tokens, p.sum_lp, *pools, first_n, first_n, 0, *pens,
                    n_group=p.G, **filt,
                )  # fmt: skip
            else:
                new_tokens, src, new_lp = beam_update_state(
                    logits, p.tokens, p.sum_lp, *pools, st, *pens, p.new_tokens, p.src_out,
                    p.new_lp, n_group=p.G, **filt,
                )  # fmt: skip
            p.tokens.copy_(torch.where(live[:, None], new_tokens, p.tokens))
            p.src.copy_(torch.where(live, src, p.identity))
            p.sum_lp.copy_(torch.where(live, new_lp, p.sum_lp))
            done = p.pool_count >= p.MC
        else:
            if mode == "greedy":
                if first_n is not None:
                    tok, lp = greedy_argmax(logits, p.tokens, first_n, first_n, *pens, **filt)
                else:
                    tok, lp = greedy_argmax_state(
                        logits, p.tokens, st, *pens, p.tok_out, p.lp_out, **filt
                    )
            else:
                n = (first_n, first_n) if first_n is not None else (st[N_TOKENS], st[SAMPLE_BEGIN])
                filtered = apply_filters(logits, p.tokens, *n, *pens, **filt)
                tok = self._draw(torch.softmax(p.scaled(filtered), dim=-1), p.gen).to(torch.int32)
                lp = torch.log_softmax(filtered, dim=-1).gather(1, tok[:, None].long())[:, 0]
            done = self._greedy_tail(p, tok, lp, live, filt["eot"])
        # one more token where live; live stays while some row is not done
        st.add_(p.advance * st[LIVE])
        st[LIVE : LIVE + 1].mul_(self._live(done))
        p.live_host.copy_(st[LIVE : LIVE + 1], non_blocking=True)

    @staticmethod
    def _greedy_tail(p, tok, lp, live, eot):
        """GreedyDecoder.update's tail where live: rows that already ended
        stay at EOT, the log-probability adds up, the token goes to slot
        n_tokens. Returns the rows' done flags."""
        B = tok.shape[0]
        nt = p.state[N_TOKENS : N_TOKENS + 1].long().expand(B)[:, None]
        already = p.tokens.gather(1, nt - 1)[:, 0] == eot
        p.sum_lp.copy_(torch.where(live, p.sum_lp + torch.where(already, 0.0, lp), p.sum_lp))
        nxt = torch.where(already, eot, tok)
        nxt = torch.where(live, nxt, p.tokens.gather(1, nt)[:, 0])
        p.tokens.scatter_(1, nt, nxt[:, None])
        return nxt == eot

    def _capture(self, p, body, sampling):
        """A CUDAGraph of `body`. The warm-up runs on the capture's side
        stream with live = 0 (it writes nothing but slot n_tokens - 1's
        K/V, which the next pass rewrites, and applies the pending beam
        reorder, after which src is the identity); the loop state, the
        pinned live flag and the generator are put back."""
        saved = p.state.clone()
        gen_state = p.gen.get_state() if sampling else None
        p.state[LIVE] = 0
        if self._stream is None:
            self._stream = torch.cuda.Stream(p.state.device)
            self._pool = torch.cuda.graph_pool_handle()
        s = self._stream
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            body()
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        if sampling:
            graph.register_generator_state(p.gen)
        with torch.cuda.graph(graph, pool=self._pool, stream=s, capture_error_mode="thread_local"):
            body()
        p.state.copy_(saved)
        # the warm-up's flag (0) would reach the host's next read of an
        # earlier pass's flag: put back the live flag it replaced
        p.live_host.copy_(saved[LIVE : LIVE + 1])
        if sampling:
            p.gen.set_state(gen_state)
        return graph

    def _run_program(self, dec, first, kv, logits, ck, cv, pens, filt, mode, G, MC,
                     n_initial, sample_len, temperature, rng_seed):  # fmt: skip
        """Step 0 eagerly, then the body once per token: replayed from its
        graph on CUDA (captured at a key's first use), run eagerly on the
        CPU, with `capture` off, or where a group the body reduces over
        cannot be captured (gloo)."""
        A = first.shape[0]
        n_ctx = graphs.CACHE_SLOTS
        last_window = _last_window(n_initial, sample_len)
        groups = (self._tp, self._sp, self._dp)
        sizes = tuple(group_size(g) for g in groups)
        key, p = self._program(dec, A, G, MC, last_window, ck, cv, sizes)
        p.start(first[:, :n_initial], G, kv, n_initial, ck, cv, *pens, temperature, rng_seed)
        self._update(p, logits, mode, filt, first_n=n_initial)

        # decided before the run, from the groups' backends
        capture = p.state.is_cuda and self.capture and capturable(groups)
        rec = dict(replays=0, bodies=0, captures=0, capture_s=0.0, done_reads=0, recaptures=0,
                   captured=capture)  # fmt: skip
        n, step = n_initial + 1, 1
        pending = collections.deque()  # the passes whose done flag is unread
        for W in (w for w in PHASES if w <= last_window):
            limit = W if W < last_window else n_ctx  # a phase writes slots below W

            def body(W=W):
                self._update(p, self._step(p, W, mode == "beam"), mode, filt)

            if not (step < sample_len and n < limit):
                continue
            graph = None
            if capture:
                graph_key = (mode, W, tuple(sorted(filt.items())))
                if graph_key not in p.graphs:
                    t0 = time.perf_counter()
                    p.graphs[graph_key] = self._capture(p, body, mode == "sample")
                    rec["captures"] += 1
                    rec["capture_s"] += time.perf_counter() - t0
                    rec["bodies"] += 1  # the warm-up
                    rec["recaptures"] += (key, graph_key) in self._captured
                    self._captured.add((key, graph_key))
                graph = p.graphs[graph_key]
            done = None
            while step < sample_len and n < limit:
                if graph is not None:
                    graph.replay()
                    rec["replays"] += 1
                else:
                    body()
                    rec["bodies"] += 1
                n, step = n + 1, step + 1
                done = self._read_done(p, pending)
                rec["done_reads"] += done is not None
                if done:
                    break
            if done:
                break

        n_final = int(p.state[N_TOKENS])
        # copies: the buffers are the next run's
        host = (p.tokens, p.sum_lp, p.pool_tokens, p.pool_scores, p.pool_lengths, p.pool_count)
        tokens, sum_lp, *pools = (t.to("cpu", copy=True).numpy() for t in host)
        return (tokens, n_final, sum_lp, *pools), dict(
            rec, steps=n_final - n_initial, program=(A, G, MC, last_window), groups=sizes
        )

    @staticmethod
    def _read_done(p, pending):
        """After a pass: whether every row is done, as the pass DONE_LAG
        passes back (or a later one) left the flag, or None while fewer
        passes are pending. On the card it waits for that pass's event only;
        on the CPU it keeps each pass's flag and reads the one DONE_LAG
        passes back, as the card would at the latest."""
        if p.state.is_cuda:
            event = torch.cuda.Event()
            event.record()
            pending.append(event)
            if len(pending) <= DONE_LAG:
                return None
            pending.popleft().synchronize()
            return not int(p.live_host[0])
        pending.append(int(p.live_host[0]))
        if len(pending) <= DONE_LAG:
            return None
        return not pending.popleft()

    # ---- the host loop (a comparison variant, eager_loop) ---------------------

    def _run_eager(self, dec, first, kv, logits, ck, cv, pens, filt, mode, G, MC,
                   n_initial, sample_len, temperature, rng_seed):  # fmt: skip
        """One host iteration per token: `graphs.decode_step` (with the
        mesh's collectives), the kernels' scalar launches, a host read of
        `completed` each step (`_all_done`). No engine runs it on its main
        path: the smoke and the tests hold the loop body against it."""
        model = self.model
        dev = model.device
        n_ctx = graphs.CACHE_SLOTS
        A = first.shape[0]
        B = A * G
        suppress_pen, begin_pen = pens
        eot = filt["eot"]
        cache = model.kv_to_cache_grouped(kv, G)
        tokens = first.repeat_interleave(G, dim=0)  # (B, 448)
        sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
        pool_tokens = torch.zeros((A, MC, n_ctx + 1), dtype=torch.int32, device=dev)
        pool_scores = torch.full((A, MC), float("-inf"), dtype=torch.float32, device=dev)
        pool_lengths = torch.zeros((A, MC), dtype=torch.int32, device=dev)
        pool_count = torch.zeros(A, dtype=torch.int32, device=dev)
        gen = None
        if mode == "sample":
            gen = torch.Generator(device=dev).manual_seed(int(rng_seed))

        n_tokens = n_initial
        src = None
        step = 0
        while True:
            if step > 0:
                logits, cache = graphs.decode_step(
                    dec, tokens[:, n_tokens - 1], n_tokens - 1, cache, src, ck, cv,
                    n_head=model.dims.n_text_head, tp=self._tp, sp=self._sp,
                )  # fmt: skip
            if mode == "beam":
                tokens, src, sum_lp = beam_update(
                    logits, tokens, sum_lp, pool_tokens, pool_scores, pool_lengths,
                    pool_count, n_tokens, n_initial, step, suppress_pen, begin_pen,
                    n_group=G, **filt,
                )  # fmt: skip
                done = pool_count >= MC
            else:
                if mode == "greedy":
                    next_tok, current = greedy_argmax(
                        logits, tokens, n_tokens, n_initial, suppress_pen, begin_pen, **filt
                    )
                else:
                    filtered = apply_filters(
                        logits, tokens, n_tokens, n_initial, suppress_pen, begin_pen, **filt
                    )
                    probs = torch.softmax(filtered / max(temperature, 1e-6), dim=-1)
                    next_tok = self._draw(probs, gen).to(torch.int32)
                    lps = torch.log_softmax(filtered, dim=-1)
                    current = lps.gather(1, next_tok[:, None].long())[:, 0]
                # GreedyDecoder.update tail: rows that already ended stay at EOT
                already_done = tokens[:, n_tokens - 1] == eot
                sum_lp = sum_lp + torch.where(already_done, 0.0, current)
                next_tok = torch.where(already_done, eot, next_tok)
                tokens[:, n_tokens] = next_tok
                done = next_tok == eot
            n_tokens += 1
            step += 1
            completed = self._all_done(done)
            if completed or step >= sample_len or n_tokens >= n_ctx:
                break

        out = (
            tokens.cpu().numpy(), n_tokens, sum_lp.cpu().numpy(), pool_tokens.cpu().numpy(),
            pool_scores.cpu().numpy(), pool_lengths.cpu().numpy(), pool_count.cpu().numpy(),
        )  # fmt: skip
        return out, dict(loop="eager", steps=step)


def model_engine(model, weights: str = "") -> FusedEngine:
    """The model's cached engine for `weights`, built (and cached on the
    model in place of one of another mode) when it has none: each model
    holds one quantized decoder tree and one set of penalty vectors. A
    model with a mesh (set_mesh) gets a DataParallelEngine on it."""
    weights = quant.check_weights_mode(weights)
    mesh = getattr(model, "mesh", None)
    engine = getattr(model, "_fused_engine", None)
    if engine is None or engine.weights != weights or getattr(engine, "mesh", None) is not mesh:
        if mesh is None:
            engine = FusedEngine(model, weights=weights)
        else:
            from .parallel.serve import DataParallelEngine

            engine = DataParallelEngine(model, mesh, weights=weights)
        model._fused_engine = engine
    return engine
