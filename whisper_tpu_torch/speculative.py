"""Speculative greedy decoding: a small draft model proposes K tokens, the
target model checks them in one decoder pass (the counterpart of
whisper_tpu/speculative.py, fused_decode_spec).

Every emitted token is the target's filtered argmax given the same prefix,
so the output is the greedy engine's whatever the draft: the draft only
decides how many positions one verify pass confirms. (In float32; with
bf16 or int8 weights the verify pass's products have other shapes than the
step's, and a near-tie may go the other way.)

A run prefills both models and picks step 0's token from the target's
prefill logits eagerly (the greedy kernel's scalar launch). Every verify
round is then one pass of the round body, a function on static buffers
(`_SpecProgram`, one per (audios, K, last window, cross-K/V layouts,
decoder trees); both caches at the last window, the smallest of 128, 256
and 448 slots that holds n_initial + sample_len + K + 1, as
fused_decode_spec allocates them). One pass is one round of
fused_decode_spec's outer while_loop:

  * K + 1 draft passes, each masked by active = ~done & (p_d < n + K - 1):
    `graphs.decode_chunk` of width 1 at the window, the greedy kernel's
    per-row loop-state launch (greedy_argmax_rows_state) at lengths
    p_d + 1, the candidate written where it lies at n or past it. A pass
    with no active row writes nothing, so K or K + 1 of them are live, as
    many as the JAX inner loop's steps;
  * one verify `decode_chunk` over [t_{n-1}, c_0 .. c_{K-1}] at the window,
    then one launch over A * (K + 1) rows at lengths n[a] + j;
  * the acceptance, on the device: the accepted prefix, cut at the first
    EOT and at the limit; the kept tokens scattered; sum_logprobs; the
    draft rolled back to what it fed correctly; rounds, n, done; the live
    flag of the round's loop state (ops/beam_kernel.py: the launches read
    SAMPLE_BEGIN and LIVE from it), copied to pinned memory for the host.
Every store is masked by the live rows and the live flag, and the launches
write nothing at live = 0, so a pass after every row is done changes no
output. On CUDA the body is captured as a CUDA graph once per key and
filters (engine.FusedEngine._capture, in the target engine's graph pool)
and replayed once per round; after each replay the host reads the done
flag of the pass engine.DONE_LAG back (FusedEngine._read_done) and stops
when every row is done, or after sample_len - 1 passes (a live row gains a
token a round). The CPU runs the same body eagerly (the port's parity
tests run it); `capture = False` runs it eagerly on the card. A capture or
a replay that fails raises: nothing falls back to another loop.

On a mesh (parallel/serve.py) the round carries the tp / sp collectives
of both models' chunks (a draft whose heads tp does not divide stays
replicated). Whether a run captures is decided before it starts
(comm.capturable): when every group the round uses is NCCL or has one
rank; over gloo the round runs uncaptured on the card. `SpecRun.captured`
records which. The dp groups run their rounds independently, each on its
own rows' flag; the ranks of one dp group see the same logits and the
same flag, so they run the same passes and issue the same collectives.

The host loop (`_run_eager`, `eager_loop = True`: each round reads every
row's n, draft position and done flag to the host; the greedy kernel's
per-row launch) stays as a comparison variant; no engine runs it on its
main path.

Greedy at temperature 0 only: the fallback ladder and beam search run on
engine.FusedEngine. Profiler ranges (torch.profiler.record_function):
"spec_round" around each replay or body pass and "spec_read" around each
done read; the eager loop marks "spec_draft_step", "spec_verify" and
"spec_read".
"""

import collections
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import profiling, quant
from .comm import capturable, group_size
from .engine import HISTORY_RUNS, MAX_PROGRAMS, PHASES, FusedEngine, _copy, _like, model_engine
from .models import graphs
from .ops import beam_kernel as bk
from .ops.beam_kernel import LIVE, STATE_LEN, greedy_argmax, greedy_argmax_rows_state

_ROWS_STATE = bk.STATE_KERNELS.index("greedy_argmax_rows_state")  # its counter on the card


def _accept(tokens, g, t_in, n, live, limit, eot):
    """The round's acceptance (fused_decode_spec's): the draft's accepted
    prefix m, then the target's tokens g_0 .. g_m kept, cut at the first
    EOT and at `limit`, for the `live` rows, and written into `tokens` at
    n .. n + m. g (A, K + 1) is the target's pick at each verify position,
    t_in (A, K + 1) the verify pass's input [t_{n-1}, c_0 .. c_{K-1}].
    Returns (m, keep (A, K + 1), tokens kept (A,), rows that kept EOT)."""
    K = t_in.shape[1] - 1
    j = torch.arange(K + 1, dtype=torch.int32, device=g.device)
    m = (g[:, :K] == t_in[:, 1:]).int().cumprod(dim=1).sum(dim=1, dtype=torch.int32)
    is_eot = (g == eot).int()
    keep = (
        live[:, None] & (j <= m[:, None]) & (n[:, None] + j < limit)
        & (is_eot.cumsum(dim=1) - is_eot == 0)
    )  # fmt: skip
    cols = (n[:, None] + j).long().clamp(max=tokens.shape[1] - 1)
    tokens.scatter_(1, cols, torch.where(keep, g, tokens.gather(1, cols)))
    return m, keep, keep.sum(dim=1, dtype=torch.int32), (keep & (is_eot != 0)).any(dim=1)


class SpecRun(NamedTuple):
    """One SpeculativeEngine.run, as `history` keeps it."""

    launches: int  # greedy launches: step 0's, then the loop's (the round body's counted on the card)
    draft_steps: int  # draft passes with an active row (the JAX inner loop's steps)
    rounds: int  # verify passes with a live row (the JAX outer loop's rounds)
    steps: int  # tokens decoded (the longest row's)
    seconds: float  # host wall of the run, the final read included
    loop: str = "program"  # "program" (the round body) or "eager" (the host loop, eager_loop)
    k: int = 4
    replays: int = 0  # replays of a captured body
    bodies: int = 0  # uncaptured body passes: the CPU, capture off, the capture's warm-up
    captures: int = 0
    capture_s: float = 0.0
    done_reads: int = 0  # host reads of the done flag
    program: tuple = ()  # the static buffers' key (audios, K, last window)
    groups: tuple = ()  # the sizes of the groups the round reduces over (target tp, draft tp, sp)
    recaptures: int = 0  # captures of a graph this engine had made before (its buffers dropped)
    captured: bool = False  # the round replayed from its graph (decided before the run), else uncaptured


class _SpecProgram:
    """The static buffers of one key that the round body reads and writes,
    and the body's graphs by filters. A graph replays at the buffers'
    addresses, so every run of the key copies its inputs in."""

    def __init__(self, target, draft, dec_t, dec_d, A, K, last_window, ckv, dckv, widths):
        """A: this rank's audios; widths: each cache's width, its model's
        d / tp (target, draft)."""
        dev = target.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        pinned = dev.type == "cuda"
        V = target.dims.n_vocab
        self.dec_t, self.dec_d = dec_t, dec_d  # the trees the graphs read: kept alive with them
        self.K, self.window = K, last_window
        self.tokens = torch.zeros((A, graphs.CACHE_SLOTS), **i32)
        self.cache_t, self.cache_d = (
            torch.zeros((m.dims.n_text_layer, 2, A, last_window, d), dtype=m.compute_dtype, device=dev)
            for m, d in zip((target, draft), widths)
        )  # fmt: skip
        self.n = torch.zeros(A, **i32)  # verified tokens per row
        self.p_d = torch.zeros(A, **i32)  # positions fed to the draft correctly
        self.done = torch.zeros(A, dtype=torch.bool, device=dev)
        self.sum_lp = torch.zeros(A, **f32)
        self.rounds = torch.zeros(A, **i32)  # verify rounds each row took part in
        self.limit = torch.zeros(1, **i32)  # n_initial + sample_len
        self.counts = torch.zeros(2, **i32)  # passes with an active draft row, with a live row
        self.state = torch.zeros(STATE_LEN, **i32)
        self.state_host = torch.zeros(STATE_LEN, dtype=torch.int32, pin_memory=pinned)
        self.live_host = torch.zeros(1, dtype=torch.int32, pin_memory=pinned)
        self.launch_base = torch.zeros(1, dtype=torch.int64, device=dev)
        self.suppress = torch.zeros(V, **f32)
        self.begin = torch.zeros(V, **f32)
        (self.ck, self.cv), (self.dck, self.dcv) = (tuple(map(_like, x)) for x in (ckv, dckv))
        # the launches' outputs (a replay writes the same addresses)
        self.draft_tok = torch.zeros(A, **i32)
        self.draft_lp = torch.zeros(A, **f32)
        self.verify_tok = torch.zeros(A * (K + 1), **i32)
        self.verify_lp = torch.zeros(A * (K + 1), **f32)
        self.graphs = {}  # filters -> CUDAGraph

    def start(self, first, kv_t, kv_d, n_initial, sample_len, ckv, dckv, suppress, begin):
        """This run's inputs into the buffers: tokens, both prefills' K/V,
        zeroed sums and counts, n and the draft position after step 0, the
        limit, the loop state, the penalties, both cross-K/V."""
        self.tokens.copy_(first)
        for cache, kv in ((self.cache_t, kv_t), (self.cache_d, kv_d)):
            cache.zero_()
            cache[:, :, :, :n_initial] = kv
        self.sum_lp.zero_()
        self.rounds.zero_()
        self.counts.zero_()
        self.n.fill_(n_initial + 1)
        self.p_d.fill_(n_initial)
        self.limit.fill_(n_initial + sample_len)
        # from pinned memory, without a synchronization: the last run's copy
        # ended before its outputs were read
        self.state_host.copy_(torch.tensor([n_initial, n_initial, 0, 1], dtype=torch.int32))
        self.state.copy_(self.state_host, non_blocking=True)
        self.suppress.copy_(suppress)
        self.begin.copy_(begin)
        for dst, src in zip((self.ck, self.cv, self.dck, self.dcv), (*ckv, *dckv)):
            _copy(dst, src)

    def first_token(self, g0, lp0, n_initial, eot):
        """Step 0's token at slot n_initial, its log-probability, the rows
        done by it and the live flag."""
        self.tokens[:, n_initial] = g0
        self.sum_lp.copy_(lp0)
        self.done.copy_((g0 == eot) | (self.n >= self.limit))
        self.state[LIVE : LIVE + 1].copy_((~self.done).any().to(torch.int32))
        self.live_host.copy_(self.state[LIVE : LIVE + 1], non_blocking=True)


class SpeculativeEngine:
    """Greedy speculative decoding: `model` verifies, `draft_model`
    proposes `k` tokens a round. Both must share the vocabulary; the
    weights mode ("" / "bf16" or "int8") applies to both decoders and both
    cross-K/V, read from each model's cached engine (engine.model_engine).
    `last_stats` holds the latest run's per-row rounds, emitted tokens and
    draft acceptance; `history` holds a `SpecRun` of each of the latest
    runs; the static buffers and graphs of the latest MAX_PROGRAMS keys are
    kept."""

    _sp = None  # the frame split of both cross-K/V (parallel/serve.py)
    eager_loop = False  # True: the host loop (_run_eager), a comparison variant
    capture = True  # on CUDA, replay the captured round (False: run it eagerly)

    def __init__(self, model, draft_model, k: int = 4, weights: str = ""):
        if model.dims.n_vocab != draft_model.dims.n_vocab:
            raise ValueError(
                "target and draft must share a tokenizer/vocab "
                f"({model.dims.n_vocab} vs {draft_model.dims.n_vocab})"
            )
        if int(k) < 1:
            raise ValueError(f"the draft proposes at least one token a round, got k = {k}")
        self.model = model
        self.draft = draft_model
        self.k = int(k)
        # the models' cached engines: their decoder trees and penalty vectors
        self._target = self._model_engine(model, weights)
        self._draft = self._model_engine(draft_model, weights)
        self.weights = self._target.weights
        self.last_stats: Optional[dict] = None
        self.history = collections.deque(maxlen=HISTORY_RUNS)
        self._programs = collections.OrderedDict()
        self._captured = set()  # (program key, graph key) of every capture made

    def _model_engine(self, model, weights):
        return model_engine(model, weights)

    def _prefill(self, engine, first, n_initial, ck, cv):
        """(hidden (A, n, d), kv (L, 2, A, n, d)) of one model."""
        return graphs.prefill(
            engine._decoder_params(), first[:, :n_initial], n_initial, ck, cv,
            n_head=engine.model.dims.n_text_head, tp=engine._tp, sp=self._sp,
        )  # fmt: skip

    @profiling.timed("fused_decode_spec")
    @torch.inference_mode()
    def run(
        self,
        initial_tokens,
        ck,
        cv,
        draft_ck,
        draft_cv,
        *,
        sot_index: int,
        suppress_ids,
        blank_ids,
        max_initial_ts_index: Optional[int],
        sample_len: int,
        use_timestamps: bool,
        eot: int,
        timestamp_begin: int,
        no_timestamps: int,
        no_speech: int,
        temperature: float = 0.0,
        n_group: int = 1,
        beam_search: bool = False,
        max_candidates: int = 0,
        rng_seed: int = 0,
    ):
        """FusedEngine.run's greedy contract: numpy (tokens (A, 448),
        n_tokens, sum_logprobs (A,), no_speech (A,), and the empty beam pools
        (A, MC, 449), (A, MC), (A, MC), (A,)). ck/cv are the target's cross
        K/V (L, A, H, dh, 1500), draft_ck/draft_cv the draft's."""
        if beam_search or n_group != 1:
            raise ValueError("speculative decoding is greedy-only (n_group=1)")
        if temperature != 0.0:
            raise ValueError(
                "speculative decoding runs at temperature 0; use FusedEngine "
                "for the t > 0 fallback ladder"
            )
        t0 = time.perf_counter()
        n_ctx = graphs.CACHE_SLOTS
        K = self.k
        initial_tokens = np.asarray(initial_tokens, dtype=np.int32)
        if initial_tokens.ndim == 1:
            initial_tokens = initial_tokens[None, :]
        A, n_initial = initial_tokens.shape
        if n_initial > graphs.PREFILL_LEN:
            raise ValueError(
                f"initial tokens ({n_initial}) exceed the "
                f"{graphs.PREFILL_LEN}-token prefill window; trim the prompt"
            )
        if n_initial + sample_len > n_ctx - K - 1:
            # the verify chunk needs K + 1 free slots: refuse rather than
            # emit fewer tokens than the greedy engine would
            raise ValueError(
                f"initial ({n_initial}) + sample_len ({sample_len}) exceeds "
                f"{n_ctx} - K - 1 = {n_ctx - K - 1} slots; shorten "
                "sample_len or K, or use FusedEngine"
            )
        dev = self.model.device
        pens = self._target._penalties(
            suppress_ids, blank_ids, use_timestamps=use_timestamps,
            no_timestamps=no_timestamps, timestamp_begin=timestamp_begin,
            max_initial_ts_index=(
                max_initial_ts_index if max_initial_ts_index is not None else n_ctx
            ),
        )  # fmt: skip
        filt = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)
        if self.weights == "int8":
            ck, cv = quant.quantize_cross_kv(ck, cv)
            draft_ck, draft_cv = quant.quantize_cross_kv(draft_ck, draft_cv)

        toks = np.zeros((A, n_ctx), dtype=np.int32)
        toks[:, :n_initial] = initial_tokens
        first = torch.from_numpy(toks).to(dev)
        hidden, kv_t = self._prefill(self._target, first, n_initial, ck, cv)
        _, kv_d = self._prefill(self._draft, first, n_initial, draft_ck, draft_cv)
        dec_t = self._target._decoder_params()
        first_logits = graphs.hidden_to_logits(dec_t, hidden[:, n_initial - 1])
        sot_logits = graphs.hidden_to_logits(dec_t, hidden[:, sot_index])
        no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, no_speech]

        args = (first, kv_t, kv_d, first_logits, (ck, cv), (draft_ck, draft_cv), pens, filt,
                n_initial, sample_len)  # fmt: skip
        loop = self._run_eager if self.eager_loop else self._run_program
        tokens, n_row, sum_lp, rounds, record = loop(*args)

        # EOT up to the longest row (as the greedy engine pads finished rows),
        # zeros after it
        n_tokens = int(n_row.max())
        col = np.arange(n_ctx)[None, :]
        pad = np.where(col < n_tokens, eot, 0)
        tokens = np.where(col >= n_row[:, None], pad, tokens).astype(np.int32)
        emitted = n_row - n_initial
        accepted = np.maximum(emitted - 1 - rounds, 0)
        self.last_stats = {
            "rounds": rounds.tolist(),
            "emitted": emitted.tolist(),
            "draft_acceptance": (accepted / np.maximum(rounds * K, 1)).tolist(),
            "k": K,
        }
        MC = max(max_candidates, 1)
        out = (
            tokens,
            n_tokens,
            sum_lp,
            no_speech_prob.float().cpu().numpy(),
            np.zeros((A, MC, n_ctx + 1), np.int32),
            np.full((A, MC), -np.inf, np.float32),
            np.zeros((A, MC), np.int32),
            np.zeros((A,), np.int32),
        )
        self.history.append(SpecRun(
            steps=n_tokens - n_initial, seconds=time.perf_counter() - t0, k=K, **record
        ))  # fmt: skip
        return out

    # ---- the round as a program ----------------------------------------------

    def _program(self, A, last_window, ckv, dckv, sizes):
        """The static buffers of this key (least recently used dropped past
        MAX_PROGRAMS, with their graphs); `sizes`, of the groups the round
        reduces over, is in the key, as in FusedEngine._program."""
        dec_t, dec_d = self._target._decoder_params(), self._draft._decoder_params()
        layout = tuple(
            (t.shape, t.dtype) for x in (ckv[0], dckv[0]) for t in (x if isinstance(x, tuple) else (x,))
        )  # fmt: skip
        key = (A, self.k, last_window, layout, sizes, id(dec_t), id(dec_d))
        p = self._programs.pop(key, None)
        if p is None:
            widths = [e.model.dims.n_text_state // group_size(e._tp) for e in (self._target, self._draft)]
            p = _SpecProgram(self.model, self.draft, dec_t, dec_d, A, self.k, last_window, ckv, dckv, widths)
        self._programs[key] = p
        while len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
        return key, p

    def _round(self, p, filt):
        """One round of fused_decode_spec's outer loop on p's buffers: K + 1
        draft passes, the verify pass, the acceptance (see the module's
        docstring)."""
        K, W = p.K, p.window
        n_ctx = graphs.CACHE_SLOTS
        A = p.tokens.shape[0]
        st = p.state
        pens = (p.suppress, p.begin)
        n, done = p.n, p.done
        alive = ~done & (st[LIVE : LIVE + 1] != 0)

        # ---- draft: candidates for positions n .. n+K-1 ----
        for _ in range(K + 1):
            active = alive & (p.p_d < n + K - 1)
            tok_in = p.tokens.gather(1, p.p_d.long()[:, None])  # (A, 1)
            logits, _ = graphs.decode_chunk(
                p.dec_d, tok_in, p.p_d, p.cache_d, p.dck, p.dcv,
                n_head=self.draft.dims.n_text_head, active=active, width=W, tp=self._draft._tp, sp=self._sp,
            )  # fmt: skip
            write_pos = p.p_d + 1
            prop, _ = greedy_argmax_rows_state(
                logits[:, 0], p.tokens, write_pos, st, *pens, p.draft_tok, p.draft_lp, **filt
            )
            cols = write_pos.long().clamp(max=n_ctx - 1)[:, None]
            store = (active & (write_pos >= n))[:, None]  # only candidates, never a verified token
            p.tokens.scatter_(1, cols, torch.where(store, prop[:, None], p.tokens.gather(1, cols)))
            p.p_d.copy_(torch.where(active, write_pos, p.p_d))
            p.counts[0:1].add_(active.any().to(torch.int32))

        # ---- verify: one target pass over [t_{n-1}, c_0 .. c_{K-1}] ----
        j = torch.arange(K + 1, dtype=torch.int32, device=n.device)
        t_in = p.tokens.gather(1, (n[:, None] - 1 + j).long())  # (A, K + 1)
        logits, _ = graphs.decode_chunk(
            p.dec_t, t_in, n - 1, p.cache_t, p.ck, p.cv, n_head=self.model.dims.n_text_head,
            active=alive, width=W, tp=self._target._tp, sp=self._sp,
        )  # fmt: skip
        # one launch filters and picks all K + 1 positions of every row
        hist = p.tokens[:, None].expand(A, K + 1, n_ctx).reshape(A * (K + 1), n_ctx).contiguous()
        g, lp = greedy_argmax_rows_state(
            logits.reshape(A * (K + 1), -1), hist, (n[:, None] + j).reshape(-1), st, *pens,
            p.verify_tok, p.verify_lp, **filt,
        )  # fmt: skip
        g, lp = g.view(A, K + 1), lp.view(A, K + 1)

        m, keep, accept, hit_eot = _accept(p.tokens, g, t_in, n, alive, p.limit, filt["eot"])
        p.sum_lp.copy_(torch.where(alive, p.sum_lp + torch.where(keep, lp, 0.0).sum(dim=1), p.sum_lp))
        # the draft's cache is right through position n + m - 1; slot n + m
        # holds a rejected candidate's K/V unless all were accepted
        p.p_d.copy_(torch.where(alive, torch.minimum(p.p_d, n + m), p.p_d))
        p.rounds.add_(alive.to(torch.int32))
        p.counts[1:2].add_(alive.any().to(torch.int32))
        n_new = n + accept
        p.done.copy_(done | (alive & (hit_eot | (n_new >= p.limit))))
        p.n.copy_(n_new)
        # live stays while some row is not done
        st[LIVE : LIVE + 1].mul_((~p.done).any().to(torch.int32))
        p.live_host.copy_(st[LIVE : LIVE + 1], non_blocking=True)

    def _run_program(self, first, kv_t, kv_d, logits0, ckv, dckv, pens, filt, n_initial, sample_len):
        """Step 0 eagerly, then the round body once per verify round:
        replayed from its graph on CUDA (captured at a key's first use), run
        eagerly on the CPU, with `capture` off, or where a group the round
        reduces over cannot be captured (gloo). Returns (tokens (A, 448),
        n (A,), sum_logprobs (A,), rounds (A,)) in numpy and the record."""
        A = first.shape[0]
        K = self.k
        max_slots = n_initial + sample_len + K + 1
        last_window = next(w for w in PHASES if max_slots <= w)
        groups = (self._target._tp, self._draft._tp, self._sp)
        sizes = tuple(group_size(g) for g in groups)
        key, p = self._program(A, last_window, ckv, dckv, sizes)
        on_card = p.state.is_cuda
        if on_card:
            counters = bk.state_counters(p.state.device)
            p.launch_base.copy_(counters[_ROWS_STATE : _ROWS_STATE + 1])
        p.start(first, kv_t, kv_d, n_initial, sample_len, ckv, dckv, *pens)
        g0, lp0 = greedy_argmax(logits0, p.tokens, n_initial, n_initial, *pens, **filt)
        p.first_token(g0, lp0, n_initial, filt["eot"])

        # decided before the run, from the groups' backends
        capture = on_card and self.capture and capturable(groups)
        rec = dict(replays=0, bodies=0, captures=0, capture_s=0.0, done_reads=0, recaptures=0,
                   captured=capture)  # fmt: skip

        def body():
            self._round(p, filt)

        graph = None
        if capture and sample_len > 1:
            graph_key = tuple(sorted(filt.items()))
            if graph_key not in p.graphs:
                t0 = time.perf_counter()
                p.graphs[graph_key] = self._target._capture(p, body, False)
                rec["captures"] += 1
                rec["capture_s"] += time.perf_counter() - t0
                rec["bodies"] += 1  # the warm-up
                rec["recaptures"] += (key, graph_key) in self._captured
                self._captured.add((key, graph_key))
            graph = p.graphs[graph_key]
        pending = collections.deque()  # the passes whose done flag is unread
        for _ in range(sample_len - 1):
            with record_function("spec_round"):
                if graph is not None:
                    graph.replay()
                    rec["replays"] += 1
                else:
                    body()
                    rec["bodies"] += 1
            with record_function("spec_read"):
                done = FusedEngine._read_done(p, pending)
            rec["done_reads"] += done is not None
            if done:
                break

        host = [p.tokens, p.n, p.sum_lp, p.rounds, p.counts]
        if on_card:  # the round's launches, counted on the card
            host.append(counters[_ROWS_STATE : _ROWS_STATE + 1] - p.launch_base)
        tokens, n_row, sum_lp, rounds, counts, *launched = (t.to("cpu", copy=True).numpy() for t in host)
        passes = rec["replays"] + rec["bodies"]
        launched = int(launched[0][0]) if launched else (K + 2) * passes
        return tokens, n_row, sum_lp, rounds, dict(
            rec, launches=1 + launched, draft_steps=int(counts[0]), rounds=int(counts[1]),
            program=(A, K, last_window), groups=sizes,
        )  # fmt: skip

    # ---- the host loop (a comparison variant, eager_loop) ---------------------

    def _run_eager(self, first, kv_t, kv_d, logits0, ckv, dckv, pens, filt, n_initial, sample_len):
        """The host loop: each round reads every row's n, draft position and
        done flag to the host, which decide the loop and size the round's
        cache slices; the greedy kernel's scalar launch at step 0 and its
        per-row launch at each draft step and verify pass (with the mesh's
        collectives in the graphs). No engine runs it on its main path: the
        smoke and the tests hold the round body against it. Returns
        _run_program's outputs."""
        dev = self.model.device
        n_ctx = graphs.CACHE_SLOTS
        K = self.k
        A = first.shape[0]
        eot = filt["eot"]
        (ck, cv), (draft_ck, draft_cv) = ckv, dckv
        dec_t = self._target._decoder_params()
        dec_d = self._draft._decoder_params()
        cache_t = self.model.kv_to_cache_grouped(kv_t, 1)
        cache_d = self.draft.kv_to_cache_grouped(kv_d, 1)
        tokens = first

        # ---- step 0: the target's prefill logits choose token[n_initial] ----
        g0, sum_lp = greedy_argmax(logits0, tokens, n_initial, n_initial, *pens, **filt)
        tokens[:, n_initial] = g0
        limit = n_initial + sample_len
        rows = torch.arange(A, device=dev)
        j_idx = torch.arange(K + 1, device=dev)
        n = torch.full((A,), n_initial + 1, dtype=torch.int32, device=dev)
        p_d = torch.full((A,), n_initial, dtype=torch.int32, device=dev)
        done = (g0 == eot) | (n >= limit)
        rounds = torch.zeros(A, dtype=torch.int32, device=dev)
        n_head_t, n_head_d = self.model.dims.n_text_head, self.draft.dims.n_text_head

        launches, draft_steps, verify_rounds = 1, 0, 0
        while True:
            # the round's one host read: every row's n, draft position, done
            with record_function("spec_read"):
                n_h, pd_h, done_h = torch.stack([n, p_d, done.int()]).cpu().numpy()
            if done_h.all():
                break
            done_h = done_h.astype(bool)

            # ---- draft phase: propose candidates for positions n .. n+K-1 ----
            while True:
                active_h = ~done_h & (pd_h < n_h + K - 1)
                if not active_h.any():
                    break
                with record_function("spec_draft_step"):
                    active = ~done & (p_d < n + K - 1)
                    tok_in = tokens[rows, p_d.long()][:, None]  # (A, 1)
                    logits_d, cache_d = graphs.decode_chunk(
                        dec_d, tok_in, p_d, cache_d, draft_ck, draft_cv, n_head=n_head_d,
                        active=active, width=int(pd_h.max()), tp=self._draft._tp, sp=self._sp,
                    )  # fmt: skip
                    write_pos = p_d + 1
                    prop, _ = greedy_argmax(logits_d[:, 0], tokens, write_pos, n_initial, *pens, **filt)
                    store = active & (write_pos >= n)  # only candidates, never a verified token
                    cols = write_pos.long().clamp(max=n_ctx - 1)
                    tokens[rows, cols] = torch.where(store, prop, tokens[rows, cols])
                    p_d = torch.where(active, write_pos, p_d)
                    pd_h = np.where(active_h, pd_h + 1, pd_h)
                launches += 1
                draft_steps += 1

            # ---- verify: one target pass over [t_{n-1}, c_0 .. c_{K-1}] ----
            with record_function("spec_verify"):
                live = ~done
                vidx = (n[:, None] - 1 + j_idx[None, :]).long()  # (A, K+1)
                t_in = tokens.gather(1, vidx)
                logits_v, cache_t = graphs.decode_chunk(
                    dec_t, t_in, n - 1, cache_t, ck, cv, n_head=n_head_t, active=live,
                    width=int(n_h.max()) - 1, tp=self._target._tp, sp=self._sp,
                )  # fmt: skip
                # one launch filters and picks all K + 1 positions of every row
                nt = (n[:, None] + j_idx[None, :]).reshape(-1).to(torch.int32)
                g, lp = greedy_argmax(
                    logits_v.reshape(A * (K + 1), -1), tokens.repeat_interleave(K + 1, dim=0), nt,
                    n_initial, *pens, **filt,
                )  # fmt: skip
                g, lp = g.view(A, K + 1), lp.view(A, K + 1)
            launches += 1
            verify_rounds += 1

            m, keep, accept, hit_eot = _accept(tokens, g, t_in, n, live, limit, eot)
            sum_lp = sum_lp + torch.where(keep, lp, 0.0).sum(dim=1)
            # the draft's cache is right through position n + m - 1; slot
            # n + m holds a rejected candidate's K/V unless all were accepted
            p_d = torch.minimum(p_d, n + m)
            rounds += live.int()
            n = n + accept
            done = done | hit_eot | (n >= limit)

        host = (t.cpu().numpy() for t in (tokens, n, sum_lp, rounds))
        return (*host, dict(
            loop="eager", launches=launches, draft_steps=draft_steps, rounds=verify_rounds
        ))  # fmt: skip
