"""Speculative greedy decoding: a small draft model proposes K tokens, the
target model checks them in one decoder pass (the counterpart of
whisper_tpu/speculative.py).

Every emitted token is the target's filtered argmax given the same prefix,
so the output is the greedy engine's whatever the draft: the draft only
decides how many positions one verify pass confirms. (In float32; with
bf16 or int8 weights the verify pass's products have other shapes than the
step's, and a near-tie may go the other way.)

The loop runs on the host, round by round, on the models' device:
  * prefill both models; step 0 picks from the target's prefill logits;
  * draft phase: the draft proposes until it has fed position n + K - 1 of
    every unfinished row: one `decode_chunk` of width 1 and one per-row
    greedy_argmax launch per step;
  * verify: one target `decode_chunk` over [t_{n-1}, c_0 .. c_{K-1}] for the
    unfinished rows, then ONE greedy_argmax launch over A * (K + 1) rows at
    lengths n[a] + j;
  * keep the accepted prefix and the target's token after it, truncated at
    EOT and at the length limit; roll the draft back to what it fed
    correctly.
Each round reads one small tensor (every row's n, draft position and done
flag) to the host: it decides the loop and sizes the next round's cache
slices. Greedy at temperature 0 only: the fallback ladder and beam search
run on engine.FusedEngine.

Profiler ranges (torch.profiler.record_function) mark the three parts of
a round on the host: "spec_draft_step", "spec_verify" and "spec_read".
"""

import collections
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import quant
from .engine import HISTORY_RUNS, model_engine
from .models import graphs
from .ops.beam_kernel import greedy_argmax


class SpeculativeEngine:
    """Greedy speculative decoding: `model` verifies, `draft_model`
    proposes `k` tokens a round. Both must share the vocabulary; the
    weights mode ("" / "bf16" or "int8") applies to both decoders and both
    cross-K/V, read from each model's cached engine (engine.model_engine). `last_stats` holds the latest run's per-row rounds, emitted
    tokens and draft acceptance; `history` holds (greedy launches, draft
    steps, verify rounds, tokens decoded (the longest row's), seconds) of
    the latest runs."""

    _sp = None  # the frame split of both cross-K/V (parallel/serve.py)

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

    def _model_engine(self, model, weights):
        return model_engine(model, weights)

    def _prefill(self, engine, first, n_initial, ck, cv):
        """(hidden (A, n, d), cache (L, 2, A, 448, d)) of one model."""
        m = engine.model
        hidden, kv = graphs.prefill(
            engine._decoder_params(), first[:, :n_initial], n_initial, ck, cv,
            n_head=m.dims.n_text_head, tp=engine._tp, sp=self._sp,
        )  # fmt: skip
        return hidden, m.kv_to_cache_grouped(kv, 1)

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
        suppress_pen, begin_pen = self._target._penalties(
            suppress_ids, blank_ids, use_timestamps=use_timestamps,
            no_timestamps=no_timestamps, timestamp_begin=timestamp_begin,
            max_initial_ts_index=(
                max_initial_ts_index if max_initial_ts_index is not None else n_ctx
            ),
        )  # fmt: skip
        filt = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)
        pens = (suppress_pen, begin_pen)
        if self.weights == "int8":
            ck, cv = quant.quantize_cross_kv(ck, cv)
            draft_ck, draft_cv = quant.quantize_cross_kv(draft_ck, draft_cv)

        toks = np.zeros((A, n_ctx), dtype=np.int32)
        toks[:, :n_initial] = initial_tokens
        tokens = torch.from_numpy(toks).to(dev)
        dec_t = self._target._decoder_params()
        dec_d = self._draft._decoder_params()
        hidden, cache_t = self._prefill(self._target, tokens, n_initial, ck, cv)
        _, cache_d = self._prefill(self._draft, tokens, n_initial, draft_ck, draft_cv)
        first_logits = graphs.hidden_to_logits(dec_t, hidden[:, n_initial - 1])
        sot_logits = graphs.hidden_to_logits(dec_t, hidden[:, sot_index])
        no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, no_speech]

        # ---- step 0: the target's prefill logits choose token[n_initial] ----
        g0, sum_lp = greedy_argmax(first_logits, tokens, n_initial, n_initial, *pens, **filt)
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
                    prop, _ = greedy_argmax(
                        logits_d[:, 0], tokens, write_pos, n_initial, *pens, **filt
                    )
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

            match = (g[:, :K] == t_in[:, 1:]).int()
            m = match.cumprod(dim=1).sum(dim=1)  # the accepted prefix
            # keep g_0 .. g_m, truncated at the first EOT and at the limit
            keep = live[:, None] & (j_idx[None, :] <= m[:, None]) & (n[:, None] + j_idx < limit)
            after_eot = torch.cumsum((g == eot).int(), dim=1) - (g == eot).int() > 0
            keep &= ~after_eot
            accept = keep.sum(dim=1, dtype=torch.int32)
            hit_eot = (keep & (g == eot)).any(dim=1)
            wcols = (n[:, None] + j_idx[None, :]).long().clamp(max=n_ctx - 1)
            tokens.scatter_(1, wcols, torch.where(keep, g, tokens.gather(1, wcols)))
            sum_lp = sum_lp + torch.where(keep, lp, 0.0).sum(dim=1)
            # the draft's cache is right through position n + m - 1; slot
            # n + m holds a rejected candidate's K/V unless all were accepted
            p_d = torch.minimum(p_d, n + m.int())
            rounds += live.int()
            n = n + accept
            done = done | hit_eot | (n >= limit)

        # EOT up to the longest row (as the greedy engine pads finished rows),
        # zeros after it
        n_tokens = int(n_h.max())
        col = torch.arange(n_ctx, device=dev)[None, :]
        pad = torch.where(col < n_tokens, eot, 0).to(tokens.dtype)
        tokens = torch.where(col >= n[:, None], pad, tokens)

        rounds_h = rounds.cpu().numpy()
        emitted = n_h - n_initial
        accepted = np.maximum(emitted - 1 - rounds_h, 0)
        self.last_stats = {
            "rounds": rounds_h.tolist(),
            "emitted": emitted.tolist(),
            "draft_acceptance": (accepted / np.maximum(rounds_h * K, 1)).tolist(),
            "k": K,
        }
        MC = max(max_candidates, 1)
        out = (
            tokens.cpu().numpy(),
            n_tokens,
            sum_lp.cpu().numpy(),
            no_speech_prob.float().cpu().numpy(),
            np.zeros((A, MC, n_ctx + 1), np.int32),
            np.full((A, MC), -np.inf, np.float32),
            np.zeros((A, MC), np.int32),
            np.zeros((A,), np.int32),
        )
        self.history.append(
            (launches, draft_steps, verify_rounds, n_tokens - n_initial, time.perf_counter() - t0)
        )
        return out
