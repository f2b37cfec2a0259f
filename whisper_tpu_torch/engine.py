"""The decoding loop: prefill, then one decoder step and one filtered update
per token, on the model's device.

The counterpart of whisper_tpu/engine_fused.py (FusedEngine.run keeps its
arguments and output contract). Prefill runs once per audio and its K/V is
broadcast to the audio's G rows; step 0 updates on the prefill's logits; each
later step runs `graphs.decode_step` (which applies the previous update's
beam reorder as an index gather over the occupied cache slots) and then the
update: the greedy_argmax or beam_update kernel at temperature 0, the plain
filters plus torch.multinomial when sampling. The loop stops when every row
is done, after sample_len steps, or when the 448-slot context is full.

The loop reads the `completed` flag on the host once per step (one device
synchronization per token).

`FusedEngine(model, weights="int8")` decodes with weight-only int8 (quant.py):
the engine quantizes the model's decoder once, on first use, and keeps the
quantized tree; each run quantizes the window's cross-K/V before the
prefill. The model's own parameters are left as they are. `model_engine`
gives a model's cached engine, one quantized tree per model and mode: a
parallel.serve.DataParallelEngine when the model has a mesh (set_mesh).
"""

import collections
import time
from typing import Optional

import numpy as np
import torch

from . import quant
from .models import graphs
from .ops.beam_kernel import apply_filters, beam_update, build_penalty_vectors, greedy_argmax

HISTORY_RUNS = 1024  # runs kept in FusedEngine.history; the oldest drop out


class FusedEngine:
    """Runs decode windows for one model; keeps the penalty vectors of the
    last suppression sets on the device."""

    # the process groups the graphs reduce over (parallel/serve.py sets
    # them): tensor parallel over heads, the frame split of the cross-K/V
    _tp = None
    _sp = None

    def __init__(self, model, weights: str = ""):
        self.model = model
        self.weights = quant.check_weights_mode(weights)
        self._dec_params = None
        self._pen_cache = {}
        # (beam_search, temperature, updates, seconds) of the latest runs:
        # callers read it to count the updates that went through each kernel
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

    def _all_done(self, done) -> bool:
        """Whether the loop may stop: every row is done (the per-step host
        read)."""
        return bool(done.all())

    def _draw(self, probs, gen):
        """One sampled token id per row of `probs` (B, V)."""
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

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
        B = A * G
        # the JAX engine caps the first timestamp at n_ctx when no maximum
        # is set; the port keeps that behaviour
        suppress_pen, begin_pen = self._penalties(
            suppress_ids, blank_ids, use_timestamps=use_timestamps,
            no_timestamps=no_timestamps, timestamp_begin=timestamp_begin,
            max_initial_ts_index=(
                max_initial_ts_index if max_initial_ts_index is not None else n_ctx
            ),
        )  # fmt: skip
        filt = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)

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
        cache = model.kv_to_cache_grouped(kv, G)
        logits = graphs.hidden_to_logits(dec, hidden[:, n_initial - 1])  # (A, V)
        sot_logits = graphs.hidden_to_logits(dec, hidden[:, sot_index])
        no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, no_speech]
        logits = logits.repeat_interleave(G, dim=0)

        tokens = first.repeat_interleave(G, dim=0)  # (B, 448)
        sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
        MC = max(max_candidates, 1)
        pool_tokens = torch.zeros((A, MC, n_ctx + 1), dtype=torch.int32, device=dev)
        pool_scores = torch.full((A, MC), float("-inf"), dtype=torch.float32, device=dev)
        pool_lengths = torch.zeros((A, MC), dtype=torch.int32, device=dev)
        pool_count = torch.zeros(A, dtype=torch.int32, device=dev)
        gen = None
        if not beam_search and temperature > 0:
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
            if beam_search:
                tokens, src, sum_lp = beam_update(
                    logits, tokens, sum_lp, pool_tokens, pool_scores, pool_lengths,
                    pool_count, n_tokens, n_initial, step, suppress_pen, begin_pen,
                    n_group=G, **filt,
                )  # fmt: skip
                done = pool_count >= MC
            else:
                if temperature == 0:
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
            tokens.cpu().numpy(),
            n_tokens,
            sum_lp.cpu().numpy(),
            no_speech_prob.float().cpu().numpy(),
            pool_tokens.cpu().numpy(),
            pool_scores.cpu().numpy(),
            pool_lengths.cpu().numpy(),
            pool_count.cpu().numpy(),
        )
        self.history.append((beam_search, float(temperature), step, time.perf_counter() - t0))
        return out


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
