"""The per-token update kernels, their plain PyTorch versions, and the
penalty vectors they share.

`greedy_argmax` (csrc/greedy_argmax.cu) replaces
whisper_tpu/ops/beam_kernel.py:greedy_argmax_pallas and `beam_update`
(csrc/beam_update.cu) replaces beam_update_pallas. Each wrapper launches its
CUDA kernel for CUDA tensors (or raises) and runs the plain version for CPU
tensors; there is no other route. The plain versions are the torch form of
whisper_tpu/engine_fused.py: `apply_filters` is `_apply_filters` expressed
through the penalty vectors, `greedy_argmax_plain` adds argmax and
logit - logsumexp, `beam_update_plain` is `_beam_update` for A audios.
Ties are broken explicitly (stable sorts): torch.topk promises no order.
"""

import numpy as np
import torch

from ..kernels import build

NEG_INF = float("-inf")


def build_penalty_vectors(
    V, suppress_ids, blank_ids, *, use_timestamps, no_timestamps, timestamp_begin,
    max_initial_ts_index,
):  # fmt: skip
    """Host-side penalty vectors (copied from the JAX package): `suppress`
    applies every step (SuppressTokens, plus <|notimestamps|> under
    timestamp rules); `begin` applies only at the first sampled position
    (SuppressBlank and, under timestamp rules, timestamps-only up to
    max_initial_ts_index)."""
    suppress = np.zeros(V, np.float32)
    suppress[list(suppress_ids)] = -np.inf
    begin = np.zeros(V, np.float32)
    begin[list(blank_ids)] = -np.inf
    if use_timestamps:
        suppress[no_timestamps] = -np.inf
        begin[:timestamp_begin] = -np.inf
        last_allowed = timestamp_begin + max_initial_ts_index
        if last_allowed + 1 < V:
            begin[last_allowed + 1 :] = -np.inf
    return suppress, begin


# ---- plain versions --------------------------------------------------------


def apply_filters(
    logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen, *,
    use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """SuppressBlank / SuppressTokens / ApplyTimestampRules on (R, V) f32
    logits with the (R, T) token history. n_tokens is every row's length
    (an int) or a (R,) integer tensor of per-row lengths, as the JAX
    package's _apply_filters takes it: the begin penalty applies to the rows
    at sample_begin, and each row's timestamp rules read its own history."""
    R, V = logits.shape
    T = tokens.shape[1]
    dev = logits.device
    if isinstance(n_tokens, torch.Tensor):
        nt = n_tokens.to(device=dev, dtype=torch.long)
    else:
        nt = torch.full((R,), int(n_tokens), dtype=torch.long, device=dev)
    at_begin = nt == sample_begin
    l = logits + suppress_pen
    l = l + torch.where(at_begin[:, None], begin_pen, 0.0)
    if not use_timestamps:
        return l
    ts = timestamp_begin
    ids = torch.arange(V, device=dev)
    seq_len = nt - sample_begin
    last = tokens.gather(1, (nt - 1).clamp(0, T - 1)[:, None])[:, 0]
    penult = tokens.gather(1, (nt - 2).clamp(0, T - 1)[:, None])[:, 0]
    last_was_ts = (last >= ts) & (seq_len >= 1)
    penult_was_ts = (penult >= ts) | (seq_len < 2)
    force_non_ts = last_was_ts & penult_was_ts
    force_ts_or_eot = last_was_ts & ~penult_was_ts
    l = l.masked_fill(force_non_ts[:, None] & (ids >= ts)[None, :], NEG_INF)
    l = l.masked_fill(force_ts_or_eot[:, None] & (ids < eot)[None, :], NEG_INF)

    # timestamps never decrease: the largest sampled one is the latest
    col = torch.arange(T, device=dev)[None, :]
    sampled = (col >= sample_begin) & (col < nt[:, None])
    last_ts = torch.where(sampled & (tokens >= ts), tokens, -1).amax(dim=1)
    has_ts = last_ts >= 0
    ts_floor = torch.where(force_ts_or_eot, last_ts, last_ts + 1)
    l = l.masked_fill(
        has_ts[:, None] & (ids >= ts)[None, :] & (ids[None, :] < ts_floor[:, None]),
        NEG_INF,
    )

    # the timestamp mass beats every text token -> timestamps only (a
    # shift-invariant comparison, so raw filtered logits serve)
    ts_mass = torch.logsumexp(l.masked_fill((ids < ts)[None, :], NEG_INF), dim=-1)
    max_text = l.masked_fill((ids >= ts)[None, :], NEG_INF).amax(dim=-1)
    return l.masked_fill((ts_mass > max_text)[:, None] & (ids < ts)[None, :], NEG_INF)


def greedy_argmax_plain(
    logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen, *,
    use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    filtered = apply_filters(
        logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen,
        use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin,
    )  # fmt: skip
    tok = filtered.argmax(dim=-1)  # first (lowest) id among equal maxima
    lp = filtered.gather(1, tok[:, None])[:, 0] - torch.logsumexp(filtered, dim=-1)
    return tok.to(torch.int32), lp


def beam_update_plain(
    logits, tokens, sum_logprobs, pool_tokens, pool_scores, pool_lengths, pool_count,
    n_tokens, sample_begin, step, suppress_pen, begin_pen, *,
    n_group, use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """See `beam_update`."""
    G = n_group
    K = G + 1
    B, T = tokens.shape
    A = B // G
    MC = pool_tokens.shape[1]
    n_cand = G * K
    dev = logits.device
    filtered = apply_filters(
        logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen,
        use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin,
    )  # fmt: skip

    lse = torch.logsumexp(filtered, dim=-1)
    top_raw, top_tok = torch.sort(filtered, dim=-1, descending=True, stable=True)
    top_lp = top_raw[:, :K] - lse[:, None]
    cand_scores = (sum_logprobs[:, None] + top_lp).reshape(A, n_cand)
    cand_tokens = top_tok[:, :K].reshape(A, n_cand)
    if step == 0:  # all beams identical: only beam 0's candidates count
        cand_scores[:, K:] = NEG_INF

    # ranking: score desc, ties by flat (beam, rank) id
    order_scores, order_idx = torch.sort(cand_scores, dim=1, descending=True, stable=True)
    order_tokens = cand_tokens.gather(1, order_idx)
    order_src = order_idx // K
    is_eot = order_tokens == eot
    not_eot = (~is_eot).to(torch.int64)
    live_incl = torch.cumsum(not_eot, dim=1)
    live_before = live_incl - not_eot
    eot_collected = is_eot & (live_before < G)

    # the first G live candidates per audio
    select_pos = torch.where(is_eot, n_cand, live_incl - 1)
    slot_source = (
        select_pos[:, None, :] == torch.arange(G, device=dev)[None, :, None]
    ).to(torch.int64).argmax(dim=2)  # (A, G)
    rows = torch.arange(A, device=dev)[:, None] * G
    new_scores = order_scores.gather(1, slot_source).reshape(B)
    new_tok = order_tokens.gather(1, slot_source).reshape(B)
    new_src = (order_src.gather(1, slot_source) + rows).reshape(B)
    new_tokens = tokens[new_src]
    new_tokens[:, n_tokens] = new_tok.to(tokens.dtype)

    # finished pools: collected EOT candidates in rank order, while room lasts
    coll = eot_collected.to(torch.int64)
    slot = pool_count[:, None].to(torch.int64) + torch.cumsum(coll, dim=1) - coll
    take = eot_collected & (slot < MC)
    a_idx, r_idx = take.nonzero(as_tuple=True)
    s_idx = slot[a_idx, r_idx]
    seqs = torch.zeros((a_idx.shape[0], T + 1), dtype=pool_tokens.dtype, device=dev)
    seqs[:, :T] = tokens[(a_idx * G + order_src[a_idx, r_idx])]
    seqs[:, n_tokens] = eot
    pool_tokens[a_idx, s_idx] = seqs
    pool_scores[a_idx, s_idx] = order_scores[a_idx, r_idx]
    pool_lengths[a_idx, s_idx] = n_tokens + 1
    pool_count += take.sum(dim=1).to(pool_count.dtype)
    return new_tokens, new_src.to(torch.int32), new_scores


# ---- kernels ---------------------------------------------------------------


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def greedy_argmax(
    logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen, *,
    use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """Filtered greedy argmax (lowest id on ties) and its log-probability.

    logits (B, V) f32, tokens (B, T) i32 history, penalty vectors (V,) f32.
    n_tokens is every row's length (an int), or a (B,) int32 tensor on the
    logits' device with each row's own length: the kernel then reads row
    r's length from memory (the speculative engine's draft steps and its
    verify pass). Returns (tok (B,) i32, lp (B,) f32). Scalar launches count
    in `greedy_argmax.launches`, per-row ones in `greedy_argmax.row_launches`.
    """
    kw = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)
    if logits.device.type == "cpu":
        return greedy_argmax_plain(
            logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen, **kw
        )
    if logits.device.type != "cuda":
        raise ValueError(f"greedy_argmax runs on CUDA or CPU tensors, not {logits.device}")
    B, V = logits.shape
    T = tokens.shape[1]
    dev = logits.device
    _check("logits", logits, torch.float32, (B, V), dev)
    _check("tokens", tokens, torch.int32, (B, T), dev)
    _check("suppress_pen", suppress_pen, torch.float32, (V,), dev)
    _check("begin_pen", begin_pen, torch.float32, (V,), dev)
    per_row = isinstance(n_tokens, torch.Tensor)
    if per_row:
        _check("n_tokens", n_tokens, torch.int32, (B,), dev)
        if not 0 < sample_begin <= T:
            raise ValueError(f"bad sample_begin {sample_begin} for T = {T}")
    elif not 0 < sample_begin <= n_tokens <= T:
        raise ValueError(f"bad lengths: sample_begin={sample_begin}, n_tokens={n_tokens}")
    lib = build.load_library()
    tok = torch.empty(B, dtype=torch.int32, device=dev)
    lp = torch.empty(B, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if per_row:
        rc = lib.wtt_greedy_argmax_rows(
            logits.data_ptr(), tokens.data_ptr(), n_tokens.data_ptr(), suppress_pen.data_ptr(),
            begin_pen.data_ptr(), tok.data_ptr(), lp.data_ptr(), B, V, T, sample_begin,
            int(use_timestamps), eot, timestamp_begin, stream,
        )  # fmt: skip
        greedy_argmax.row_launches += 1
    else:
        rc = lib.wtt_greedy_argmax(
            logits.data_ptr(), tokens.data_ptr(), suppress_pen.data_ptr(), begin_pen.data_ptr(),
            tok.data_ptr(), lp.data_ptr(), B, V, T, n_tokens, sample_begin,
            int(use_timestamps), eot, timestamp_begin, stream,
        )  # fmt: skip
        greedy_argmax.launches += 1
    _launch_check(rc, "greedy_argmax")
    return tok, lp


greedy_argmax.launches = 0
greedy_argmax.row_launches = 0


def beam_update(
    logits, tokens, sum_logprobs, pool_tokens, pool_scores, pool_lengths, pool_count,
    n_tokens, sample_begin, step, suppress_pen, begin_pen, *,
    n_group, use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """One BeamSearchDecoder update for A audios of G = n_group beams
    (audio-major rows).

    logits (A*G, V) f32, tokens (A*G, T) i32 with every row at length
    n_tokens < T, sum_logprobs (A*G,) f32, the finished pools pool_tokens
    (A, MC, T+1) i32 / pool_scores (A, MC) f32 / pool_lengths (A, MC) i32 /
    pool_count (A,) i32 — UPDATED IN PLACE — and the penalty vectors (V,).
    Returns (new tokens (A*G, T) i32, src (A*G,) i32 global source rows,
    new sum_logprobs (A*G,) f32).
    """
    kw = dict(
        n_group=n_group, use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin
    )
    args = (
        logits, tokens, sum_logprobs, pool_tokens, pool_scores, pool_lengths, pool_count,
        n_tokens, sample_begin, step, suppress_pen, begin_pen,
    )  # fmt: skip
    if logits.device.type == "cpu":
        return beam_update_plain(*args, **kw)
    if logits.device.type != "cuda":
        raise ValueError(f"beam_update runs on CUDA or CPU tensors, not {logits.device}")
    G = n_group
    if not 1 <= G <= 8:
        raise ValueError(f"beam_update supports 1 <= n_group <= 8, got {G}")
    B, V = logits.shape
    T = tokens.shape[1]
    if B % G:
        raise ValueError(f"{B} rows do not split into groups of {G}")
    A = B // G
    MC = pool_tokens.shape[1]
    dev = logits.device
    _check("logits", logits, torch.float32, (B, V), dev)
    _check("tokens", tokens, torch.int32, (B, T), dev)
    _check("sum_logprobs", sum_logprobs, torch.float32, (B,), dev)
    _check("pool_tokens", pool_tokens, torch.int32, (A, MC, T + 1), dev)
    _check("pool_scores", pool_scores, torch.float32, (A, MC), dev)
    _check("pool_lengths", pool_lengths, torch.int32, (A, MC), dev)
    _check("pool_count", pool_count, torch.int32, (A,), dev)
    _check("suppress_pen", suppress_pen, torch.float32, (V,), dev)
    _check("begin_pen", begin_pen, torch.float32, (V,), dev)
    if not 0 < sample_begin <= n_tokens < T:
        raise ValueError(f"bad lengths: sample_begin={sample_begin}, n_tokens={n_tokens}")
    lib = build.load_library()
    new_tokens = torch.empty_like(tokens)
    src = torch.empty(B, dtype=torch.int32, device=dev)
    new_lp = torch.empty(B, dtype=torch.float32, device=dev)
    rc = lib.wtt_beam_update(
        logits.data_ptr(), tokens.data_ptr(), sum_logprobs.data_ptr(),
        pool_tokens.data_ptr(), pool_scores.data_ptr(), pool_lengths.data_ptr(),
        pool_count.data_ptr(), suppress_pen.data_ptr(), begin_pen.data_ptr(),
        new_tokens.data_ptr(), src.data_ptr(), new_lp.data_ptr(),
        A, G, V, T, MC, n_tokens, sample_begin, step, int(use_timestamps), eot,
        timestamp_begin, torch.cuda.current_stream(dev).cuda_stream,
    )  # fmt: skip
    beam_update.launches += 1
    _launch_check(rc, "beam_update")
    return new_tokens, src, new_lp


beam_update.launches = 0


def reset_launch_counts():
    greedy_argmax.launches = 0
    greedy_argmax.row_launches = 0
    beam_update.launches = 0


def cluster_sizes(n_group, V):
    """CTAs per thread-block cluster on the current CUDA device:
    (greedy_argmax's cluster per row, beam_update's cluster per audio of
    n_group beams)."""
    lib = build.load_library()
    return lib.wtt_greedy_argmax_chunks(V), n_group * lib.wtt_beam_update_chunks(n_group, V)
