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

The loop scalars (n_tokens, sample_begin, step) are host ints, or 0-d /
(1,) int32 tensors on the logits' device: the captured decode loop keeps
them in a device array, the loop state (`N_TOKENS`, `SAMPLE_BEGIN`, `STEP`,
`LIVE`), which `greedy_argmax_state` and `beam_update_state` read on the
card; the captured speculative round's `greedy_argmax_rows_state` reads
per-row lengths from a (B,) array and `SAMPLE_BEGIN` and `LIVE` from its
round's state array. There `live` = 0 (every row done) makes the update
write nothing.
"""

import numpy as np
import torch

from ..kernels import build

NEG_INF = float("-inf")

# the loop state's fields (csrc/update_common.cuh, LoopState)
N_TOKENS, SAMPLE_BEGIN, STEP, LIVE = range(4)
STATE_LEN = 4


def _scalar(x, dev):
    """A loop scalar (host int or 0-d / (1,) tensor) as a (1,) int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.long).reshape(1)
    return torch.full((1,), int(x), dtype=torch.long, device=dev)


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
    logits with the (R, T) token history. n_tokens is every row's length (a
    loop scalar) or a (R,) integer tensor of per-row lengths, as the JAX
    package's _apply_filters takes it: the begin penalty applies to the rows
    at sample_begin (a loop scalar), and each row's timestamp rules read its
    own history."""
    R, V = logits.shape
    T = tokens.shape[1]
    dev = logits.device
    if isinstance(n_tokens, torch.Tensor) and n_tokens.numel() == R and n_tokens.dim() == 1:
        nt = n_tokens.to(device=dev, dtype=torch.long)
    else:
        nt = _scalar(n_tokens, dev).expand(R)
    if isinstance(sample_begin, torch.Tensor):
        sample_begin = _scalar(sample_begin, dev)
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
    n_group, use_timestamps, eot, timestamp_begin, live=None,
):  # fmt: skip
    """See `beam_update`. `live` (a 0-d / (1,) tensor, or None for 1): at 0
    the pools stay as they are and the result is (tokens, the identity,
    sum_logprobs)."""
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
    # step 0: all beams identical, only beam 0's candidates count
    first = _scalar(step, dev) == 0
    cand_scores = cand_scores.masked_fill(first[:, None] & (torch.arange(n_cand, device=dev) >= K), NEG_INF)
    nt = _scalar(n_tokens, dev)
    lv = torch.ones(1, dtype=torch.bool, device=dev) if live is None else _scalar(live, dev) != 0

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
    new_tokens.scatter_(1, nt.expand(B)[:, None], new_tok.to(tokens.dtype)[:, None])

    # finished pools: collected EOT candidates in rank order, while room lasts
    coll = eot_collected.to(torch.int64)
    slot = pool_count[:, None].to(torch.int64) + torch.cumsum(coll, dim=1) - coll
    take = eot_collected & (slot < MC) & lv
    a_idx, r_idx = take.nonzero(as_tuple=True)
    s_idx = slot[a_idx, r_idx]
    n_take = a_idx.shape[0]
    seqs = torch.zeros((n_take, T + 1), dtype=pool_tokens.dtype, device=dev)
    seqs[:, :T] = tokens[(a_idx * G + order_src[a_idx, r_idx])]
    seqs.scatter_(1, nt.expand(n_take)[:, None], torch.full((n_take, 1), eot, dtype=seqs.dtype, device=dev))
    pool_tokens[a_idx, s_idx] = seqs
    pool_scores[a_idx, s_idx] = order_scores[a_idx, r_idx]
    pool_lengths[a_idx, s_idx] = (nt + 1).to(pool_lengths.dtype).expand(n_take)
    pool_count += take.sum(dim=1).to(pool_count.dtype)
    if live is not None:
        new_tokens = torch.where(lv[:, None], new_tokens, tokens)
        new_src = torch.where(lv, new_src, torch.arange(B, device=dev))
        new_scores = torch.where(lv, new_scores, sum_logprobs)
    return new_tokens, new_src.to(torch.int32), new_scores


def _store_if_live(state, outs, values):
    """The plain loop-state forms' stores: `values` into `outs` where
    state[LIVE] is not 0, as the kernels write; returns outs."""
    live = state[LIVE] != 0
    for out, value in zip(outs, values):
        out.copy_(torch.where(live, value, out))
    return outs


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


# The loop-state launches are counted on the card, by the kernels: CTA 0 of
# each launch adds one to its kernel's counter, so the replays of a captured
# graph, which make no Python call, count as the launches they are. One int64
# per loop-state launch and device, in STATE_KERNELS' order.
STATE_KERNELS = ("greedy_argmax_state", "beam_update_state", "greedy_argmax_rows_state")
_STATE_COUNTERS = {}


def state_counters(dev):
    """dev's (len(STATE_KERNELS),) int64 counters, made at the first call
    outside a capture: a zeroing made while a stream is captured would be
    recorded into the graph."""
    counters = _STATE_COUNTERS.get(dev.index)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch the loop-state kernels once before capturing them")
        with torch.inference_mode(False):  # a normal tensor: reset outside inference mode too
            counters = torch.zeros(len(STATE_KERNELS), dtype=torch.int64, device=dev)
            _STATE_COUNTERS[dev.index] = counters
    return counters


def _state_counter(dev, which):
    """The address of dev's counter of STATE_KERNELS[which]."""
    counters = state_counters(dev)
    return counters.data_ptr() + counters.element_size() * which


def state_launches():
    """The loop-state kernels' launches since the last reset, read from the
    cards' counters (a synchronizing read), by name (STATE_KERNELS)."""
    total = [0] * len(STATE_KERNELS)
    for counters in _STATE_COUNTERS.values():
        total = [a + b for a, b in zip(total, counters.tolist())]
    return dict(zip(STATE_KERNELS, total))


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


def greedy_argmax_state(
    logits, tokens, state, suppress_pen, begin_pen, tok_out, lp_out, *,
    use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """`greedy_argmax` at the loop state: every row's length and the first
    sampled position are read from `state` ((STATE_LEN,) int32 on the
    logits' device, csrc/update_common.cuh LoopState), the results go into
    the caller's tok_out (B,) int32 and lp_out (B,) f32, and where
    state[LIVE] is 0 nothing is written. The host checks read shapes and
    types only, so a CUDA graph can capture the launch (csrc/greedy_argmax.cu
    `wtt_greedy_argmax_state`). The kernel counts its launches on the card
    (`state_launches`). Returns (tok_out, lp_out)."""
    kw = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)
    if logits.device.type == "cpu":
        tok, lp = greedy_argmax_plain(
            logits, tokens, state[N_TOKENS], state[SAMPLE_BEGIN], suppress_pen, begin_pen, **kw
        )
        return _store_if_live(state, (tok_out, lp_out), (tok, lp))
    if logits.device.type != "cuda":
        raise ValueError(f"greedy_argmax_state runs on CUDA or CPU tensors, not {logits.device}")
    B, V = logits.shape
    T = tokens.shape[1]
    dev = logits.device
    _check("logits", logits, torch.float32, (B, V), dev)
    _check("tokens", tokens, torch.int32, (B, T), dev)
    _check("state", state, torch.int32, (STATE_LEN,), dev)
    _check("suppress_pen", suppress_pen, torch.float32, (V,), dev)
    _check("begin_pen", begin_pen, torch.float32, (V,), dev)
    _check("tok_out", tok_out, torch.int32, (B,), dev)
    _check("lp_out", lp_out, torch.float32, (B,), dev)
    rc = build.load_library().wtt_greedy_argmax_state(
        logits.data_ptr(), tokens.data_ptr(), state.data_ptr(), suppress_pen.data_ptr(),
        begin_pen.data_ptr(), tok_out.data_ptr(), lp_out.data_ptr(), _state_counter(dev, 0), B,
        V, T, int(use_timestamps), eot, timestamp_begin, torch.cuda.current_stream(dev).cuda_stream,
    )  # fmt: skip
    _launch_check(rc, "greedy_argmax_state")
    return tok_out, lp_out


def greedy_argmax_rows_state(
    logits, tokens, n_rows, state, suppress_pen, begin_pen, tok_out, lp_out, *,
    use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """`greedy_argmax` at per-row lengths inside the captured speculative
    round: row r's length is n_rows[r] ((B,) int32 on the logits' device),
    the first sampled position and the live flag are read from `state`
    ((STATE_LEN,) int32, csrc/update_common.cuh LoopState: SAMPLE_BEGIN and
    LIVE), the results go into the caller's tok_out (B,) int32 and lp_out
    (B,) f32, and where state[LIVE] is 0 nothing is written. The host checks
    read shapes and types only, so a CUDA graph can capture the launch
    (csrc/greedy_argmax.cu `wtt_greedy_argmax_rows_state`). The kernel
    counts its launches on the card (`state_launches`). Returns (tok_out,
    lp_out)."""
    kw = dict(use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin)
    if logits.device.type == "cpu":
        tok, lp = greedy_argmax_plain(
            logits, tokens, n_rows, state[SAMPLE_BEGIN], suppress_pen, begin_pen, **kw
        )
        return _store_if_live(state, (tok_out, lp_out), (tok, lp))
    if logits.device.type != "cuda":
        raise ValueError(f"greedy_argmax_rows_state runs on CUDA or CPU tensors, not {logits.device}")
    B, V = logits.shape
    T = tokens.shape[1]
    dev = logits.device
    _check("logits", logits, torch.float32, (B, V), dev)
    _check("tokens", tokens, torch.int32, (B, T), dev)
    _check("n_rows", n_rows, torch.int32, (B,), dev)
    _check("state", state, torch.int32, (STATE_LEN,), dev)
    _check("suppress_pen", suppress_pen, torch.float32, (V,), dev)
    _check("begin_pen", begin_pen, torch.float32, (V,), dev)
    _check("tok_out", tok_out, torch.int32, (B,), dev)
    _check("lp_out", lp_out, torch.float32, (B,), dev)
    rc = build.load_library().wtt_greedy_argmax_rows_state(
        logits.data_ptr(), tokens.data_ptr(), n_rows.data_ptr(), state.data_ptr(),
        suppress_pen.data_ptr(), begin_pen.data_ptr(), tok_out.data_ptr(), lp_out.data_ptr(),
        _state_counter(dev, 2), B, V, T, int(use_timestamps), eot, timestamp_begin,
        torch.cuda.current_stream(dev).cuda_stream,
    )  # fmt: skip
    _launch_check(rc, "greedy_argmax_rows_state")
    return tok_out, lp_out


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


def beam_update_state(
    logits, tokens, sum_logprobs, pool_tokens, pool_scores, pool_lengths, pool_count,
    state, suppress_pen, begin_pen, new_tokens, src, new_lp, *,
    n_group, use_timestamps, eot, timestamp_begin,
):  # fmt: skip
    """`beam_update` at the loop state: n_tokens, sample_begin and step are
    read from `state` ((STATE_LEN,) int32 on the logits' device), the
    results go into the caller's new_tokens (A*G, T) int32, src (A*G,)
    int32 and new_lp (A*G,) f32, and the pools are updated in place. Where
    state[LIVE] is 0 nothing is written: the pools and the three outputs
    keep what they held. The host checks read shapes and types only
    (csrc/beam_update.cu `wtt_beam_update_state`). The kernel counts its
    launches on the card (`state_launches`). Returns (new_tokens, src,
    new_lp)."""
    kw = dict(
        n_group=n_group, use_timestamps=use_timestamps, eot=eot, timestamp_begin=timestamp_begin
    )
    pools = (pool_tokens, pool_scores, pool_lengths, pool_count)
    if logits.device.type == "cpu":
        got = beam_update_plain(
            logits, tokens, sum_logprobs, *pools, state[N_TOKENS], state[SAMPLE_BEGIN],
            state[STEP], suppress_pen, begin_pen, live=state[LIVE], **kw,
        )  # fmt: skip
        return _store_if_live(state, (new_tokens, src, new_lp), got)
    if logits.device.type != "cuda":
        raise ValueError(f"beam_update_state runs on CUDA or CPU tensors, not {logits.device}")
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
    _check("state", state, torch.int32, (STATE_LEN,), dev)
    _check("suppress_pen", suppress_pen, torch.float32, (V,), dev)
    _check("begin_pen", begin_pen, torch.float32, (V,), dev)
    _check("new_tokens", new_tokens, torch.int32, (B, T), dev)
    _check("src", src, torch.int32, (B,), dev)
    _check("new_lp", new_lp, torch.float32, (B,), dev)
    rc = build.load_library().wtt_beam_update_state(
        logits.data_ptr(), tokens.data_ptr(), sum_logprobs.data_ptr(),
        *(t.data_ptr() for t in pools), suppress_pen.data_ptr(), begin_pen.data_ptr(),
        state.data_ptr(), _state_counter(dev, 1), new_tokens.data_ptr(), src.data_ptr(),
        new_lp.data_ptr(), A, G, V, T, MC, int(use_timestamps), eot, timestamp_begin,
        torch.cuda.current_stream(dev).cuda_stream,
    )  # fmt: skip
    _launch_check(rc, "beam_update_state")
    return new_tokens, src, new_lp


def reset_launch_counts():
    greedy_argmax.launches = 0
    greedy_argmax.row_launches = 0
    beam_update.launches = 0
    for counters in _STATE_COUNTERS.values():
        counters.zero_()


def cluster_sizes(n_group, V):
    """CTAs per thread-block cluster on the current CUDA device:
    (greedy_argmax's cluster per row, beam_update's cluster per audio of
    n_group beams)."""
    lib = build.load_library()
    return lib.wtt_greedy_argmax_chunks(V), n_group * lib.wtt_beam_update_chunks(n_group, V)
