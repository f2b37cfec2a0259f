"""The split-and-merge algebra of the update kernels, on the CPU.

csrc/greedy_argmax.cu and csrc/beam_update.cu split a row's vocabulary into
C contiguous chunks, one per CTA of a thread-block cluster. Each CTA reduces
its chunk to a per-region top-K (text ids below timestamp_begin, timestamp
ids from it) and a per-region (max, sum of exp); the cluster's rank-0 CTA
merges the partials and applies the timestamp-mass rule. The model below
does the same in torch, with the kernels' chunk bounds and merge order, and
is held against greedy_argmax_plain, against beam_update_plain's candidate
stage (its per-row top-(G+1) log-probs) and against the JAX package's XLA
path (engine_fused._apply_filters plus argmax / top-k), for C in {1, 3, 8,
16} on rows with ties across chunk edges, fully masked chunks, the
timestamp boundary inside a chunk, and the timestamp-mass rule with its
fill of the lowest text ids at -inf.

Ids must match exactly; log-probs within 1e-5 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.engine_fused import FusedConfig, _apply_filters
from whisper_tpu_torch.ops import beam_kernel as bk

torch.set_num_threads(1)  # six test workers share the cores

V = 51866
TS_BEGIN = 50365
EOT = 50257
NO_TS = 50364
T = 448
SAMPLE_BEGIN = 3
N_TOKENS = 10
SUPPRESS = [1, 2, 3, 11, 220]
BLANK = [220, EOT]
MAX_INITIAL = 50
G = 5  # rows; the beam kernel's K is G + 1
SCORE_TOL = 1e-5
INT_MAX = 2**31 - 1
NEG_INF = float("-inf")


# ---- the model ---------------------------------------------------------------


def chunk_bounds(C, W=2):
    """update_common.cuh:chunk_bounds: C chunks of ceil(V / C) ids rounded up
    to a multiple of W (float2 units where V is even), the last shorter."""
    n = -(-V // C)  # ceil(V / C)
    n = -(-n // W) * W
    return [(min(c * n, V), min(min(c * n, V) + n, V)) for c in range(C)]


def topk_of(vals, ids, K):
    """The K best (value, id) in (value desc, id asc) order, padded with the
    kernels' sentinel (-inf, INT_MAX)."""
    vals = torch.cat([vals, torch.full((K,), NEG_INF)])
    ids = torch.cat([ids, torch.full((K,), INT_MAX, dtype=torch.int64)])
    by_id = torch.sort(ids, stable=True).indices
    vals, ids = vals[by_id], ids[by_id]
    order = torch.sort(vals, descending=True, stable=True).indices[:K]
    return vals[order], ids[order]


def lse_of(vals):
    """(m, s): the max of the finite values and the sum of exp(x - m)."""
    finite = vals[vals > NEG_INF]
    if not finite.numel():
        return (torch.tensor(NEG_INF), torch.tensor(0.0))
    m = finite.max()
    return (m, torch.exp(finite - m).sum())


def lse_merge(a, b):
    """Lse::merge: an empty side is skipped, so -inf - -inf never forms."""
    if b[0] == NEG_INF:
        return a
    if a[0] == NEG_INF:
        return b
    M = torch.maximum(a[0], b[0])
    return (M, a[1] * torch.exp(a[0] - M) + b[1] * torch.exp(b[0] - M))


def lse_butterfly(parts):
    """warp_lse2 over lanes 0..31, lane c holding chunk c (the rest empty):
    lane l merges with lane l ^ o for o = 1, 2, 4, 8, 16; lane 0's result."""
    lanes = list(parts) + [(torch.tensor(NEG_INF), torch.tensor(0.0))] * (32 - len(parts))
    for o in (1, 2, 4, 8, 16):
        lanes = [lse_merge(lanes[l], lanes[l ^ o]) for l in range(32)]
    return lanes[0]


def lse_value(a):
    return a[0] + torch.log(a[1]) if a[0] > NEG_INF else torch.tensor(NEG_INF)


def split_row(filtered, C, K, split):
    """One filtered row through the kernels' reduction: per chunk, the
    top-K and (m, s) of each region (split per id), then the merge of the
    C partials in chunk order."""
    parts = []
    for lo, hi in chunk_bounds(C):
        x, ids = filtered[lo:hi], torch.arange(lo, hi)
        txt, ts = ids < split, ids >= split
        parts.append(
            (topk_of(x[txt], ids[txt], K), topk_of(x[ts], ids[ts], K), lse_of(x[txt]), lse_of(x[ts]))
        )
    tv, ti = topk_of(torch.cat([p[0][0] for p in parts]), torch.cat([p[0][1] for p in parts]), K)
    sv, si = topk_of(torch.cat([p[1][0] for p in parts]), torch.cat([p[1][1] for p in parts]), K)
    return (tv, ti), (sv, si), lse_butterfly([p[2] for p in parts]), lse_butterfly(
        [p[3] for p in parts]
    )


def row_candidates(merged, K, use_ts):
    """update_common.cuh:row_candidates: the K best log-probs of the row;
    when the timestamp mass beats every text logit, the finite timestamps
    followed by the lowest text ids at -inf."""
    (tv, ti), (sv, si), lt, ls = merged
    lse_all = lse_value(lse_merge(lt, ls))
    if use_ts:
        lse_ts = lse_value(ls)
        if lse_ts > lt[0]:
            keep = sv > NEG_INF
            lp = torch.cat([sv[keep] - lse_ts, torch.full((K,), NEG_INF)])[:K]
            tok = torch.cat([si[keep], torch.arange(K)])[:K]
            return lp, tok
    vals, toks = topk_of(torch.cat([tv, sv]), torch.cat([ti, si]), K)
    lp = vals - lse_all
    return torch.where(lp > NEG_INF, lp, torch.tensor(NEG_INF)), toks


def model(filtered, C, K, use_ts):
    split = TS_BEGIN if use_ts else V
    out = [row_candidates(split_row(row, C, K, split), K, use_ts) for row in filtered]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


# ---- inputs -----------------------------------------------------------------

CASES = ["edge_ties", "masked_chunk", "ts_inside_chunk", "ts_mass_fill"]


def _inputs(case, C):
    """(tokens, logits, suppress ids) for G rows at n_tokens = 10 with the
    timestamp rules on; rows 1-3 carry the pairing histories."""
    rng = np.random.RandomState(CASES.index(case) * 31 + C)
    tokens = rng.randint(100, 5000, size=(G, T)).astype(np.int32)
    tokens[1, 4] = tokens[1, 5] = TS_BEGIN + 10  # a timestamp was sampled
    tokens[2, N_TOKENS - 1] = TS_BEGIN + 30  # mid-pair
    tokens[3, N_TOKENS - 2] = TS_BEGIN + 7  # pair just closed
    tokens[3, N_TOKENS - 1] = TS_BEGIN + 12
    logits = rng.randn(G, V).astype(np.float32)
    suppress = list(SUPPRESS)
    edges = [lo for lo, _ in chunk_bounds(C)[1:]] or [V // 2]
    if case == "edge_ties":
        # equal maxima on both sides of every chunk edge, above the
        # timestamp mass (~7.8 for 1,501 randn logits); in odd rows the id
        # below the first edge sits just under them
        for r in range(G):
            top = 14.0
            for e in edges:
                logits[r, [e - 1, e]] = top
            if r % 2:
                logits[r, edges[0] - 1] = top - 1e-3
    elif case == "masked_chunk":
        # chunk 0 (the rank-0 CTA's) suppressed whole, a large logit inside
        hi = chunk_bounds(C)[0][1] if C > 1 else EOT
        suppress += list(range(min(hi, EOT)))
        logits[:, 10] += 20.0
    elif case == "ts_inside_chunk":
        # the best candidates on both sides of timestamp_begin, one exact tie
        # across it; the text maximum stays above the timestamp mass
        logits[:, TS_BEGIN - 1] = 14.0
        logits[:, TS_BEGIN - 2] = 12.5
        logits[:, TS_BEGIN - 3] = logits[:, TS_BEGIN] = 12.9
        logits[:, TS_BEGIN + 1] = 12.4
    elif case == "ts_mass_fill":
        # two timestamps left (the floor is V - 2) carry the mass: the rule
        # fires and fills the candidates with the lowest text ids at -inf
        tokens[[0, 4], 6] = V - 3
        logits[:, V - 2 :] = 30.0
    return tokens, logits, sorted(set(suppress))


def _filtered_plain(tokens, logits, suppress):
    sup, beg = bk.build_penalty_vectors(
        V, suppress, BLANK, use_timestamps=True, no_timestamps=NO_TS,
        timestamp_begin=TS_BEGIN, max_initial_ts_index=MAX_INITIAL,
    )  # fmt: skip
    args = (
        torch.from_numpy(logits), torch.from_numpy(tokens), N_TOKENS, SAMPLE_BEGIN,
        torch.from_numpy(sup), torch.from_numpy(beg),
    )  # fmt: skip
    kw = dict(use_timestamps=True, eot=EOT, timestamp_begin=TS_BEGIN)
    return args, kw


def _filtered_xla(tokens, logits, suppress):
    suppress_mask = np.zeros(V, bool)
    suppress_mask[suppress] = True
    blank_mask = np.zeros(V, bool)
    blank_mask[BLANK] = True
    cfg = FusedConfig(
        n_group=G, n_audio=1, beam_search=True, use_timestamps=True, max_candidates=G,
        eot=EOT, timestamp_begin=TS_BEGIN, no_timestamps=NO_TS, no_speech=50363,
    )  # fmt: skip
    return _apply_filters(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.int32(N_TOKENS), jnp.int32(SAMPLE_BEGIN),
        jnp.asarray(suppress_mask), jnp.asarray(blank_mask), jnp.int32(MAX_INITIAL), cfg,
    )  # fmt: skip


def _model_of(tokens, logits, suppress, C, K):
    args, kw = _filtered_plain(tokens, logits, suppress)
    return model(bk.apply_filters(*args, **kw), C, K, True)


def _assert_close(lp, ref):
    lp, ref = np.asarray(lp, np.float32), np.asarray(ref, np.float32)
    assert np.array_equal(np.isfinite(lp), np.isfinite(ref))
    np.testing.assert_allclose(lp[np.isfinite(lp)], ref[np.isfinite(ref)], rtol=0, atol=SCORE_TOL)


def _check_case(case, C, tokens, logits, suppress, lp, tok):
    """The case really exercises what it names."""
    bounds = chunk_bounds(C)
    if case == "ts_inside_chunk" and C > 1:
        assert any(lo < TS_BEGIN < hi for lo, hi in bounds)
    if case == "masked_chunk":
        lo, hi = bounds[0]
        assert all(i in suppress for i in range(lo, min(hi, EOT)))
        assert not (tok == 10).any()
    if case == "ts_mass_fill":
        assert (tok[[0, 4], 0] >= V - 2).all()


# ---- the tests --------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("case", CASES)
def test_split_greedy_matches_plain_and_xla(case, C):
    tokens, logits, suppress = _inputs(case, C)
    lp, tok = _model_of(tokens, logits, suppress, C, 1)
    _check_case(case, C, tokens, logits, suppress, lp, tok)
    args, kw = _filtered_plain(tokens, logits, suppress)
    ptok, plp = bk.greedy_argmax_plain(*args, **kw)
    assert np.array_equal(tok[:, 0].numpy(), ptok.numpy())
    _assert_close(lp[:, 0], plp)
    filtered = _filtered_xla(tokens, logits, suppress)
    ref_tok = np.argmax(np.asarray(filtered), axis=-1)
    ref_lp = np.asarray(jax.nn.log_softmax(filtered, axis=-1))[np.arange(G), ref_tok]
    assert np.array_equal(tok[:, 0].numpy(), ref_tok)
    _assert_close(lp[:, 0], ref_lp)


@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("case", CASES)
def test_split_beam_candidates_match_plain_and_xla(case, C):
    K = G + 1
    tokens, logits, suppress = _inputs(case, C)
    lp, tok = _model_of(tokens, logits, suppress, C, K)
    _check_case(case, C, tokens, logits, suppress, lp, tok)
    # beam_update_plain's candidate stage: filter, stable sort, logit - lse
    args, kw = _filtered_plain(tokens, logits, suppress)
    filtered = bk.apply_filters(*args, **kw)
    top_raw, top_tok = torch.sort(filtered, dim=-1, descending=True, stable=True)
    plp = top_raw[:, :K] - torch.logsumexp(filtered, dim=-1)[:, None]
    assert np.array_equal(tok.numpy(), top_tok[:, :K].numpy())
    _assert_close(lp, plp)
    xf = _filtered_xla(tokens, logits, suppress)
    x_raw, x_tok = jax.lax.top_k(xf, K)
    x_lp = x_raw - jax.nn.logsumexp(xf, axis=-1)[:, None]
    assert np.array_equal(tok.numpy(), np.asarray(x_tok))
    _assert_close(lp, x_lp)
    if case == "ts_mass_fill":
        assert (tok[0, 2:] == torch.arange(K - 2)).all()  # the -inf fill
        assert (lp[0, 2:] == NEG_INF).all()
    if case == "edge_ties" and C > 1:
        e = chunk_bounds(C)[1][0]
        assert tok[0, 0] == e - 1 and tok[0, 1] == e  # a tie across the edge
