"""Numpy models of the schedules of the port's word-timing kernels
(whisper_tpu_torch/csrc/dtw.cu and csrc/median_filter.cu), held against the
JAX package's numpy references. The kernels run only on a card; these
models follow their index arithmetic step for step, so that the tiling,
the halos, the ragged edges, the hand-off between warps and the selection
network are checked here on the CPU. (Which warp of a DTW strip moves x and
the trace, the strip's own or its I/O warp, changes when, not where: the
model moves them at the tile boundaries both meet at.)

Tolerance: none. The DTW trace is a table of decisions taken on the same
float64 sums in the same order, and a median selects one of its inputs."""

import itertools

import numpy as np
import pytest

from whisper_tpu.ops.dtw import _dtw_table_np
from whisper_tpu.ops.median import median_filter_np

# ---- DTW: strips of 32 rows, tiles of 16 steps, a ring between strips -------

STRIP, TILE, RING = 32, 16, 64  # kStrip, kTile, kRing of dtw.cu


class _Pass:
    """A wait that is over once every other strip had its turn."""

    def __init__(self):
        self.turns = 0

    def __call__(self):
        self.turns += 1
        return self.turns > 1


def _strip(x, w, nw, ring, ring_col, produced, consumed, trace):
    """Warp w of dtw_trace_kernel as a generator: yields before each wait
    (a callable that says whether the wait is over), and once more after it
    frees ring slots, before it reads the ring: there the other strips run
    as far as their own waits let them, the worst case for an overwrite.
    Ring w holds the row above strip w (ring 0: the border row 0), each slot
    tagged with its column."""
    N, M = x.shape
    row0 = STRIP * w
    lanes = np.arange(STRIP)
    feeds = w + 1 < nw
    rows = min(STRIP, N - row0)
    tiles = (M + rows - 1 + TILE - 1) // TILE
    left = np.full(STRIP, np.inf)
    diag = np.full(STRIP, np.inf)
    if w == 0:
        diag[0] = 0.0

    # lane l moves cell (r, c) = (2q + l // 16, l % 16) of a tile, q < 16,
    # at flat offsets that step by a constant in q
    q_, l_ = np.meshgrid(np.arange(TILE), lanes, indexing="ij")
    half, cl = l_ // (STRIP // 2), l_ % TILE
    r_, c_ = 2 * q_ + half, cl
    xflat, ld = x.reshape(-1), M + 1

    def load_tile(t):  # x tile t: row r holds x[row0 + r, TILE*t - r + c]
        col = TILE * t + cl - half - 2 * q_
        ok = (row0 + half + 2 * q_ < N) & (col >= 0) & (col < M)
        src = (row0 + half) * M + (cl - half) + TILE * t + q_ * (2 * M - 2)
        buf = np.zeros((STRIP, TILE), np.float32)
        buf[r_[ok], c_[ok]] = xflat[src[ok]]
        return buf

    bufs = {0: load_tile(0)}
    for t in range(tiles):
        if t + 1 < tiles:
            bufs[(t + 1) & 1] = load_tile(t + 1)
        if w > 0:
            need = min(M, TILE * t + TILE)
            yield lambda: produced[w - 1] >= need
            consumed[w] = TILE * t
            yield _Pass()
        if feeds:
            need_free = TILE * t - (STRIP - 1) + TILE - RING
            yield lambda: consumed[w + 1] >= need_free

        def above(col):  # lane 31's read of the ring: cost[row0, col]
            slot = (col + STRIP - 2) % RING
            if w > 0 and col <= M:
                assert ring_col[w][slot] == col, f"ring {w} slot {slot}: {ring_col[w][slot]} for {col}"
            return ring[w][slot]

        xrow = np.where(TILE * t + np.arange(TILE)[None, :] - lanes[:, None] >= 0, bufs[t & 1], np.inf)
        send = np.where(lanes == STRIP - 1, above(TILE * t + 1), left)
        tt = np.zeros((TILE, STRIP), np.int8)
        for c in range(TILE):
            j = TILE * t + c - lanes + 1
            up = np.roll(send, 1)  # __shfl_sync from lane (l + 31) % 32
            c0, c1, c2 = diag, up, left
            take0 = (c0 < c1) & (c0 < c2)
            take1 = (c1 < c0) & (c1 < c2)
            tt[c] = np.where(take0, 0, np.where(take1, 1, 2))
            with np.errstate(invalid="ignore"):
                left = xrow[:, c].astype(np.float64) + np.where(take0, c0, np.where(take1, c1, c2))
            diag = up
            send = np.where(lanes == STRIP - 1, above(TILE * t + c + 2) if c + 1 < TILE else 0.0, left)
            if feeds and j[STRIP - 1] <= M:  # garbage before column 1, into free slots
                ring[w + 1][(j[STRIP - 1] + STRIP - 2) % RING] = left[STRIP - 1]
                ring_col[w + 1][(j[STRIP - 1] + STRIP - 2) % RING] = j[STRIP - 1]
        if feeds:
            produced[w] = min(M, TILE * t + TILE - (STRIP - 1))
        # the tile's trace, a half-warp per row, at offsets that step by a
        # constant in q
        j = TILE * t + cl - half + 1 - 2 * q_
        ok = (row0 + half + 2 * q_ < N) & (j >= 1) & (j <= M)
        dst = (row0 + half + 1) * ld + (cl - half + 1) + TILE * t + q_ * (2 * ld - 2)
        trace[dst[ok]] = tt[cl[ok], half[ok] + 2 * q_[ok]]


def dtw_schedule_np(x):
    """The (N+1, M+1) int8 trace as dtw.cu computes it: the warps advance
    in turns, a tile at a time, each as far as its waits allow; a round in
    which no warp can move is a deadlock."""
    N, M = x.shape
    nw = -(-N // STRIP)
    table = np.full((N + 1, M + 1), 99, np.int8)
    table[0, :] = -1
    table[:, 0] = -1
    trace = table.reshape(-1)
    ring = np.full((nw, RING), np.nan)
    ring[0] = np.inf  # the border row 0
    ring_col = np.full((nw, RING), -1)
    produced, consumed = [0] * nw, [0] * nw
    warps = [_strip(x, w, nw, ring, ring_col, produced, consumed, trace) for w in range(nw)]
    waits = [next(g, None) for g in warps]
    while any(wt is not None for wt in waits):
        moved = False
        for w, wt in enumerate(waits):
            while wt is not None and wt():
                wt = next(warps[w], None)
                moved = True
            moved |= isinstance(wt, _Pass) and wt.turns == 1
            waits[w] = wt
        if not moved:
            raise AssertionError("the strips wait on each other: deadlock")
    return table


@pytest.mark.parametrize("N, M", [(252, 1500), (33, 31), (1023, 40), (1, 1), (64, 17), (5, 40)])
@pytest.mark.parametrize("tied", [False, True])
def test_dtw_schedule_matches_np(N, M, tied):
    """Strips, tiles, the ring and its flags: ragged last strips (33, 1023),
    a last tile narrower than 16 columns, M < 32, the row limit, one cell."""
    rng = np.random.RandomState(N + M)
    x = rng.randint(-2, 3, size=(N, M)) if tied else rng.randn(N, M)
    x = x.astype(np.float32)
    np.testing.assert_array_equal(dtw_schedule_np(x), _dtw_table_np(x.astype(np.float64)))


# ---- median: tiles of 512 columns, a float4 halo, four outputs a thread -----

THREADS, OUTS = 128, 4  # kMedianThreads, kOuts of median_filter.cu
TILE_COLS = THREADS * OUTS


def to_key(f):
    """median_filter.cu:to_key: an int32 whose order is the NaN-last order."""
    f = np.asarray(f, np.float32)
    b = f.view(np.int32)
    k = b ^ ((b >> 31) & 0x7FFFFFFF)
    return np.where(np.isnan(f), np.int32(0x7FFFFFFF), k).astype(np.int32)


def from_key(k):
    k = np.asarray(k, np.int32)
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).astype(np.int32).view(np.float32)


def _cswap(w, i, j):
    lo = np.minimum(w[i], w[j])
    w[j] = np.maximum(w[i], w[j])
    w[i] = lo


def medians_np(v, width):
    """median_filter.cu:medians on keys v (..., 4 + 2H): the OUTS medians."""
    pad = width // 2
    H = (pad + 3) // 4 * 4
    u = [v[..., H - pad + q] for q in range(OUTS + width - 1)]
    if width == 7:
        a = [u[3], u[4], u[5], u[6]]
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            _cswap(a, i, j)
        r = []
        for p in range(2):
            b = [u[1], u[2]] if p == 0 else [u[7], u[8]]
            _cswap(b, 0, 1)
            s2 = np.minimum(a[2], np.minimum(np.maximum(a[1], b[0]), np.maximum(a[0], b[1])))
            s3 = np.minimum(a[3], np.minimum(np.maximum(a[2], b[0]), np.maximum(a[1], b[1])))
            e0, e1 = (u[0], u[7]) if p == 0 else (u[2], u[9])
            r += [np.maximum(s2, np.minimum(e0, s3)), np.maximum(s2, np.minimum(e1, s3))]
        return np.stack(r, axis=-1)
    r = []
    for o in range(OUTS):
        w = [u[o + k] for k in range(width)]
        for p in range(width):
            for i in range(p % 2, width - 1, 2):
                _cswap(w, i, i + 1)
        r.append(w[pad])
    return np.stack(r, axis=-1)


def median_schedule_np(x, width, n_valid):
    """x (R, T) f32 -> the kernel's output: per 512-column tile, the keys of
    the tile and its halo (zero outside the row), each thread's four
    outputs from 4 + 2H keys, read in place or, where a window crosses
    column 0 or n_valid - 1, gathered reflected; outputs at or past n_valid
    copy the input."""
    R, T = x.shape
    pad = width // 2
    H = (pad + 3) // 4 * 4
    span, nv = TILE_COLS + 2 * H, OUTS + 2 * H
    out = np.empty_like(x)
    tid = np.arange(THREADS)
    for b in range(-(-T // TILE_COLS)):
        lo = b * TILE_COLS - H
        cols = lo + np.arange(span)
        ok = (cols >= 0) & (cols < T)
        s = np.where(ok, to_key(x[:, np.clip(cols, 0, T - 1)]), 0).astype(np.int32)
        j0 = lo + H + OUTS * tid  # (THREADS,)
        q = np.arange(nv)
        direct = OUTS * tid[:, None] + q  # (THREADS, nv)
        c = j0[:, None] - H + q
        c = np.where(c < 0, -c, c)
        c = np.where(c >= n_valid, 2 * n_valid - 2 - c, c)
        gathered = np.clip(c - lo, 0, span - 1)
        fast = (j0 - pad >= 0) & (j0 + OUTS - 1 + pad < n_valid)
        idx = np.where(fast[:, None], direct, gathered)
        r = medians_np(s[:, idx], width)  # (R, THREADS, OUTS)
        jj = j0[:, None] + np.arange(OUTS)  # (THREADS, OUTS)
        raw = s[:, np.clip(jj - lo, 0, span - 1)]
        res = from_key(np.where(jj < n_valid, r, raw)).reshape(R, -1)
        jj = jj.reshape(-1)
        keep = jj < T
        out[:, jj[keep]] = res[:, keep]
    return out


@pytest.mark.parametrize("T", [1500, 1502, 37])
@pytest.mark.parametrize("n_valid", [4, 551, "T"])
@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_median_schedule_matches_np(T, n_valid, width):
    """The tiling, the halo, reflection at 0 and at n_valid, four outputs a
    thread and the networks, at T = 1500, at a T that is not a multiple of 4
    and at a T shorter than a tile; on a coarse grid (equal values)."""
    n_valid = T if n_valid == "T" else min(max(n_valid, width // 2 + 1), T)
    x = np.round(np.random.RandomState(T + width).randn(6, T) * 2) / 2
    x = x.astype(np.float32)
    got = median_schedule_np(x, width, n_valid)
    np.testing.assert_array_equal(got[:, :n_valid], median_filter_np(x[:, :n_valid], width))
    np.testing.assert_array_equal(got[:, n_valid:], x[:, n_valid:])


SPECIAL = np.array([np.nan, -np.inf, -1.0, -0.0, 0.0, 1.0, np.inf], np.float32)


def test_width7_network_orders_nan_last_on_every_window():
    """Every window of 7 drawn from {NaN, -inf, -1, -0.0, 0.0, 1, inf} (7^7
    of them): the key transform and the width-7 network give np.sort's
    median. Each window is fed as the ten keys of a thread whose four
    windows are rotations of it."""
    w = np.array(list(itertools.product(range(7), repeat=7)), np.int8)
    vals = SPECIAL[w]  # (7^7, 7)
    v = np.concatenate([np.zeros((len(w), 1), np.float32), vals, vals[:, :3], np.zeros((len(w), 1), np.float32)], axis=1)  # fmt: skip
    got = from_key(medians_np(to_key(v), 7))  # (7^7, 4): windows v[1+o .. 7+o]
    want = np.sort(vals, axis=-1)[:, 3]
    for o in range(OUTS):
        np.testing.assert_array_equal(got[:, o], want)


@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_networks_match_sort_on_special_values(width):
    """Each network's OUTS windows against np.sort, on random rows of the
    special values and on random 0/1 rows (the 0-1 principle: a network of
    min/max that selects the median of every 0/1 input does so for every
    input)."""
    pad = width // 2
    H = (pad + 3) // 4 * 4
    rng = np.random.RandomState(width)
    rows = [SPECIAL[rng.randint(0, 7, size=(20000, OUTS + 2 * H))]]
    rows.append(rng.randint(0, 2, size=(20000, OUTS + 2 * H)).astype(np.float32))
    for v in rows:
        got = from_key(medians_np(to_key(v), width))
        for o in range(OUTS):
            win = v[:, H - pad + o : H - pad + o + width]
            np.testing.assert_array_equal(got[:, o], np.sort(win, axis=-1)[:, pad])


def test_key_round_trip():
    """from_key(to_key(f)) is f, bit for bit, for every non-NaN float
    pattern sampled; any NaN comes back as a NaN."""
    b = np.random.RandomState(0).randint(-(2**31), 2**31 - 1, size=200000, dtype=np.int64)
    f = b.astype(np.int32).view(np.float32)
    back = from_key(to_key(f))
    nan = np.isnan(f)
    np.testing.assert_array_equal(back[~nan].view(np.int32), f[~nan].view(np.int32))
    assert np.isnan(back[nan]).all()
    assert (np.diff(to_key(np.sort(f[~nan]))) >= 0).all()
