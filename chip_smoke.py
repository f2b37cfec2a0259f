"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from whisper_tpu_torch/csrc/ with nvcc (sm_90a),
     and beside them the smoke's own empty kernel (smoke/empty_kernel.cu);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's widths. The update kernels (V = 51866, T = 448), in
     clusters of the size they use on the card, on float32 logits, on
     bf16-rounded logits, on logits with planted ties (equal maxima in a
     row, equal candidates across beams, equal maxima on both sides of
     every chunk edge), with whole chunks suppressed, and with all but four
     ids suppressed; greedy at B = 1, 2, 5, 8 and beam at (A, G) = (1, 1),
     (1, 2), (2, 5), (3, 5), (1, 8), so odd rows too; on inputs that start
     4 bytes past an 8-byte boundary (offset views: the scalar-load build):
     ids, sources, token buffers and pools exactly, scores within 1e-5;
     then 1,000 back-to-back launches alternating two inputs, compared
     after the last; and the odd-vocabulary build (V = 51865) on randn and
     edge ties. Each update kernel's device ms and ms per call, beside the
     device ms of the empty kernel at the same launch shape and at one CTA,
     and torch.topk(logits, K) on the same rows. The DTW trace at
     (252, 1500), (40, 750), (234, 189) and (10, 20) on randn and on
     integer-valued (tied) costs: trace and path bit for bit. The median
     filter at 40 heads x 224 rows x 1500 frames, width 7, reflecting at
     1500 and at 551, on randn and on a coarse grid: exactly equal (widths
     3, 5 and 13 likewise on 300 rows). Time
     kernel and plain version on the device (the profiler's kernel records)
     and per call with the host's work (CUDA events, median of the calls);
     time `unfold(...).median(-1)` beside the median filter;
  3. check that the graphs' float32 products of bf16 operands (logits,
     attention scores) are summed in float32 on the card and not rounded
     to bf16 (within 1e-4 of the float64 product);
  4. decode greedy and beam 5 at tiny dims in float32 on the card and on
     the CPU with the same seeded weights: equal tokens, avg_logprob within
     1e-3; transcribe() jfk with word timestamps on both: equal words,
     times within 1e-6 s; and jfk, 8 s of silence, jfk twice with
     hallucination_silence_threshold=2.0: each window's segments and words
     as aligned, and the kept segments, equal (times within 1e-6 s);
  5. transcribe() a 60 s clip (tests/data/jfk.flac tiled) at turbo width
     with seeded random bf16 weights: greedy with the default temperature
     ladder, beam 5 at temperature 0, greedy at temperature 0 with word
     timestamps, and its first 20 s with word timestamps and
     hallucination_silence_threshold=2.0. Check that the update kernels'
     launch counts equal the temperature-0 updates of their mode, that the
     DTW and median kernels launch once per aligned window, and that every
     word is finite, ordered and in its window; print the replay's share of
     the wall time, and time the cross-K/V each replay computes;
  6. profile one greedy window and one beam-5 window of decode() at turbo
     width: wall time, device-busy time, kernels, the update kernel's
     device time and the host's blocked read of the `completed` flag, per
     step of the engine's loop;
  7. print the kernels line, the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, where CUDA is not available.
"""

import contextlib
import copy
import ctypes
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script runs only on a card")

from whisper_tpu_torch import DecodingOptions, decode, load_audio  # noqa: E402
from whisper_tpu_torch.kernels import build  # noqa: E402
from whisper_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions  # noqa: E402
from whisper_tpu_torch.models import graphs  # noqa: E402
from whisper_tpu_torch.models.params import init_random_params  # noqa: E402
from whisper_tpu_torch.models.whisper import Whisper  # noqa: E402
from whisper_tpu_torch.ops import beam_kernel as bk  # noqa: E402
from whisper_tpu_torch.ops import dtw, median  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
V, T = 51866, 448
TS_BEGIN, EOT, NO_TS = 50365, 50257, 50364  # large-v3 / turbo vocabulary
SAMPLE_BEGIN = 3
SCORE_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
REPS = 100
EMPTY = {}  # the empty kernel's nvcc process ("nvcc"), then its library ("lib")


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps=REPS) -> float:
    """Median time of one call, host work included: CUDA events recorded
    around each single call (warmed up)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=REPS, kernel=None, attempts=3):
    """Device time per call from the profiler's CUDA kernel records: of the
    kernels whose name contains `kernel`, or of every kernel the call ran.
    Returns (ms per call, kernels per call). The profiler has, in rare runs,
    kept no record of a short kernel at all; such a profile is taken again,
    up to `attempts` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and (
                kernel is None or kernel in e.name
            ):
                us += e.time_range.elapsed_us()
                n += 1
        if n:
            return us / reps / 1e3, n / reps
        log(json.dumps({"phase": "profiler_empty", "kernel": kernel, "attempt": attempt}))
    raise RuntimeError(f"the profiler recorded no CUDA kernel in {attempts} profiles")


def kernel_ms(fn, wrapper, name, reps=REPS):
    """Device ms per launch of the kernel `name`: the mean of the profiler's
    records of it (the profiler may drop a few records of a short kernel),
    after checking on the wrapper's count that each call launches it once."""
    before = wrapper.launches
    fn()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{name}: {wrapper.launches - before} launches per call")
    per_call_ms, per_call = device_ms(fn, reps, kernel=name)
    if not 0 < per_call <= 1:
        raise AssertionError(f"{name}: the profiler saw {per_call} launches per call")
    return per_call_ms / per_call


# ---- phase 1: the smoke's own empty kernel ---------------------------------

EMPTY_SRC = os.path.join(ROOT, "smoke", "empty_kernel.cu")
EMPTY_LIB = os.path.join(ROOT, "smoke", "_build", "empty_kernel.so")


def start_empty_build():
    """Start nvcc on smoke/empty_kernel.cu, to run beside the port's build."""
    os.makedirs(os.path.dirname(EMPTY_LIB), exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", EMPTY_LIB, EMPTY_SRC]
    EMPTY["nvcc"] = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def empty_lib():
    """The empty kernel's library: waits for the build (started here if it
    was not started yet) and loads it."""
    if "lib" not in EMPTY:
        if "nvcc" not in EMPTY:
            start_empty_build()
        proc = EMPTY.pop("nvcc")
        out = proc.communicate(timeout=300)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {EMPTY_SRC}:\n{out}")
        lib = ctypes.CDLL(EMPTY_LIB)
        lib.wtt_empty_kernel.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.wtt_empty_kernel.restype = ctypes.c_int
        EMPTY["lib"] = lib
    return EMPTY["lib"]


# ---- phase 2: kernels vs plain versions --------------------------------------


def chunk_edges(C, W=2):
    """The first ids of chunks 1..C-1 when the kernels split a row of V ids
    into C chunks (update_common.cuh:chunk_bounds, units of W ids: 2 for
    float2 loads, 1 for the scalar-load build)."""
    n = -(-V // C)
    n += -n % W
    return [c * n for c in range(1, C) if c * n < V]


def offset_view(t):
    """A copy of `t` as a contiguous view whose data starts 4 bytes past an
    8-byte boundary: the update kernels must then take their scalar-load
    build (float2 loads from it would fault)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 8 != 4:
        raise AssertionError("the offset view is 8-byte aligned")
    return view


def offset_inputs(args, which, logits_at, pens_at):
    """`args` with the logits (`which` = "logits"), the suppress vector
    ("suppress") or both and the begin vector ("all") as offset views;
    `logits_at` and `pens_at` are their positions in `args`."""
    args = list(args)
    if which in ("logits", "all"):
        args[logits_at] = offset_view(args[logits_at])
    if which in ("suppress", "all"):
        args[pens_at] = offset_view(args[pens_at])
    if which == "all":
        args[pens_at + 1] = offset_view(args[pens_at + 1])
    return tuple(args)


def penalties(use_ts, suppressed=None, allowed=None):
    """The penalty vectors; `suppressed` ids are also set to -inf, and with
    `allowed` every other id is."""
    sup, beg = bk.build_penalty_vectors(
        V, [1, 2, 3, 11, 220], [220, EOT], use_timestamps=use_ts, no_timestamps=NO_TS,
        timestamp_begin=TS_BEGIN, max_initial_ts_index=50,
    )  # fmt: skip
    if suppressed is not None:
        sup[suppressed] = -np.inf
    if allowed is not None:
        keep = sup[allowed]
        sup[:] = -np.inf
        sup[allowed] = keep
    return torch.from_numpy(sup).to(DEV), torch.from_numpy(beg).to(DEV)


def masks(mode, C, W=2):
    """Extra suppression for the modes that empty whole stretches of a row:
    `masked_chunk` suppresses all of chunk 0, the rank-0 CTA's (where a large
    logit is planted), and chunk 1 too where it ends below EOT (a row with
    no finite logit is not a state the decoder reaches: the plain version
    gives NaN there); `sparse` allows four ids only (two text ids in the
    first and the last chunk, two timestamps), so most of a row's top-K is
    -inf and most chunks are empty."""
    edges = chunk_edges(C, W) + [V]
    if mode == "masked_chunk":
        hi = edges[1] if len(edges) > 2 and edges[1] < EOT else edges[0]
        return dict(suppressed=np.arange(0, min(hi, EOT)))
    if mode == "sparse":
        last = edges[-2] if C > 1 else 1000
        return dict(allowed=[7, last + 3, TS_BEGIN + 40, V - 1])
    return {}


def history(rng, rows, n_tokens, step, G):
    tokens = rng.randint(100, 5000, size=(rows, T)).astype(np.int32)
    if step > 0:
        tokens[1 % rows, 4] = TS_BEGIN + 10
        tokens[1 % rows, 5] = TS_BEGIN + 10
        tokens[2 % rows, n_tokens - 1] = TS_BEGIN + 30  # mid-pair
        tokens[3 % rows, n_tokens - 2] = TS_BEGIN + 7  # pair just closed
        tokens[3 % rows, n_tokens - 1] = TS_BEGIN + 12
    else:
        tokens = np.repeat(tokens[::G], G, axis=0)
    return torch.from_numpy(tokens).to(DEV)


def bf16_rounded(logits):
    """The logits rounded to bf16's grid (and back): many exact ties."""
    return torch.from_numpy(logits).bfloat16().float().numpy()


def plant_edge_ties(logits, C, rows, W=2):
    """Equal maxima on both sides of every chunk edge e (ids e-1 and e); in
    odd rows id e-1 of the first edge sits just below them, so the lowest
    tied id is the first id of chunk 1 and wins over ties further up."""
    edges = chunk_edges(C, W) or [V // 2]
    for r in range(rows):
        top = logits[r].max() + 1.0
        for e in edges:
            logits[r, [e - 1, e]] = top
        if r % 2:
            logits[r, edges[0] - 1] = top - 1e-3


def plant_masked(logits):
    """A logit far above the rest inside the suppressed chunk 0."""
    logits[:, 10] += 20.0


GREEDY_CASES = [
    # (rows, n_tokens, use_ts, mode)
    (1, 3, True, "randn"), (1, 40, True, "randn"), (5, 8, True, "randn"),
    (5, 12, True, "ts_mass"), (5, 10, False, "randn"), (1, 9, False, "randn"),
    (1, 3, True, "bf16"), (5, 20, True, "bf16"), (1, 3, True, "ties"),
    (5, 14, True, "ties"), (5, 9, False, "ties"),
    # chunk edges, empty chunks, and B = 2 and 8
    (2, 8, True, "randn"), (8, 12, True, "ts_mass"), (1, 9, False, "edge_ties"),
    (2, 10, False, "edge_ties"), (5, 14, True, "edge_ties"), (8, 9, False, "edge_ties"),
    (1, 12, True, "masked_chunk"), (5, 9, False, "masked_chunk"), (2, 9, False, "sparse"),
    (8, 14, True, "sparse"),
]  # fmt: skip


def greedy_case(seed, rows, n_tokens, use_ts, mode, C, W=2):
    rng = np.random.RandomState(seed)
    tokens = history(rng, rows, n_tokens, 1 if n_tokens > 4 else 0, 1)
    logits = rng.randn(rows, V).astype(np.float32)
    if mode == "ts_mass":
        logits[0, TS_BEGIN + 40 :] += 4.0  # the timestamp-mass rule fires
    elif mode == "bf16":
        logits = bf16_rounded(logits)
    elif mode == "ties":
        # equal maxima in every row; row 0's lowest tied id (11) is
        # suppressed, so the next tied id must win
        for r in range(rows):
            ids = rng.choice(np.arange(400, TS_BEGIN), size=3, replace=False)
            logits[r, ids] = logits[r].max() + 1.0
        logits[0, 11] = logits[0].max()
    elif mode == "edge_ties":
        plant_edge_ties(logits, C, rows, W)
    elif mode == "masked_chunk":
        plant_masked(logits)
    pens = penalties(use_ts, **masks(mode, C, W))
    args = (torch.from_numpy(logits).to(DEV), tokens, n_tokens, SAMPLE_BEGIN, *pens)
    kw = dict(use_timestamps=use_ts, eot=EOT, timestamp_begin=TS_BEGIN)
    return args, kw


def same_greedy(args, kw, out, what):
    ptok, plp = bk.greedy_argmax_plain(*args, **kw)
    torch.cuda.synchronize()
    tok, lp = out
    if not torch.equal(tok, ptok):
        raise AssertionError(f"greedy_argmax ids differ ({what}): {tok.tolist()} {ptok.tolist()}")
    e = (lp - plp).abs().max().item()
    if not e <= SCORE_TOL:
        raise AssertionError(f"greedy_argmax log-prob differs by {e} ({what})")
    return e


# (rows, n_tokens, use_ts, mode, the inputs given as offset views)
GREEDY_OFFSET_CASES = [
    (5, 14, True, "randn", "logits"), (5, 9, False, "edge_ties", "suppress"),
    (2, 3, True, "ties", "all"), (8, 12, True, "masked_chunk", "all"),
]  # fmt: skip


def check_greedy():
    """Every case, then the offset-view cases (scalar-load build); then
    1,000 back-to-back launches alternating two inputs, compared after the
    last; then the timings at the main path's shape, one row past the first
    step."""
    err, C = 0.0, bk.cluster_sizes(1, V)[0]
    for seed, case in enumerate(GREEDY_CASES):
        args, kw = greedy_case(seed, *case, C)
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), f"{case}, C={C}"))
    for seed, (*case, which) in enumerate(GREEDY_OFFSET_CASES, 50):
        args, kw = greedy_case(seed, *case, C, W=1)
        args = offset_inputs(args, which, 0, 4)
        what = f"{case}, {which} offset, C={C}"
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), what))
    x = greedy_case(101, 5, 14, True, "randn", C)
    y = greedy_case(102, 5, 14, True, "edge_ties", C)
    for _ in range(500):
        out_x = bk.greedy_argmax(*x[0], **x[1])
        out_y = bk.greedy_argmax(*y[0], **y[1])
    err = max(err, same_greedy(*x, out_x, "launch 999"), same_greedy(*y, out_y, "launch 1000"))
    args, kw = greedy_case(99, 1, 60, True, "randn", C)
    n_hist = 60 - SAMPLE_BEGIN + 2
    nbytes = 4 * (V + V + n_hist) + 8  # logits, suppress, history; tok + lp
    return timings(
        lambda: bk.greedy_argmax(*args, **kw), lambda: bk.greedy_argmax_plain(*args, **kw),
        bk.greedy_argmax, "greedy_argmax_kernel", err, nbytes, C,
        lambda: torch.topk(args[0], 1, dim=-1),
    )  # fmt: skip


def empty_ms(grid, cluster):
    """Device ms of one launch of the empty kernel on `grid` CTAs in
    clusters of `cluster`: the mean of the profiler's records of it."""
    lib, stream = empty_lib(), torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.wtt_empty_kernel(grid, cluster, stream)
        if rc:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")

    per_call_ms, per_call = device_ms(launch, kernel="empty_kernel", attempts=6)
    return per_call_ms / per_call


def timings(kernel_fn, plain_fn, wrapper, kernel_name, err, nbytes, cluster, topk_fn):
    """Device ms (profiler) and ms per call (CUDA events) of the kernel,
    which launches clusters of `cluster` CTAs, with the empty kernel's
    device ms at the same launch shape and at one CTA, `topk_fn`
    (torch.topk on the same rows) and the plain version."""
    plain_ms, plain_kernels = device_ms(plain_fn)
    topk_ms, topk_kernels = device_ms(topk_fn)
    return dict(
        max_abs_err=err, ms=kernel_ms(kernel_fn, wrapper, kernel_name),
        call_ms=call_ms(kernel_fn), cluster=cluster, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, plain_call_ms=call_ms(plain_fn),
        plain_kernels_per_call=plain_kernels, bytes=nbytes, topk_ms=topk_ms,
        topk_kernels_per_call=topk_kernels, empty_ms=empty_ms(cluster, cluster),
        empty_1cta_ms=empty_ms(1, 1),
    )  # fmt: skip


def planted_ties(A, G):
    """Logits whose candidates tie exactly, within a beam and across beams:
    -1e4 everywhere (exp underflows to 0, so every row's log-sum-exp is the
    log of a small integer whatever the summation order), 0.0 at a few
    tokens. In each audio, beams 0-2 are equal rows with four tokens tied,
    beam 3 ties EOT with a text token, beam 4 has one token; the rest of
    each beam's top-(G+1) ties at -1e4 and goes to the lowest ids."""
    logits = np.full((A * G, V), -1e4, np.float32)
    for a in range(A):
        rows = logits[a * G : (a + 1) * G]
        rows[: min(3, G), [600, 601, 900, 3000]] = 0.0
        if G > 3:
            rows[3, [650, EOT]] = 0.0
        if G > 4:
            rows[4, 800 + a] = 0.0
    return logits


BEAM_CASES = [
    # (A, G, n_tokens, step, use_ts, mode, fcount)
    (1, 5, 3, 0, True, "randn", 0), (1, 5, 40, 20, True, "randn", 0),
    (1, 5, 8, 3, True, "eot", 0), (1, 5, 10, 5, False, "eot", 0), (2, 5, 8, 3, True, "eot", 2),
    (2, 5, 9, 4, True, "eot", 4), (2, 5, 3, 0, False, "randn", 0), (1, 5, 3, 0, True, "bf16", 0),
    (2, 5, 30, 12, True, "bf16", 0), (1, 5, 3, 0, False, "ties", 0),
    (1, 5, 12, 6, False, "ties", 0), (2, 5, 12, 6, True, "ties", 1),
    # (A, G) = (1, 1), (1, 2), (2, 5), (3, 5), (1, 8); chunk edges, empty chunks
    (1, 1, 9, 4, True, "eot", 0), (1, 1, 3, 0, True, "randn", 0),
    (1, 2, 12, 6, True, "edge_ties", 0), (1, 2, 3, 0, False, "edge_ties", 0),
    (2, 5, 12, 6, False, "edge_ties", 0), (2, 5, 9, 4, False, "masked_chunk", 0),
    (3, 5, 10, 5, True, "eot", 1), (3, 5, 12, 6, True, "sparse", 0),
    (3, 5, 14, 7, True, "edge_ties", 0), (1, 8, 14, 7, True, "randn", 0),
    (1, 8, 12, 6, False, "edge_ties", 0), (1, 8, 9, 4, True, "masked_chunk", 0),
]  # fmt: skip


def beam_case(seed, A, G, n_tokens, step, use_ts, mode, fcount, C, MC=5, W=2):
    rng = np.random.RandomState(seed)
    tokens = history(rng, A * G, n_tokens, step, G)
    logits = rng.randn(A * G, V).astype(np.float32)
    sum_lp = (rng.randn(A * G) * (step > 0)).astype(np.float32)
    if mode == "eot":
        logits[:, EOT] += 12.0  # EOT candidates reach the pools
    elif mode == "bf16":
        logits = bf16_rounded(logits)
    elif mode == "ties":
        logits = planted_ties(A, G)
        sum_lp[:] = 0.0  # equal beams give equal candidates
    elif mode == "edge_ties":
        logits = np.repeat(logits[::G], G, axis=0)  # equal beams: ties across beams
        plant_edge_ties(logits, C, A * G, W)
        sum_lp[:] = 0.0
    elif mode == "masked_chunk":
        plant_masked(logits)
    sum_lp = torch.from_numpy(sum_lp).to(DEV)
    pool = [
        torch.zeros((A, MC, T + 1), dtype=torch.int32, device=DEV),
        torch.full((A, MC), float("-inf"), device=DEV),
        torch.zeros((A, MC), dtype=torch.int32, device=DEV),
        torch.full((A,), fcount, dtype=torch.int32, device=DEV),
    ]
    head = (torch.from_numpy(logits).to(DEV), tokens, sum_lp)
    tail = (n_tokens, SAMPLE_BEGIN, step, *penalties(use_ts, **masks(mode, C, W)))
    kw = dict(n_group=G, use_timestamps=use_ts, eot=EOT, timestamp_begin=TS_BEGIN)
    return head, pool, tail, kw


def same_beam(case, k, kpool, what):
    """The kernel's result `k` and pools `kpool` (from the fresh pools of
    `case`) against the plain version's; returns the largest score error."""
    head, pool, tail, kw = case
    pool = [p.clone() for p in pool]
    p = bk.beam_update_plain(*head, *pool, *tail, **kw)
    torch.cuda.synchronize()
    n = tail[0] + 1
    same = (
        torch.equal(k[0][:, :n], p[0][:, :n]) and torch.equal(k[1], p[1])
        and torch.equal(kpool[0], pool[0]) and torch.equal(kpool[2], pool[2])
        and torch.equal(kpool[3], pool[3])
    )  # fmt: skip
    if not same:
        raise AssertionError(f"beam_update differs ({what})")
    finite = torch.isfinite(pool[1])
    if not torch.equal(finite, torch.isfinite(kpool[1])):
        raise AssertionError(f"beam_update pool scores differ in which are finite ({what})")
    if not torch.equal(torch.isfinite(k[2]), torch.isfinite(p[2])):
        raise AssertionError(f"beam_update scores differ in which are finite ({what})")
    fin = torch.isfinite(p[2])
    e = max(
        (k[2][fin] - p[2][fin]).abs().max().item() if fin.any() else 0.0,
        (kpool[1][finite] - pool[1][finite]).abs().max().item() if finite.any() else 0.0,
    )
    if not e <= SCORE_TOL:
        raise AssertionError(f"beam_update scores differ by {e} ({what})")
    return e


# (A, G, n_tokens, step, use_ts, mode, fcount, the inputs given as offset views)
BEAM_OFFSET_CASES = [
    (2, 5, 12, 6, True, "eot", 1, "logits"), (3, 5, 14, 7, False, "edge_ties", 0, "all"),
    (1, 2, 3, 0, True, "randn", 0, "suppress"),
]  # fmt: skip


def check_beam():
    """Every case, then the offset-view cases (scalar-load build); then
    1,000 back-to-back launches alternating two inputs (neither collects an
    EOT, so the pools stay as they were), compared after the last; then the
    timings at the main path's shape: one audio, beam 5, mid-window."""
    err = 0.0
    cases = [(*c, None) for c in BEAM_CASES] + BEAM_OFFSET_CASES
    for seed, (A, G, n_tokens, step, use_ts, mode, fcount, which) in enumerate(cases):
        C = bk.cluster_sizes(G, V)[1] // G
        W = 1 if which else 2
        head, pool, tail, kw = beam_case(seed, A, G, n_tokens, step, use_ts, mode, fcount, C, W=W)
        if which:
            args = offset_inputs(head + tail, which, 0, 6)
            head, tail = args[:3], args[3:]
        case = (head, pool, tail, kw)
        kpool = [p.clone() for p in pool]
        k = bk.beam_update(*head, *kpool, *tail, **kw)
        what = f"{mode}, A={A}, G={G}, n_tokens={n_tokens}, step={step}, C={C}, offset={which}"
        err = max(err, same_beam(case, k, kpool, what))
        if mode in ("eot", "ties") and step > 0 and int(kpool[3].sum()) <= fcount * A:
            raise AssertionError(f"the EOT case put nothing into the pools ({what})")
    C = bk.cluster_sizes(5, V)[1] // 5
    x = beam_case(101, 3, 5, 14, 7, True, "randn", 0, C)
    y = beam_case(102, 3, 5, 14, 7, True, "edge_ties", 0, C)
    for case in (x, y):
        case[0][0][:, EOT] = float("-inf")  # no EOT candidate: the pools stay
    kx, ky = [p.clone() for p in x[1]], [p.clone() for p in y[1]]
    for _ in range(500):
        out_x = bk.beam_update(*x[0], *kx, *x[2], **x[3])
        out_y = bk.beam_update(*y[0], *ky, *y[2], **y[3])
    err = max(err, same_beam(x, out_x, kx, "launch 999"), same_beam(y, out_y, ky, "launch 1000"))
    head, pool, tail, kw = beam_case(99, 1, 5, 60, 40, True, "randn", 0, C)
    G = 5
    # logits, suppress, sum_lp, the source rows read and the new rows written
    nbytes = 4 * (G * V + V + G + 2 * G * T) + 8 * G + 4
    return timings(
        lambda: bk.beam_update(*head, *pool, *tail, **kw),
        lambda: bk.beam_update_plain(*head, *pool, *tail, **kw),
        bk.beam_update, "beam_update_kernel", err, nbytes, G * C,
        lambda: torch.topk(head[0], G + 1, dim=-1),
    )  # fmt: skip


def check_odd_vocab():
    """The update kernels' scalar-load build (an odd V: a row of float32
    logits is then 4-byte aligned at odd rows) at the pre-v3 multilingual
    vocabulary (V = 51865, timestamps from 50364), on randn logits and on
    equal maxima on both sides of every greedy and beam chunk edge: greedy
    at B = 5, beam at (A, G) = (2, 5) with EOT candidates. Returns the
    largest score error."""
    Vo, ts_begin, A, G, n_tokens = 51865, 50364, 2, 5, 12
    sup, beg = bk.build_penalty_vectors(
        Vo, [1, 2, 3, 11, 220], [220, EOT], use_timestamps=True, no_timestamps=ts_begin - 1,
        timestamp_begin=ts_begin, max_initial_ts_index=50,
    )  # fmt: skip
    pens = (torch.from_numpy(sup).to(DEV), torch.from_numpy(beg).to(DEV))
    kw = dict(use_timestamps=True, eot=EOT, timestamp_begin=ts_begin)
    rng, err = np.random.RandomState(17), 0.0
    for mode in ("randn", "edge_ties"):
        logits = rng.randn(A * G, Vo).astype(np.float32)
        if mode == "edge_ties":
            for C in (bk.cluster_sizes(G, Vo)[0], bk.cluster_sizes(G, Vo)[1] // G):
                n = -(-Vo // C)
                for e in range(n, Vo, n):
                    logits[:, [e - 1, e]] = 14.0
        logits[G:, EOT] = 20.0  # above the ties: audio 1 collects EOT candidates
        tokens = history(rng, A * G, n_tokens, 6, G)
        lg = torch.from_numpy(logits).to(DEV)
        args = (lg[:G], tokens[:G], n_tokens, SAMPLE_BEGIN, *pens)
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), f"V={Vo}, {mode}"))
        sum_lp = torch.from_numpy(rng.randn(A * G).astype(np.float32)).to(DEV)
        pool = [
            torch.zeros((A, 5, T + 1), dtype=torch.int32, device=DEV),
            torch.full((A, 5), float("-inf"), device=DEV),
            torch.zeros((A, 5), dtype=torch.int32, device=DEV),
            torch.zeros((A,), dtype=torch.int32, device=DEV),
        ]
        case = ((lg, tokens, sum_lp), pool, (n_tokens, SAMPLE_BEGIN, 6, *pens), dict(kw, n_group=G))
        kpool = [p.clone() for p in pool]
        k = bk.beam_update(*case[0], *kpool, *case[2], **case[3])
        err = max(err, same_beam(case, k, kpool, f"V={Vo}, {mode}"))
        if int(kpool[3].sum()) == 0:
            raise AssertionError("the odd-vocabulary beam case put nothing into the pools")
    return err


# ---- phase 2b: the word-timing kernels vs plain versions -------------------


KDTW, KMEDIAN = "dtw_trace_kernel", "median_filter_kernel"


def dtw_case(N, M, tied, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, size=(N, M)) if tied else rng.randn(N, M)
    return torch.from_numpy(x.astype(np.float32)).to(DEV)


def check_dtw():
    """Trace tables and backtraced paths equal, bit for bit, on randn and
    on integer-valued (tied) costs; device ms per shape; plain and per-call
    times at the main path's largest shape (N = 252 tokens, M = 1500)."""
    shapes = [(252, 1500), (40, 750), (234, 189), (10, 20)]
    per_shape = {}
    for seed, (N, M) in enumerate(shapes):
        for tied in (False, True):
            x = dtw_case(N, M, tied, seed)
            k, p = dtw.dtw_trace(x), dtw.dtw_trace_plain(x)
            torch.cuda.synchronize()
            if k.dtype != torch.int8 or not torch.equal(k, p):
                raise AssertionError(f"dtw_trace differs from plain at {(N, M)}, tied={tied}")
            kp, pp = dtw.backtrace(k.cpu().numpy()), dtw.backtrace(p.cpu().numpy())
            if not np.array_equal(kp, pp):
                raise AssertionError(f"dtw paths differ at {(N, M)}, tied={tied}")
        per_shape[f"{N}x{M}"] = kernel_ms(lambda: dtw.dtw_trace(x), dtw.dtw_trace, KDTW, 20)
    N, M = shapes[0]
    x = dtw_case(N, M, False, 0)
    ms = kernel_ms(lambda: dtw.dtw_trace(x), dtw.dtw_trace, KDTW, 20)
    nbytes = 4 * N * M + (N + 1) * (M + 1)  # x read once, the int8 trace written once
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=device_ms(lambda: dtw.dtw_trace_plain(x), reps=2)[0],
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, call_ms=call_ms(lambda: dtw.dtw_trace(x), 20),
        plain_call_ms=call_ms(lambda: dtw.dtw_trace_plain(x), 2), bytes=nbytes,
        barriers=N + M - 1, device_ms_per_shape=per_shape, library_ms=None,
    )  # fmt: skip


def check_median():
    """Exactly equal on the valid columns (and the copied ones past them),
    at 40 heads x 224 rows x 1500 frames, width 7, reflecting at 1500 and
    at 551, on randn inputs and on inputs on a coarse grid (equal values);
    widths 3, 5 and 13 likewise on 300 rows."""
    R, T, W = 40 * 224, 1500, 7
    gen = torch.Generator(device=DEV).manual_seed(7)
    base = torch.randn((R, T), generator=gen, device=DEV)
    for grid in (False, True):
        x = torch.round(base * 4) / 4 if grid else base
        for n_valid in (T, 551):
            k = median.median_filter(x, W, n_valid=n_valid)
            p = median.median_filter_plain(x, W, n_valid=n_valid)
            torch.cuda.synchronize()
            if not torch.equal(k[:, :n_valid], p[:, :n_valid]) or not torch.equal(k, p):
                raise AssertionError(f"median_filter differs (grid={grid}, n_valid={n_valid})")
    # the kernel's other widths (the JAX package's test widths), on 300 rows
    for w in (3, 5, 13):
        for grid in (False, True):
            x = torch.round(base[:300] * 4) / 4 if grid else base[:300]
            for n_valid in (T, 551):
                k = median.median_filter(x, w, n_valid=n_valid)
                if not torch.equal(k, median.median_filter_plain(x, w, n_valid=n_valid)):
                    raise AssertionError(f"median_filter differs (width={w}, grid={grid})")
    x = base
    ms = kernel_ms(lambda: median.median_filter(x, W, T), median.median_filter, KMEDIAN)
    # the one PyTorch call that computes the same values, on the input
    # reflected beforehand (outside the timed call)
    padded = torch.nn.functional.pad(x, (W // 2, W // 2), mode="reflect")
    lib = padded.unfold(-1, W, 1).median(-1).values
    if not torch.equal(lib, median.median_filter(x, W, T)):
        raise AssertionError("unfold(...).median(-1) does not compute the filter")
    nbytes = 2 * 4 * R * T  # x read once, the result written once
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=device_ms(lambda: median.median_filter_plain(x, W, T))[0],
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        library_ms=device_ms(lambda: padded.unfold(-1, W, 1).median(-1))[0],
        call_ms=call_ms(lambda: median.median_filter(x, W, T)),
        plain_call_ms=call_ms(lambda: median.median_filter_plain(x, W, T)), bytes=nbytes,
    )  # fmt: skip


# ---- phase 3: float32 products of bf16 operands ----------------------------


def f32_products():
    """The logits (hidden @ tok_emb.T at turbo width) and a step's attention
    scores (beam 5, 20 heads, 1500 keys) from bf16 operands: within 1e-4 of
    the float64 product of the same bf16 values, where a bf16 rounding of
    values of magnitude ~1 is off by up to 4e-3."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    d, out = MODEL_DIMS["turbo"].n_text_state, {}
    shapes = {
        "logits": ((1, d), (d, V), 1.0, 0.03),
        "scores": ((5, 20, 1, 64), (5, 20, 64, 1500), 0.35, 0.35),
    }
    for name, (sa, sb, ka, kb) in shapes.items():
        a = (torch.randn(sa, generator=gen, device=DEV) * ka).bfloat16()
        b = (torch.randn(sb, generator=gen, device=DEV) * kb).bfloat16()
        if name == "logits":
            got = graphs.matmul_f32(a, b.t().contiguous().t())  # tok_emb.T's layout
        else:
            got = graphs.matmul_f32(a, b)
        want = a.double() @ b.double()
        err = (got.double() - want).abs().max().item()
        rounded = (got != got.bfloat16().float()).float().mean().item()
        if got.dtype != torch.float32 or not err < 1e-4 or not rounded > 0.99:
            raise AssertionError(f"{name}: dtype {got.dtype}, error {err}, unrounded {rounded}")
        out[name] = dict(max_abs_err=err, magnitude=want.abs().max().item())
    return out


# ---- phase 4: card vs CPU at tiny dims --------------------------------------


def tiny_params(dims, seed):
    """Seeded float32 weights, the (L, in, out) projections rescaled to
    0.5 / sqrt(in) so that activations stay O(1) and the logits spread
    widely: at the default 0.02 a 128-wide model's logits bunch within
    ~0.2 and the tokens would hang on near-ties."""
    params = init_random_params(dims, seed, torch.float32, "cpu")
    for part in ("encoder", "decoder"):
        for w in params[part]["blocks"].values():
            if w.dim() == 3:
                w.mul_(0.5 / np.sqrt(w.shape[1]) / 0.02)
    return params


def card_vs_cpu():
    dims = ModelDimensions(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    params = tiny_params(dims, seed=11)
    gpu = Whisper(dims, params, device="cuda", compute_dtype=torch.float32)
    cpu = Whisper(dims, params, device="cpu", compute_dtype=torch.float32)
    mel = (np.random.RandomState(5).randn(80, 3000) * 0.6).astype(np.float32)
    out = {}
    for name, kw in [("greedy", {}), ("beam5", dict(beam_size=5))]:
        opts = DecodingOptions(language="en", sample_len=40, **kw)
        g, c = decode(gpu, mel, opts), decode(cpu, mel, opts)
        if g.tokens != c.tokens:
            raise AssertionError(f"{name}: card tokens {g.tokens} != CPU tokens {c.tokens}")
        d = abs(g.avg_logprob - c.avg_logprob)
        if not d < 1e-3:
            raise AssertionError(f"{name}: avg_logprob differs by {d}")
        out[name] = dict(tokens=len(g.tokens), avg_logprob_diff=d)
    # word timestamps: the same words at the same times on both
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    kw = dict(language="en", temperature=0.0, verbose=None, word_timestamps=True)
    gw, cw = words_of(gpu.transcribe(jfk, **kw)), words_of(cpu.transcribe(jfk, **kw))
    if not cw:
        raise AssertionError("the CPU run of jfk gave no words")
    out["words"] = dict(words=len(gw), max_time_diff_s=same_words(gw, cw, "jfk"))
    # the silence pass on jfk, 8 s of silence, jfk twice: the same windows
    # (seek, tokens and words as aligned, before any cull) and the same
    # final segments on both
    audio = np.concatenate([jfk, np.zeros(8 * 16000, np.float32), np.tile(jfk, 2)])
    kw = dict(kw, hallucination_silence_threshold=2.0)
    runs = []
    for model in (gpu, cpu):
        with watch_replays() as replays:
            result = model.transcribe(audio, **kw)
        runs.append((result["segments"], replays))
    (gsegs, greps), (csegs, creps) = runs
    if [r["aligned"] for r in greps] != [r["aligned"] for r in creps] or not any(
        r["aligned"] for r in creps
    ):
        raise AssertionError(f"silence pass: {len(greps)} vs {len(creps)} replays, or none aligned")
    d = 0.0
    for i, (g, c) in enumerate(zip(greps + [dict(segments=gsegs)], creps + [dict(segments=csegs)])):
        if [(s["seek"], s["tokens"]) for s in g["segments"]] != [
            (s["seek"], s["tokens"]) for s in c["segments"]
        ]:
            raise AssertionError(f"silence pass: segments differ at window {i}")
        for a, b in zip(g["segments"], c["segments"]):
            d = max(d, abs(a["start"] - b["start"]), abs(a["end"] - b["end"]))
        d = max(d, same_words(words_of(g), words_of(c), f"silence pass window {i}"))
    if not d < 1e-6:
        raise AssertionError(f"silence pass: segment times differ by {d} s")
    out["silence_pass"] = dict(
        windows_aligned=sum(r["aligned"] for r in creps), segments_kept=len(csegs),
        words_aligned=sum(len(words_of(r)) for r in creps), max_time_diff_s=d,
    )  # fmt: skip
    return out


def words_of(result):
    return [w for s in result["segments"] for w in s.get("words", [])]


def same_words(gw, cw, what) -> float:
    """Equal words, times within 1e-6 s; returns the largest time difference."""
    if [w["word"] for w in gw] != [w["word"] for w in cw]:
        raise AssertionError(f"{what}: words differ: card {gw} CPU {cw}")
    d = max(
        (max(abs(a["start"] - b["start"]), abs(a["end"] - b["end"])) for a, b in zip(gw, cw)),
        default=0.0,
    )
    if not d < 1e-6:
        raise AssertionError(f"{what}: word times differ by {d} s")
    return d


# ---- phase 5: the main path at turbo width ----------------------------------


@contextlib.contextmanager
def watch_replays():
    """Within the block, log each word-timestamp replay of transcribe() (one
    add_word_timestamps call per window): its segments and words as aligned
    (copied before the silence pass may cull them), whether it had text
    tokens to align (then it launches median_filter and dtw_trace once), and
    its host-clock seconds. No synchronize is added: the replay ends in its
    own blocking read of the DTW trace. The function is restored on exit."""
    tmod = importlib.import_module("whisper_tpu_torch.transcribe")
    add_words = tmod.add_word_timestamps
    replays = []

    def watched(**kw):
        t0 = time.perf_counter()
        add_words(**kw)
        seconds = time.perf_counter() - t0
        eot = kw["tokenizer"].eot
        replays.append(dict(
            seconds=seconds,
            aligned=any(t < eot for s in kw["segments"] for t in s["tokens"]),
            segments=copy.deepcopy(kw["segments"]),
        ))  # fmt: skip

    tmod.add_word_timestamps = watched
    try:
        yield replays
    finally:
        tmod.add_word_timestamps = add_words


def reset_launch_counts():
    bk.reset_launch_counts()
    dtw.dtw_trace.launches = 0
    median.median_filter.launches = 0


def launch_counts():
    return {
        "greedy_argmax": bk.greedy_argmax.launches, "beam_update": bk.beam_update.launches,
        "dtw_trace": dtw.dtw_trace.launches, "median_filter": median.median_filter.launches,
    }  # fmt: skip


def check_words(segs, audio_s):
    """Every word's times are finite and ordered, starts do not decrease
    within a segment, and each word lies in its window [t0, t0 + 30 s]; the
    clamp heuristics may move an edge word's start back by up to the 1.4 s
    cap and its end on by up to the 0.7 s typical span."""
    n = 0
    for s in segs:
        t0 = s["seek"] / 100
        starts = [w["start"] for w in s["words"]]
        if starts != sorted(starts):
            raise AssertionError(f"word starts decrease in segment {s['id']}")
        for w in s["words"]:
            if not (np.isfinite([w["start"], w["end"], w["probability"]]).all()
                    and t0 - 1.4 - 1e-6 <= w["start"] <= w["end"] <= t0 + 30.7 + 1e-6
                    and w["end"] <= audio_s + 30.7):  # fmt: skip
                raise AssertionError(f"word {w} out of its window at {t0} s")
            n += 1
    return n


def main_path(model, audio, **kw):
    if model._fused_engine is not None:
        model._fused_engine.history.clear()
    reset_launch_counts()
    torch.cuda.synchronize()
    with watch_replays() as replays:
        t0 = time.perf_counter()
        result = model.transcribe(audio, language="en", verbose=None, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    runs = list(model._fused_engine.history)
    t0_greedy = sum(r[2] for r in runs if not r[0] and r[1] == 0.0)
    t0_beam = sum(r[2] for r in runs if r[0] and r[1] == 0.0)
    aligned = sum(r["aligned"] for r in replays)
    replay_s = sum(r["seconds"] for r in replays)
    want = {"greedy_argmax": t0_greedy, "beam_update": t0_beam, "dtw_trace": aligned,
            "median_filter": aligned}  # fmt: skip
    if launches != want:
        raise AssertionError(f"launches {launches} != T=0 updates and aligned windows {want}")
    segs = result["segments"]
    values = [v for s in segs for v in (s["start"], s["end"], s["avg_logprob"])]
    if not np.isfinite(values).all() or (not segs and "hallucination_silence_threshold" not in kw):
        raise AssertionError("transcribe() returned no or non-finite segments")
    if segs and segs[-1]["end"] > len(audio) / 16000 + 30:
        raise AssertionError("segments end past the clip")
    steps = sum(r[2] for r in runs)
    decode_s = sum(r[3] for r in runs)
    stats = dict(
        wall_s=wall,
        rtfx=len(audio) / 16000 / wall,
        windows_decoded=len(runs),
        decode_steps=steps,
        decode_s=decode_s,
        ms_per_token=decode_s / steps * 1e3,
        segments=len(segs),
        temperatures=sorted({r[1] for r in runs}),
    )
    if kw.get("word_timestamps"):
        if aligned == 0:
            raise AssertionError("the word-timestamp run aligned no window")
        stats.update(
            windows_aligned=aligned, words=check_words(segs, len(audio) / 16000),
            replay_s=replay_s, replay_share=replay_s / wall,
        )  # fmt: skip
    return stats, launches


def replay_cross_kv(model):
    """The cross-K/V that each aligned window's replay computes from the
    window's audio features (1, 1500, d): device ms (profiler) and ms per
    call (CUDA events) at the model's width."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    xa = torch.randn((1, 1500, model.dims.n_audio_state), generator=gen, device=DEV)
    xa = xa.to(model.compute_dtype)
    return dict(
        device_ms=device_ms(lambda: model.cross_kv(xa))[0],
        call_ms=call_ms(lambda: model.cross_kv(xa)),
    )


# ---- phase 6: where a decode window's time goes --------------------------


def decode_loop_profile(model, audio, beam_size=None):
    """One window of decode() at the model's width, greedy or beam search:
    the engine's wall ms per step (host clock, unprofiled runs) and, from a
    profiled run, between the first and the last update launch, the
    device-busy ms per step (the union of the kernels' intervals), the
    kernels per step, the update kernel's device ms per step, and the
    host's ms per step blocked in device-to-host reads
    (`aten::_local_scalar_dense`, the read of the `completed` flag)."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    mel, _ = device_mel_full(audio, model.dims.n_mels, DEV)
    window = device_mel_window(mel, 0, 3000)
    opts = DecodingOptions(language="en", temperature=0.0, beam_size=beam_size)
    update = "beam_update_kernel" if beam_size else "greedy_argmax_kernel"
    engine_runs = model._fused_engine.history
    walls = []
    for _ in range(3):
        decode(model, window, opts)
        _, _, steps, seconds = engine_runs[-1]
        walls.append(seconds / steps * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(model, window, opts)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    reads = [
        e.time_range for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU and e.name == "aten::_local_scalar_dense"
    ]  # fmt: skip
    updates = [sp for sp in spans if update in sp[2]]
    if len(updates) < 2:
        raise AssertionError("the profiled window ran fewer than two updates")
    lo, hi = updates[0][0], updates[-1][1]
    busy, end, n_kernels = 0.0, lo, 0
    for start, stop, _ in spans:
        if stop <= lo or start >= hi:
            continue
        n_kernels += 1
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            busy += stop - start
            end = stop
    n = len(updates) - 1  # steps between the first and the last update
    reads = [r for r in reads if lo <= r.start < hi]
    wall = statistics.median(walls)
    busy_ms = busy / n / 1e3
    return dict(
        mode=f"beam{beam_size}" if beam_size else "greedy",
        steps=steps,
        wall_ms_per_step=wall,
        wall_ms_per_step_runs=walls,
        profiled_ms_per_step=(hi - lo) / n / 1e3,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / wall,
        kernels_per_step=n_kernels / n,
        update_ms_per_step=sum(b - a for a, b, _ in updates) / len(updates) / 1e3,
        host_reads_per_step=len(reads) / n,
        host_read_ms_per_step=sum(r.elapsed_us() for r in reads) / n / 1e3,
    )


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {gpu_name}")
    card = card_line()

    t = time.perf_counter()
    start_empty_build()
    build.load_library()
    empty_lib()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t}))
    log("\n".join(line for line in build.build_log.splitlines() if "Used" in line))

    kernels = {
        "greedy_argmax": check_greedy(), "beam_update": check_beam(), "dtw_trace": check_dtw(),
        "median_filter": check_median(),
    }  # fmt: skip
    log(json.dumps({"phase": "odd_vocab", "max_abs_err": check_odd_vocab()}))
    log(json.dumps({"phase": "f32_products", **f32_products()}))
    for name, r in kernels.items():
        log(json.dumps({"phase": "kernel", "name": name, **r, "card": card}))
    log(json.dumps({"phase": "yardstick", "library_ms": None,
                    "note": "no single PyTorch call computes the filtered update or the "
                            "DTW trace"}))  # fmt: skip

    log(json.dumps({"phase": "card_vs_cpu", **card_vs_cpu()}))

    dims = MODEL_DIMS["turbo"]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Whisper(dims, None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "init_turbo", "seconds": time.perf_counter() - t}))
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    audio = np.tile(jfk, 6)[: 60 * 16000]
    model.transcribe(audio[: 16000 * 5], language="en", temperature=0.0, verbose=None)  # warm-up

    launches = {}
    np.random.seed(0)  # the sampling seeds of the temperature ladder
    words = dict(word_timestamps=True, temperature=0.0)
    silence = dict(words, hallucination_silence_threshold=2.0)
    for name, clip, kw in [
        ("greedy_ladder", audio, {}),
        ("beam5_t0", audio, dict(beam_size=5, temperature=0.0)),
        ("words_greedy_t0", audio, words),
        ("words_silence_skip", audio[: 20 * 16000], silence),
    ]:  # fmt: skip
        stats, counts = main_path(model, clip, **kw)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        log(json.dumps({"phase": "main_path", "run": name, **stats, "launches": counts,
                        "card": card}))  # fmt: skip
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    log(json.dumps({"phase": "memory", "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    log(json.dumps({"phase": "replay_cross_kv", **replay_cross_kv(model), "card": card}))
    for beam_size in (None, 5):
        profile = decode_loop_profile(model, audio, beam_size)
        log(json.dumps({"phase": "loop_profile", **profile, "card": card}))

    source = {
        "greedy_argmax": ("greedy_argmax.cu", "whisper_tpu/ops/beam_kernel.py:627"),
        "beam_update": ("beam_update.cu", "whisper_tpu/ops/beam_kernel.py:449"),
        "dtw_trace": ("dtw.cu", "whisper_tpu/ops/pallas_kernels.py:138"),
        "median_filter": ("median_filter.cu", "whisper_tpu/ops/pallas_kernels.py:210"),
    }  # fmt: skip
    line = {
        "kernels": [
            {
                "name": name, "route": "cuda", "source": "whisper_tpu_torch/csrc/" + source[name][0],
                "replaces": source[name][1], "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r.get("library_ms"),
                **{k: r[k] for k in ("cluster", "call_ms") if k in r},
            }  # fmt: skip
            for name, r in kernels.items()
        ]
    }
    print(json.dumps(line))
    print(card)
    device = {"platform": "gpu", "kind": gpu_name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
