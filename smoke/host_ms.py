"""Host time of the decode loop and of one update launch.

    python3 smoke/host_ms.py [ROOT]

Imports whisper_tpu_torch from ROOT (default: this checkout; give another
checkout to compare two versions of the port on one card) and builds its
kernels if needed. Then, on the host clock:

  * `loop_fresh`: the engine's wall ms per step of one 30 s window of
    decode() at turbo width (seeded random bf16 weights, tests/data/jfk.flac
    tiled), greedy (5 runs) and beam 5 (3 runs), at temperature 0, in a
    process that has not run the profiler: the loop the checkout's engine
    runs (a captured program where it has one, `loop` says which);
  * `loop_profile`: after those, one profiled run of the window's first 48
    steps each: device-busy ms per step (the union of the kernels'
    intervals between the first and the last update launch), kernels per
    step, and the idle share against loop_fresh's median wall;
  * `loop_after_profiler`: the same after one torch.profiler session of 100
    update launches, as chip_smoke.py's kernel phase takes before its
    loop profile;
  * `wrapper_ms`: one call of the update wrappers (`greedy_argmax`,
    `beam_update`) at the main path's shapes (greedy: B = 1; beam: A = 1,
    G = 5; V = 51866, T = 448, n_tokens = 60): checks, output allocations
    and the launch;
  * `launch_ms`: one call of the C entry point alone (`wtt_greedy_argmax`,
    `wtt_beam_update`) on preallocated outputs: the library's launch path
    (argument conversion, launch configuration, cudaLaunch*).

The call times are the median (and the mean) of 2,000 calls after 200
warm-up calls, unsynchronized; a synchronize every 50 calls, outside the
timed calls, keeps the launch queue short. Prints one JSON line with the
card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from trace_stats import busy_between_updates

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # fmt: skip
V, T, N_TOKENS, SAMPLE_BEGIN = 51866, 448, 60, 3
TS_BEGIN, EOT, NO_TS = 50365, 50257, 50364
CALLS, WARMUP, SYNC_EVERY = 2000, 200, 50


def host_ms(fn):
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(CALLS):
        t0 = time.perf_counter_ns()
        fn()
        times.append((time.perf_counter_ns() - t0) / 1e6)
        if i % SYNC_EVERY == SYNC_EVERY - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return dict(median=statistics.median(times), mean=statistics.fmean(times))


def loop_profile(model, window, beam_size, wall_ms):
    """Device-busy ms per step, kernels per step and idle share (against
    `wall_ms`) of one profiled 48-step run of the window, between the first
    and the last update launch (the short window runs once unprofiled
    first, so that a captured loop's graphs exist)."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import DecodingOptions, decode

    opts = DecodingOptions(language="en", temperature=0.0, beam_size=beam_size, sample_len=48)
    decode(model, window, opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(model, window, opts)
        torch.cuda.synchronize()
    span = busy_between_updates(prof, "beam_update_kernel" if beam_size else "greedy_argmax_kernel")
    n = span["steps"]
    busy_ms = span["busy_us"] / n / 1e3
    return dict(device_busy_ms_per_step=busy_ms, kernels_per_step=span["kernels"] / n,
                idle_share=1 - busy_ms / wall_ms)  # fmt: skip


def main():
    if not torch.cuda.is_available():
        sys.exit("host_ms: CUDA is not available")
    sys.path.insert(0, ROOT)
    from whisper_tpu_torch import DecodingOptions, decode, load_audio
    from whisper_tpu_torch.kernels import build
    from whisper_tpu_torch.models.dims import MODEL_DIMS
    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.ops import beam_kernel as bk
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    dev = torch.device("cuda")
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"root": ROOT}

    # the decode loop, before and after a profiler session
    model = Whisper(MODEL_DIMS["turbo"], None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    mel, _ = device_mel_full(np.tile(jfk, 6)[: 60 * 16000], model.dims.n_mels, dev)
    window = device_mel_window(mel, 0, 3000)

    def loop(beam_size, runs):
        opts = DecodingOptions(language="en", temperature=0.0, beam_size=beam_size)
        walls = []
        for _ in range(runs):
            decode(model, window, opts)
            run = model._fused_engine.history[-1]  # its first four fields in every version
            walls.append(run[3] / run[2] * 1e3)
        return walls

    loop(None, 1), loop(5, 1)  # warm-up
    fresh = dict(greedy=loop(None, 5), beam5=loop(5, 3))
    run = model._fused_engine.history[-1]
    fresh["loop"] = "captured" if getattr(run, "replays", 0) else "eager"
    out["loop_fresh"] = fresh
    out["loop_profile"] = {
        name: loop_profile(model, window, beam, statistics.median(fresh[name]))
        for name, beam in (("greedy", None), ("beam5", 5))
    }

    rng = np.random.RandomState(0)
    sup, beg = bk.build_penalty_vectors(
        V, [1, 2, 3, 11, 220], [220, EOT], use_timestamps=True, no_timestamps=NO_TS,
        timestamp_begin=TS_BEGIN, max_initial_ts_index=50,
    )  # fmt: skip
    sup, beg = torch.from_numpy(sup).to(dev), torch.from_numpy(beg).to(dev)
    kw = dict(use_timestamps=True, eot=EOT, timestamp_begin=TS_BEGIN)
    logits = torch.from_numpy(rng.randn(1, V).astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.randint(100, 5000, (1, T)).astype(np.int32)).to(dev)
    g_args = (logits, tokens, N_TOKENS, SAMPLE_BEGIN, sup, beg)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(100):
            bk.greedy_argmax(*g_args, **kw)
        torch.cuda.synchronize()
    out["loop_after_profiler"] = dict(greedy=loop(None, 5), beam5=loop(5, 3))

    # one update launch
    tok = torch.empty(1, dtype=torch.int32, device=dev)
    lp = torch.empty(1, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (logits, tokens, sup, beg, tok, lp)]
    out["greedy_argmax"] = dict(
        wrapper_ms=host_ms(lambda: bk.greedy_argmax(*g_args, **kw)),
        launch_ms=host_ms(lambda: lib.wtt_greedy_argmax(
            *ptrs, 1, V, T, N_TOKENS, SAMPLE_BEGIN, 1, EOT, TS_BEGIN, stream)),
    )  # fmt: skip

    G, MC = 5, 5
    logits = torch.from_numpy(rng.randn(G, V).astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.randint(100, 5000, (G, T)).astype(np.int32)).to(dev)
    sum_lp = torch.from_numpy(rng.randn(G).astype(np.float32)).to(dev)
    pool = [
        torch.zeros((1, MC, T + 1), dtype=torch.int32, device=dev),
        torch.full((1, MC), float("-inf"), device=dev),
        torch.zeros((1, MC), dtype=torch.int32, device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev),
    ]
    b_args = (logits, tokens, sum_lp, *pool, N_TOKENS, SAMPLE_BEGIN, 40, sup, beg)
    outs = (torch.empty_like(tokens), torch.empty(G, dtype=torch.int32, device=dev),
            torch.empty(G, dtype=torch.float32, device=dev))  # fmt: skip
    ptrs = [t.data_ptr() for t in (logits, tokens, sum_lp, *pool, sup, beg, *outs)]
    out["beam_update"] = dict(
        wrapper_ms=host_ms(lambda: bk.beam_update(*b_args, n_group=G, **kw)),
        launch_ms=host_ms(lambda: lib.wtt_beam_update(
            *ptrs, 1, G, V, T, MC, N_TOKENS, SAMPLE_BEGIN, 40, 1, EOT, TS_BEGIN, stream)),
    )  # fmt: skip
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(json.dumps({"phase": "host_ms", **out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
