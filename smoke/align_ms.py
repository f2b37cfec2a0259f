"""Device and call time of the word-timing kernels of one checkout.

    python3 smoke/align_ms.py [ROOT]

Imports whisper_tpu_torch from ROOT (default: this checkout; give another
checkout, e.g. a `git archive` of the parent, to compare two versions of the
kernels on one card in one call) and builds its kernels if needed. Then, at
the main path's largest shapes:

  * `dtw_trace` on a 252 x 1500 randn cost matrix;
  * `median_filter` on 40 heads x 224 rows x 1500 frames, width 7, reflecting
    at 1500.

`ms` is the device time per launch: the mean of the profiler's records of
the kernel over 100 launches (as chip_smoke.py's kernel phase times it);
`call_ms` the median of CUDA events around one call (host work included),
over 100 calls. Each is taken `--rounds` times (default 3). Prints one JSON
line with the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys

import torch

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = os.path.abspath(ARGS[0] if ARGS else os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # fmt: skip
ROUNDS = int(next((a.split("=")[1] for a in sys.argv[1:] if a.startswith("--rounds=")), 3))
REPS = 100


def device_ms(fn, kernel):
    """Mean device ms of the profiler's records of `kernel` over REPS calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us = [
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
        ]  # fmt: skip
        if us:
            return statistics.fmean(us) / 1e3
    raise RuntimeError(f"the profiler recorded no {kernel}")


def call_ms(fn):
    for _ in range(5):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("align_ms: CUDA is not available; this script runs only on a card")
    sys.path.insert(0, ROOT)
    from whisper_tpu_torch.kernels import build
    from whisper_tpu_torch.ops import dtw, median

    if not os.path.dirname(os.path.abspath(build.__file__)).startswith(ROOT):
        raise RuntimeError(f"imported whisper_tpu_torch from {build.__file__}, not from {ROOT}")
    build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((252, 1500), generator=gen, device=dev)
    rows = torch.randn((40 * 224, 1500), generator=gen, device=dev)
    cases = {
        "dtw_trace": (lambda: dtw.dtw_trace(x), "dtw_trace_kernel"),
        "median_filter": (lambda: median.median_filter(rows, 7, 1500), "median_filter_kernel"),
    }
    out = {name: dict(ms=[], call_ms=[]) for name in cases}
    for _ in range(ROUNDS):
        for name, (fn, kernel) in cases.items():
            out[name]["ms"].append(device_ms(fn, kernel))
            out[name]["call_ms"].append(call_ms(fn))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(json.dumps({"root": ROOT, **out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
