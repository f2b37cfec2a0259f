"""Per-graph wall-clock accounting and torch.profiler traces (the
counterpart of whisper_tpu/profiling.py, with the same names).

  * `timed(name)` / `record(name, seconds)` accumulate host wall clock per
    graph. The spans sit where the JAX package's sit: "encoder" (encode, and
    encode_with_cross_kv as one span), "cross_kv", "prefill", "decode_step"
    (models/whisper.py), "fused_decode" around a whole engine run
    (engine.py) and "fused_decode_spec" around a speculative run
    (speculative.py);
  * the first call of each name is kept apart as `first_call_s`: on the card
    it holds the warm-up of first use (kernel builds and loads, cuBLAS
    handles, caching-allocator growth), as the JAX package's holds the
    compile;
  * `report()` renders the summary, `print_report()` prints it (the CLI does
    after each file), `reset()` clears it;
  * `trace(log_dir)` wraps a block in torch.profiler.

CUDA runs asynchronously, so a span measures dispatch unless the graph's
result is waited for: `set_sync(True)` makes `maybe_block` synchronize the
card at the end of each span (the CLI's --profile_sync). It is off by
default, and then the decode loop pays no wait per token. The engine spans
end in a copy to the host, so they hold device time either way.

A lock guards the module state: the serve thread and the HTTP readers
share it.
"""

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_first_call_time: Dict[str, float] = {}

enabled = True

# When True, maybe_block synchronizes the card so that each span covers the
# graph's device time as well as its dispatch; set through set_sync
sync_for_timing = False


def set_sync(on: bool):
    """Whether the spans wait for the card (maybe_block)."""
    global sync_for_timing
    sync_for_timing = bool(on)


def maybe_block(x):
    """Wait for the card when sync is on and `x` (or the first element of a
    tuple or list) is a CUDA tensor; returns `x`."""
    if sync_for_timing:
        t = x[0] if isinstance(x, (tuple, list)) and x else x
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
    return x


def record(name: str, seconds: float):
    if not enabled:
        return
    with _lock:
        if name not in _first_call_time:
            _first_call_time[name] = seconds
        else:
            _totals[name] += seconds
            _counts[name] += 1


@contextmanager
def timed(name: str):
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def reset():
    with _lock:
        _totals.clear()
        _counts.clear()
        _first_call_time.clear()


def summary() -> Dict[str, Dict[str, float]]:
    with _lock:
        names = set(_totals) | set(_first_call_time)
        return {
            name: {
                "first_call_s": _first_call_time.get(name, 0.0),
                "steady_total_s": _totals.get(name, 0.0),
                "steady_calls": _counts.get(name, 0),
                "steady_mean_ms": (
                    1000.0 * _totals[name] / _counts[name] if _counts.get(name) else 0.0
                ),
            }
            for name in sorted(names)
        }


def report() -> str:
    lines = [f"{'graph':<18} {'first(s)':>9} {'calls':>6} {'total(s)':>9} {'mean(ms)':>9}"]
    for name, s in summary().items():
        lines.append(
            f"{name:<18} {s['first_call_s']:>9.3f} {s['steady_calls']:>6d} "
            f"{s['steady_total_s']:>9.3f} {s['steady_mean_ms']:>9.2f}"
        )
    return "\n".join(lines)


REPORT_HEADER = "--- whisper_tpu_torch graph timing (first call includes warm-up) ---"


def print_report():
    print(REPORT_HEADER)
    print(report())


@contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU activities, and CUDA
    when a card is present) as a Chrome trace file, trace.json, in
    `log_dir`. A profiler session slows later host dispatch in the same
    process, so time loops in a process that has not traced."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
