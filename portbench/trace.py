"""Reading a torch.profiler session: the device's busy and idle time, the
decode steps' device time, the longest device operations by kind, and the
device's idle gaps named by what the host was doing.

Kernel categories: by kernel name, the table of the program's op trace tool
(`whisper_tpu_torch/trace_ops.py`), copied so that the yardstick does not
move with the program.
"""

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

CATEGORIES = (
    ("repo kernels (csrc)", r"wtt_|greedy_argmax_kernel|beam_update_kernel|dtw_trace_kernel|median_filter_kernel"),
    ("gemm", r"gemm|cutlass|cublas|nvjet|xmma"),
    ("attention and softmax", r"softmax|attention|fmha|flash"),
    ("copy and memset", r"memcpy|memset|copy|fill"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise"),
)  # fmt: skip
UPDATE_KERNELS = re.compile(r"greedy_argmax|beam_update", re.IGNORECASE)
SLICE = "portbench::slice"
ENGINE_RUN = "portbench::engine_run"
TOP = 10


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return cat
    return "other"


@dataclass
class Timeline:
    """A profile's device operations and host ranges, in microseconds on
    the profiler's common clock."""

    kernels: List[Tuple[float, float, str]] = field(default_factory=list)  # sorted by start
    host: List[Tuple[float, float, str]] = field(default_factory=list)  # CPU ops and runtime calls
    marks: dict = field(default_factory=dict)  # record_function name -> [(start, end)]


def timeline(prof) -> Timeline:
    """The profile's device kernels, copies and memsets (CUDA events), its
    host ranges and the benchmark's own record_function ranges."""
    import torch

    tl = Timeline()
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench::"):
            # a record_function range: its host side is the mark; its
            # device-side annotation is no operation
            if e.device_type != torch.autograd.DeviceType.CUDA:
                tl.marks.setdefault(e.name, []).append((start, end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            tl.kernels.append((start, end, e.name))
        else:
            tl.host.append((start, end, e.name))
    tl.kernels.sort()
    return tl


def busy_us(kernels, lo: float, hi: float) -> float:
    """The union of the kernels' intervals clipped to [lo, hi]."""
    busy, reach = 0.0, lo
    for start, end, _ in kernels:
        if end <= reach or start >= hi:
            continue
        start, end = max(start, reach), min(end, hi)
        if end > start:
            busy += end - start
            reach = end
    return busy


def slice_window(tl: Timeline) -> Tuple[float, float]:
    """The profiled slice's range: the benchmark's SLICE mark."""
    spans = tl.marks.get(SLICE)
    if not spans:
        raise RuntimeError("the profile holds no slice mark")
    return spans[0]


def idle_gaps(tl: Timeline, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] where no device operation ran."""
    gaps, reach = [], lo
    for start, end, _ in tl.kernels:
        if end <= lo or start >= hi:
            continue
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def breakdown(tl: Timeline, lo: float, hi: float) -> dict:
    """The slice's ten device operations that took most time, and its idle
    time by what the host was doing at each gap's midpoint (the ten largest
    sums), in seconds."""
    ops = defaultdict(float)
    for start, end, name in tl.kernels:
        if start >= lo and end <= hi:
            ops[f"{category(name)}: {name[:120]}"] += (end - start) / 1e6
    gaps = defaultdict(float)
    host = sorted(tl.host)
    starts = [h[0] for h in host]
    for a, b in idle_gaps(tl, lo, hi):
        gaps[_host_label(host, starts, (a + b) / 2)] += (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _host_label(host, starts, t: float) -> str:
    """The innermost host range covering time t: the latest-starting one of
    the (at most 256) ranges that start before it; host ranges nest on a
    thread, so that is the innermost."""
    i = bisect.bisect_right(starts, t)
    for start, end, name in reversed(host[max(0, i - 256) : i]):
        if t < end:
            return name[:120]
    return "host idle or in Python"


def decode_steps(tl: Timeline) -> Tuple[float, float, int]:
    """The decode loops' device time: in each ENGINE_RUN range, from the
    start of its first update kernel (step 0's, after the prefill) to the
    end of its last, the wall and the union of the kernels, in
    microseconds, summed over the runs, and the steps (the updates less
    one a run)."""
    wall = busy = 0.0
    steps = 0
    updates = [k for k in tl.kernels if UPDATE_KERNELS.search(k[2])]
    for lo_h, hi_h in tl.marks.get(ENGINE_RUN, []):
        mine = [k for k in updates if lo_h <= k[0] <= hi_h]
        if len(mine) < 2:
            continue
        wall += mine[-1][1] - mine[0][0]
        busy += busy_us(tl.kernels, mine[0][0], mine[-1][1])
        steps += len(mine) - 1
    return wall, busy, steps
