"""Reading a torch.profiler trace of decode steps, shared by chip_smoke.py
and smoke/host_ms.py so that both report the same device-busy numbers."""

import torch


def busy_between_updates(prof, update):
    """From a profile of one decode window: the union of the CUDA kernels'
    intervals between the start of the first launch of the update kernel
    (names containing `update`, in lower case) and the end of the last, the
    kernels that ran there, the steps between them, the update's mean
    device time and that interval (lo, hi), in us."""
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    updates = [sp for sp in spans if update in sp[2].lower()]
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
    return dict(busy_us=busy, kernels=n_kernels, steps=len(updates) - 1,
                update_us=sum(b - a for a, b, _ in updates) / len(updates), lo=lo, hi=hi)  # fmt: skip
