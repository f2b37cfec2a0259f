"""One run of one cell: set-up, the measured window, with --trace 1 the
traced parts, the comparison, and the result line.

  set-up   the weights made on the device from the seed, the program's model
           built on them (`Whisper(params=...)`), the traffic's inputs, and
           one warm call of the traffic (every shape the window uses, the
           decode loop's captures); setup_s runs from process start to here
  window   the traffic for --seconds; its end-to-end metrics
  traced   (--trace 1) after the window: the engine runs, the batcher's
           counters and the submit times of the window; a profiled slice of
           the same traffic (torch.profiler: the device's busy and idle
           time, the decode steps' device time, the breakdown); the same
           slice again with the program's spans synchronised, for the
           encoder's time a window; then each per-layer metric's reader
  check    with the program's state freed: the served windows against the
           float32 reference (check.py)
"""

import gc
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import check, inputs, spec, trace
from portbench.work import clock, sync


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )  # fmt: skip
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _engine(ctx):
    from whisper_tpu_torch.engine import model_engine

    return model_engine(ctx.model, ctx.model.decode_weights)


def _traced(ctx) -> dict:
    """The traced parts after the window; returns what the readers read."""
    from whisper_tpu_torch import profiling

    engine = _engine(ctx)
    run = engine.run

    def marked(*args, **kwargs):
        with torch.profiler.record_function(trace.ENGINE_RUN):
            return run(*args, **kwargs)

    engine.run = marked
    engine.history.clear()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(trace.SLICE):
                ctx.kind.profiled(ctx)
    finally:
        del engine.run
    t0 = clock()
    tl = trace.timeline(prof)
    lo, hi = trace.slice_window(tl)
    out = {"timeline": tl, "slice": (lo, hi), "slice_runs": list(engine.history), "parse_s": clock() - t0}

    # the encoder span, with the program's spans waiting for the card
    engine.history.clear()
    profiling.reset()
    profiling.set_sync(True)
    try:
        ctx.kind.profiled(ctx)
    finally:
        profiling.set_sync(False)
    span = profiling.summary().get("encoder")
    windows = sum(r.program[0] for r in engine.history if r.program)
    if span and windows:
        out["encoder_s"] = span["first_call_s"] + span["steady_total_s"]
        out["encoder_windows"] = windows
    return out


def setup(cell_name: str, seed: int, seconds: float, device, data: str = spec.HERE):
    """The run's context after set-up (weights, model, inputs, warm call)."""
    from whisper_tpu_torch.models.whisper import Whisper

    cell = spec.cell(cell_name, data)
    ctx = SimpleNamespace(
        cell=cell, name=cell_name, config=cell.config, mix=cell.mix, seed=seed, seconds=seconds,
        device=torch.device(device), kind=cell.kind,
    )  # fmt: skip
    ctx.dims = inputs.dims_of(ctx.config)
    ctx.decode_kwargs = inputs.decode_kwargs(ctx.config, ctx.mix)
    # bf16 on the card, as served; the CPU (the tests) runs float32
    dtype = torch.bfloat16 if ctx.device.type == "cuda" else torch.float32
    ctx.params = inputs.make_params(ctx.config, seed, ctx.device, dtype)
    ctx.model = Whisper(ctx.dims, params=ctx.params, name=cell.workload["config"], compute_dtype=dtype, device=ctx.device)
    ctx.kind.prepare(ctx)
    ctx.kind.warm(ctx)
    sync(ctx.device)
    return ctx


def measure(ctx, trace_on: bool) -> dict:
    """The window, and with trace_on the traced parts and per-layer
    metrics. Returns the run's record (metrics not yet filtered)."""
    engine = _engine(ctx)
    engine.history.clear()
    window = ctx.kind.window(ctx, ctx.seconds)
    window["runs"] = list(engine.history)
    ctx.times = window["times"]
    rec = {"window": window}
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(ctx.device))
    if trace_on:
        rec["traced"] = _traced(ctx)
    return rec


def per_layer(ctx, rec: dict, bench: dict) -> dict:
    reader_ctx = SimpleNamespace(
        config=ctx.config, mix=ctx.mix, window=rec["window"], traced=rec.get("traced", {}),
        n_initial=len(inputs.initial_tokens(ctx.config)),
    )  # fmt: skip
    out = {}
    for m in spec.per_layer_for(bench, ctx.name):
        value = spec.metric(m["name"]).read(reader_ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def free_program(ctx):
    """Drop the program's state (model, engines and their graphs, the
    traffic's batchers); the weights the reference reads stay."""
    ctx.model = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def device_record(ctx, rec: dict) -> dict:
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type, "count": 1}
    if ctx.device.type == "cuda":
        dev["kind"] = torch.cuda.get_device_name(ctx.device)
        dev["memory_peak_bytes"] = rec["memory_peak_bytes"]
        dev["power_limit"] = card_power_limit()
    else:
        dev["kind"] = "cpu"
        dev["memory_peak_bytes"] = 0
    traced = rec.get("traced")
    if traced:
        lo, hi = traced["slice"]
        dev["busy_s"] = trace.busy_us(traced["timeline"].kernels, lo, hi) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
    return dev


def run(cell_name, seed, seconds, trace_on, *, t_start, device="cuda", data=spec.HERE, bench=None, log=sys.stderr):
    """One run; returns (result line dict, the comparison's numbers)."""
    ctx = setup(cell_name, seed, seconds, device, data=data)
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"phase": "setup", "seconds": setup_s}), file=log, flush=True)
    rec = measure(ctx, trace_on)
    w = rec["window"]
    bench = bench or spec.benchmark()
    if trace_on:
        metrics = per_layer(ctx, rec, bench)
    else:
        names = {m["name"] for m in spec.end_to_end_for(bench, cell_name)}
        metrics = {k: v for k, v in w["metrics"].items() if k in names}
        metrics = {k: {"value": float(v), "unit": _unit(bench, k)} for k, v in metrics.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = device_record(ctx, rec)
    work = {k: w[k] for k in ("elapsed", "calls", "windows", "attempted", "failed") if k in w}
    work["tokens"] = sum(len(s.tokens) for s in w["served"])
    work["engine_runs"] = len(w["runs"])
    work["engine_steps"] = sum(r.steps for r in w["runs"])
    if "late_s" in w:
        work["generator_late_max_s"] = max(w["late_s"], default=0.0)
    if trace_on:
        work["trace_parse_s"] = rec["traced"]["parse_s"]
    print(json.dumps({"phase": "work", **work}, default=float), file=log, flush=True)

    free_program(ctx)
    numbers = check.compare(ctx, w["served"], np.random.default_rng([seed, 1]))
    ok, rows = check.verdict(numbers, ctx.cell.workload["limits"])
    ok = ok and w["failed"] == 0
    result = {"correct": bool(ok), "attempted": int(w["attempted"]), "failed": int(w["failed"]), "metrics": metrics, "device": dev}
    if trace_on:
        lo, hi = rec["traced"]["slice"]
        result["breakdown"] = trace.breakdown(rec["traced"]["timeline"], lo, hi)
    result["check"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(json.dumps({"phase": "check", **numbers}, default=float), file=log, flush=True)
    return result, numbers


def _unit(bench: dict, name: str) -> str:
    return next(m["unit"] for m in bench["end_to_end"] if m["name"] == name)
