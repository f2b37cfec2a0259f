"""The arithmetic the per-layer metrics share, over what a run recorded:
the window's engine runs and work, and the traced slice. Each returns None
when its source recorded nothing (no run, no device kernel), and the
harness then leaves the metric out."""

import numpy as np

from portbench import roofline, trace


def _has_kernels(ctx) -> bool:
    return bool(ctx.traced and ctx.traced["timeline"].kernels)


def decode_ms_per_step(ctx):
    """The decode loops of the traced slice on the device: from each run's
    first update kernel to its last, over its steps. (An engine run's host
    wall would also hold the encoder's work still queued when it starts.)"""
    if not _has_kernels(ctx):
        return None
    wall_us, _, steps = trace.decode_steps(ctx.traced["timeline"])
    return wall_us / 1000.0 / steps if steps else None


def device_idle_pct(ctx):
    """Share of the traced slice's wall with no device operation running."""
    if not _has_kernels(ctx):
        return None
    lo, hi = ctx.traced["slice"]
    return 100.0 * (1.0 - trace.busy_us(ctx.traced["timeline"].kernels, lo, hi) / (hi - lo))


def mfu_pct(ctx):
    """The model FLOPs of every window the window completed (roofline.py)
    over its seconds at the bf16 peak."""
    w = ctx.window
    if not w["windows"]:
        return None
    rows = ctx.mix.get("beam_size") or 1
    flops = w["windows"] * roofline.window_flops(ctx.config, ctx.n_initial, ctx.mix["sample_len"], rows)
    return 100.0 * flops / (w["elapsed"] * roofline.BF16_PEAK_FLOPS)


def encoder_ms_per_window(ctx):
    """The program's "encoder" span (encoder and cross-K/V) with its spans
    synchronised, over the windows it encoded, in the traced run's own
    part."""
    if not ctx.traced.get("encoder_windows"):
        return None
    return 1000.0 * ctx.traced["encoder_s"] / ctx.traced["encoder_windows"]


def decode_step_roofline(ctx):
    """The decode step's share of its roofline: the least time its math
    needs, the larger of its FLOPs at the bf16 peak and its bytes at HBM's
    (roofline.py, at each run's audios and group, step by step), over the
    steps' device-busy time in the traced slice."""
    if not _has_kernels(ctx):
        return None
    _, busy_us, steps = trace.decode_steps(ctx.traced["timeline"])
    runs = [r for r in ctx.traced["slice_runs"] if r.program]
    if not steps or not runs:
        return None
    cfg, n, L = ctx.config, ctx.n_initial, ctx.mix["sample_len"]

    def least_s(audios, group, position):
        flops = audios * group * roofline.decoder_token_flops(cfg, position)
        return max(flops / roofline.BF16_PEAK_FLOPS, roofline.step_bytes(cfg, audios, group, position) / roofline.HBM_BYTES_PER_S)

    per_step = np.mean([least_s(r.program[0], r.program[1], n + i - 1) for r in runs for i in range(1, L)])
    return 100.0 * steps * per_step / (busy_us / 1e6)
