"""Captures of a decode-loop graph the engine had made before and dropped
past its program limit, summed over the window's engine runs."""

UNIT = "count"
LAYER = "decode engine"
MOVES = "latency_p95_s"
WORKLOADS = ["turbo.serve8.greedy"]


def read(ctx):
    runs = ctx.window["runs"]
    return sum(r.recaptures for r in runs) if runs else None
