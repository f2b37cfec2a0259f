"""Share of the traced slice's wall with no device operation running."""

from portbench import readers

UNIT = "%"
LAYER = "device"
MOVES = "latency_p95_s"
WORKLOADS = ["turbo.serve8.greedy"]


def read(ctx):
    return readers.device_idle_pct(ctx)
