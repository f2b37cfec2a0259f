"""The decode loop on the device, in the traced slice: from each engine
run's first update kernel to its last, over its steps."""

from portbench import readers

UNIT = "ms/step"
LAYER = "decode engine"
MOVES = "latency_p95_s"
WORKLOADS = ["turbo.serve8.greedy"]


def read(ctx):
    return readers.decode_ms_per_step(ctx)
