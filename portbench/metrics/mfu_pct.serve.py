"""The model FLOPs of all the work the window completed (roofline.py) over
the window's seconds at the bf16 peak of one H100."""

from portbench import readers

UNIT = "%"
LAYER = "whole step"
MOVES = "latency_p95_s"
WORKLOADS = ["turbo.serve8.greedy"]


def read(ctx):
    return readers.mfu_pct(ctx)
