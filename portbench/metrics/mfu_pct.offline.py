"""The model FLOPs of all the work the window completed (roofline.py) over
the window's seconds at the bf16 peak of one H100."""

from portbench import readers

UNIT = "%"
LAYER = "whole step"
MOVES = "rtfx"
WORKLOADS = ["turbo.batch16.beam5"]


def read(ctx):
    return readers.mfu_pct(ctx)
