"""The program's "encoder" span (encoder with cross-K/V), synchronised, over
the windows encoded, in the traced run's own part after the profile."""

from portbench import readers

UNIT = "ms/window"
LAYER = "model graphs"
MOVES = "rtfx"
WORKLOADS = ["turbo.batch16.beam5"]


def read(ctx):
    return readers.encoder_ms_per_window(ctx)
