"""Share of the traced slice's wall with no device operation running."""

from portbench import readers

UNIT = "%"
LAYER = "device"
MOVES = "rtfx"
WORKLOADS = ["turbo.batch16.beam5"]


def read(ctx):
    return readers.device_idle_pct(ctx)
