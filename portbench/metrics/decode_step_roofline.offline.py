"""The decode step's share of its roofline: the bytes its math must move
(roofline.py) at HBM's peak, the bound that holds for a step, over its
device-busy time in the traced slice."""

from portbench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "rtfx"
WORKLOADS = ["turbo.batch16.beam5"]


def read(ctx):
    return readers.decode_step_roofline(ctx)
