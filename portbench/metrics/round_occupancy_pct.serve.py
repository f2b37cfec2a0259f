"""The window's batcher counters: windows decoded over rounds times slots."""

UNIT = "%"
LAYER = "serving batcher"
MOVES = "latency_p95_s"
WORKLOADS = ["turbo.serve8.greedy"]


def read(ctx):
    st = ctx.window.get("stats")
    if not st or not st["rounds"]:
        return None
    return 100.0 * st["windows_decoded"] / (st["rounds"] * ctx.mix["slots"])
