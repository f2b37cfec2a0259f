"""The harness's clock around each ContinuousBatcher.submit() of the window (the
request's mel on the card, its language pin, its queueing), mean."""

UNIT = "ms"
LAYER = "serving batcher"
MOVES = "latency_p95_s"
WORKLOADS = ["turbo.serve8.greedy"]


def read(ctx):
    s = ctx.window.get("submit_s")
    return 1000.0 * sum(s) / len(s) if s else None
