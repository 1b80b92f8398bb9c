"""Seconds of the stepper's set-up on the host: the Morton order, the k
nearest neighbours and the window plan, each a host-clock span."""

PARTS = ("setup.morton", "setup.knn", "setup.plan")


def read(ctx):
    if not all(p in ctx.spans.host_s for p in PARTS):
        return None
    return sum(ctx.spans.host_s[p] for p in PARTS)
