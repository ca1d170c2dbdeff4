"""Kernel launches in the traced window per training step (copies and
fills not counted): the lever of a step bound by the host's launch rate."""


def read(ctx):
    r = ctx["trace"]
    return r["launches"] / r["steps"] if r["launches"] else None
