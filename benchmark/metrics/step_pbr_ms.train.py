"""Device ms per training step under step/pbr: the light's mips and
prefilters and the split-sum shading; nothing in a geometry-only cell."""


def read(ctx):
    r = ctx["trace"]
    s = r["stage_s"]["step/pbr"]
    return 1e3 * s / r["steps"] if s > 0 else None
