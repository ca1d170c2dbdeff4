"""Device ms per training step under step/update: the densification
statistics and Adam over the capacity's rows."""


def read(ctx):
    r = ctx["trace"]
    s = r["stage_s"]["step/update"]
    return 1e3 * s / r["steps"] if s > 0 else None
