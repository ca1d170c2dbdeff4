"""Device ms per training step of the backward: what step/backward launches
and every kernel the autograd engine's own threads launch."""


def read(ctx):
    r = ctx["trace"]
    s = r["stage_s"]["step/backward"] + r["engine_s"]
    return 1e3 * s / r["steps"] if s > 0 else None
