"""Device ms per training step of the forward outside the renders and the
PBR pass: the photometric, geometric, multi-view and material losses."""


def read(ctx):
    r = ctx["trace"]
    s = r["stage_s"]
    ms = 1e3 * (s["step/forward"] - s["step/render"] - s["step/pbr"]) / r["steps"]
    return ms if s["step/forward"] > 0 else None
