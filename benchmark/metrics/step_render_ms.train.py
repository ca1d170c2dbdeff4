"""Device ms per training step under the trainer's step/render ranges: the
view's renders (projection, binning, blend) and, in the material stage, the
nearby view's render."""


def read(ctx):
    r = ctx["trace"]
    return 1e3 * r["stage_s"]["step/render"] / r["steps"] or None
