"""Percent of a step's wall in which no operation ran on the device: one
less the traced steps' device busy time per step over the step's wall
measured without the profiler (the stretch before the traced steps), since
the profiler's own host work stretches the traced wall."""


def read(ctx):
    r = ctx["trace"]
    wall = r.get("untraced_step_s", 0.0)
    if wall <= 0 or r["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["steps"] / wall)
