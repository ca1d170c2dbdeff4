"""The whole training step's share of the card's float32 peak: the traced
steps' operations by the frozen count (cellkit/work.py::step_ops) per step,
over the step's wall measured without the profiler, over 67 TFLOP/s
(benchmark/peaks.json)."""


def read(ctx):
    r = ctx["trace"]
    ops = ctx["work"]["step_ops"]
    wall = r.get("untraced_step_s", 0.0)
    if ops <= 0 or wall <= 0:
        return None
    return 100.0 * ops / r["steps"] / wall / ctx["peaks"]["float32_flops"]
