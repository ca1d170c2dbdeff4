"""Host ms per training step in the step's renders: the self time of the
program's step/render spans, over the steps run without the profiler."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.stage_ms(ctx, "step/render")
