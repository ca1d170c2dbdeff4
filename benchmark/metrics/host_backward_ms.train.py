"""Host ms per training step in the backward: the program's step/backward
spans, where the step's thread waits while the autograd engine issues the
backward's launches, over the steps run without the profiler."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.stage_ms(ctx, "step/backward")
