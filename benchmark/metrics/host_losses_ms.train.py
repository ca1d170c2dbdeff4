"""Host ms per training step in the forward outside the renders and the
PBR pass (the losses): the self time of the program's step/forward spans,
over the steps run without the profiler."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.stage_ms(ctx, "step/forward")
