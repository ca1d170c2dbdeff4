"""Host ms per training step in the update (densification statistics and
Adam): the program's step/update spans, over the steps run without the
profiler."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.stage_ms(ctx, "step/update")
