"""Host ms per training step in the PBR pass: the program's step/pbr spans,
over the steps run without the profiler; None without a PBR pass."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.stage_ms(ctx, "step/pbr")
