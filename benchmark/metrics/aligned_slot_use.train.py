"""Percent: the share of the chunk-aligned slots that K1/K2 walk which
hold an instance. The program's "kept_instances" counter (each render's
(tile, Gaussian) pairs that the per-tile cull keeps) over its
"aligned_slots" counter, each summed over the traced steps' renders; at
most 100, below it by the chunk padding."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.slot_use(ctx)
