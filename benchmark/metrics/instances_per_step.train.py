"""Instances binned per training step: the program's "instances" counter
(each render's (tile, Gaussian) pairs) summed over the traced steps'
renders, per step."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.instances_per_step(ctx)
