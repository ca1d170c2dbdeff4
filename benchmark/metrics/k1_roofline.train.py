"""The forward blend kernel's share of its roofline: the least time the
traced steps' forward blends need (cellkit/work.py, from the reference's
count of contributing pairs on the cell's views) over the device time of
the kernels named blend_fwd_kernel."""


def read(ctx):
    s = sum(sec for name, (_, sec) in ctx["trace"]["kernels"].items()
            if "blend_fwd_kernel" in name)
    return 100.0 * ctx["work"]["k1_least_s"] / s if s > 0 else None
