"""The backward blend kernel's share of its roofline: the least time the
traced steps' differentiated blends need over the device time of the
kernels named blend_bwd_kernel."""


def read(ctx):
    s = sum(sec for name, (_, sec) in ctx["trace"]["kernels"].items()
            if "blend_bwd_kernel" in name)
    return 100.0 * ctx["work"]["k2_least_s"] / s if s > 0 else None
