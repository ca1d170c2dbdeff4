"""%: the share of the PBR pass's shaded pixels that the PBR loss keeps.
The program's "pbr_fg_pixels" counter (each material step's pixels inside
the surface mask, normal_mask) summed over the traced steps, over its
"pbr_pixels" counter (each step's shaded pixels, the whole frame) summed;
None without those counters (a program that has none, or a step without
the PBR pass). The rest of the pass's work is on the background."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    s = host_spans.read(ctx)
    if s is None:
        return None
    c = s["traced"]["counters"]
    fg, shaded = c.get("pbr_fg_pixels"), c.get("pbr_pixels")
    if not fg or not shaded or len(fg) != len(shaded) or sum(shaded) <= 0:
        return None
    return 100.0 * sum(fg) / sum(shaded)
