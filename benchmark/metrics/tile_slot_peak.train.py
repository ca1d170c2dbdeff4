"""x: how much deeper the deepest tile is than the mean tile. The program's
"tile_slots_max" counter (each render's most chunk-aligned slots in one
tile), summed over the traced steps' renders, over each render's mean
slots a tile ("aligned_slots" / "tiles"), summed; 1 where every tile
holds as many slots. K1 and K2 run one block per tile, so the deepest
tile bounds their tail."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    s = host_spans.read(ctx)
    if s is None:
        return None
    c = s["traced"]["counters"]
    peak, slots, tiles = (c.get(k) for k in ("tile_slots_max", "aligned_slots",
                                              "tiles"))
    if not peak or not slots or not tiles or not len(peak) == len(slots) == len(tiles):
        return None
    mean = sum(a / t for a, t in zip(slots, tiles))
    return sum(peak) / mean if mean > 0 else None
