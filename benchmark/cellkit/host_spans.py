"""The program's span recorder (gs2m_tpu_torch/utils/spans.py) in a traced
run, read for the host_* and counter readers.

run.py loads a traced run's readers before its set-up; the readers of the
recorder's metrics call `arm()` as they load, which turns the recorder on
for the run. A timed run loads no reader, so its recorder stays off. After
the window, `read(ctx)` takes the log apart by step id (the trainer's
iteration): "untraced", the `untraced_steps` steps run without the
profiler just before the traced ones (their host times; the runner's
untraced_step_s is their wall), and "traced", the `traced_steps` profiled
steps (their counters: the steps whose views work_alike counts). That
split assumes traced_window's order; it is checked against the spans the
profiler saw and the runner's untraced_step_s, and a mismatch reads as
nothing. It keeps both in ctx["spans"] and prints them to standard error.
Without the recorder (a program that has none, or a run that did not arm
it) there is nothing to read, and the readers return None.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import cells

def _recorder():
    try:
        from gs2m_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def _window() -> tuple[int, int] | None:
    """(untraced_steps, traced_steps) of the cell this process runs, by
    run.py's --workload; None outside run.py."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    args, _ = ap.parse_known_args(sys.argv[1:])
    if not args.workload:
        return None
    bench = cells.benchmark()
    mix = cells.traffic(cells.workload(bench, args.workload)["traffic"])
    return mix["untraced_steps"], mix["traced_steps"]


def arm() -> None:
    """Turn the program's recorder on, empty, in a run of run.py."""
    spans = _recorder()
    if spans is not None and _window() is not None:
        spans.reset()
        spans.enable()


def read(ctx: dict) -> dict | None:
    """ctx["spans"] = {"untraced": snapshot, "traced": snapshot}, taken from
    the recorder once; None when there is nothing to read."""
    if "spans" not in ctx:
        ctx["spans"] = _take(ctx)
    return ctx["spans"]


def _take(ctx: dict) -> dict | None:
    spans, window = _recorder(), _window()
    if spans is None or window is None:
        return None
    u, n = window
    ids = spans.snapshot()["steps"]
    spans.disable()
    if len(ids) < u + n + 1:
        return None
    # traced_window's order: u steps, the profiler's warm-up step, n traced
    # steps, and no step after them. _fault checks that guess against what
    # the recorder and the runner saw.
    last = ids[-1]
    untraced = range(last - n - u, last - n)
    traced = range(last - n + 1, last + 1)
    out = {"untraced": spans.snapshot(untraced), "traced": spans.snapshot(traced)}
    spans.reset()
    fault = _fault(out, u, n, ctx.get("trace", {}).get("untraced_step_s", 0.0))
    if fault:
        print(f"[bench] host spans not read: {fault}", file=sys.stderr, flush=True)
        return None
    print("[bench] host spans " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def _fault(out: dict, u: int, n: int, wall: float) -> str | None:
    """Why the two snapshots are not the runner's u unprofiled steps and n
    profiled steps; None when they are."""
    a, b = out["untraced"], out["traced"]
    if len(a["steps"]) != u or len(b["steps"]) != n:
        return f"{len(a['steps'])} + {len(b['steps'])} steps, not {u} + {n}"
    if a["profiled"]:
        return f"steps {a['profiled']} of the unprofiled ones ran under the profiler"
    if b["profiled"] != b["steps"]:
        return "some of the traced steps ran without the profiler"
    if wall <= 0 or a["outer_s"] / u > wall:
        return (f"the unprofiled steps' spans, {a['outer_s'] / u:.6f} s a step, "
                f"exceed the runner's wall of {wall:.6f} s a step")
    return None


def stage_ms(ctx: dict, name: str) -> float | None:
    """Host ms per untraced step of the spans `name`, less their children."""
    s = read(ctx)
    if s is None or name not in s["untraced"]["spans"]:
        return None
    a = s["untraced"]
    return 1e3 * a["spans"][name]["self_s"] / len(a["steps"])


def unspanned_ms(ctx: dict) -> float | None:
    """The untraced step's wall less the time under its spans, per step."""
    s = read(ctx)
    wall = ctx["trace"].get("untraced_step_s", 0.0)
    if s is None or wall <= 0:
        return None
    a = s["untraced"]
    return 1e3 * (wall - a["outer_s"] / len(a["steps"]))


def instances_per_step(ctx: dict) -> float | None:
    """The "instances" counter summed over the traced steps, per step."""
    s = read(ctx)
    if s is None or not s["traced"]["counters"].get("instances"):
        return None
    return sum(s["traced"]["counters"]["instances"]) / len(s["traced"]["steps"])


def slot_use(ctx: dict) -> float | None:
    """Percent of the traced steps' aligned slots that hold a kept instance:
    per render min(kept, aligned) (more kept than slots only where the
    capacity cap drops), summed, over the aligned slots summed."""
    s = read(ctx)
    if s is None:
        return None
    c = s["traced"]["counters"]
    kept, slots = c.get("kept_instances"), c.get("aligned_slots")
    if not kept or not slots or len(kept) != len(slots) or sum(slots) <= 0:
        return None
    return 100.0 * sum(map(min, kept, slots)) / sum(slots)
