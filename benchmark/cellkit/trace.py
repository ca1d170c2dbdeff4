"""The traced window: torch.profiler over a fixed number of training steps,
reduced to a compact record that the per-layer readers take.

The record holds the steps traced, the window's wall, the device time by
kernel name, the union of device activity (busy), the count of kernel
launches, the device time under each of the trainer's step/* profiler
ranges (with the autograd engine's threads, where a card's backward runs,
as the program's apps/train.py::step_stages counts it) and the longest idle
gaps with what the host was doing when each began.
"""
from __future__ import annotations

import bisect

STAGES = ("step/forward", "step/render", "step/pbr", "step/backward",
          "step/update", "step/light")


def _is_copy(name: str) -> bool:
    n = name.lower()
    return n.startswith("memcpy") or n.startswith("memset")


def compact(prof, steps: int, window_s: float, top: int = 10) -> dict:
    """Reduce a finished profiler session (CPU and CUDA activity) to the
    record; window_s is the traced steps' wall between two syncs."""
    from torch.autograd import DeviceType

    events = prof.events()
    # Device activity only: a profiler range's device-side span covers the
    # gaps between its kernels, so user annotations are not activity.
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    kernels: dict[str, list] = {}
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        rec = kernels.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += b - a
    spans.sort()
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((a - cur_b, cur_b))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a

    step_threads = {e.thread for e in cpu if e.name == "step/forward"}
    stage_us = {n: 0.0 for n in STAGES}
    engine_us = 0.0
    for e in cpu:
        if e.name in stage_us:
            stage_us[e.name] += e.device_time_total
        elif e.cpu_parent is None and e.thread not in step_threads:
            engine_us += e.device_time_total

    # What the host ran when each of the longest gaps began: the innermost
    # CPU op covering that moment on any thread (the backward runs on the
    # autograd engine's), under the step/* range of the step's thread.
    ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu),
                 key=lambda x: x[0])
    starts = [o[0] for o in ops]

    def label(t):
        i = bisect.bisect_right(starts, t)
        inner, stage = None, "host"
        for a, b, name in reversed(ops[max(0, i - 20000):i]):
            if b >= t:
                if inner is None and not name.startswith("step/"):
                    inner = name
                if name.startswith("step/") and name != "step/forward":
                    stage = name
                    break
                if name == "step/forward" and stage == "host":
                    stage = name
        return f"{stage}:{inner or 'idle'}"

    gaps.sort(reverse=True)
    return {
        "steps": steps, "window_s": window_s, "busy_s": busy / 1e6,
        "launches": sum(n for name, (n, _) in kernels.items() if not _is_copy(name)),
        "kernels": {name: [n, us / 1e6] for name, (n, us) in kernels.items()},
        "stage_s": {k: v / 1e6 for k, v in stage_us.items()},
        "engine_s": engine_us / 1e6,
        "gaps": [[label(t0), us / 1e6] for us, t0 in gaps[:top]],
    }


def top_ops(record: dict, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    rows = sorted(((s, name) for name, (_, s) in record["kernels"].items()),
                  reverse=True)[:top]
    return [[name, s] for s, name in rows]


def kernel_seconds(record: dict, fragment: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name has `fragment`."""
    n = s = 0
    for name, (k, sec) in record["kernels"].items():
        if fragment in name:
            n += k
            s += sec
    return n, s
