"""Host-side spans and counters of the training step.

One primitive with two sinks. `span(name)` is a context manager:

- under an active profiler session (torch.profiler), it opens a
  `record_function` range of the same name, so the spans are the device
  trace's CPU rows, on the trace's clock (what apps/train.py::step_stages
  reads);
- with the recorder enabled (`enable()`), it logs (step id, name, parent
  span, start ns, end ns, whether a profiler session was on) from
  time.perf_counter_ns() into a preallocated ring that only `snapshot()`
  reads out;
- with neither, it costs two attribute reads and returns a no-op.

`count(name, value)` keeps a reference to a (device) scalar while the
recorder is on: no launch and no sync until `snapshot()`, which reads all
of them with one sync per device. The step id is the trainer's iteration,
set by `set_step` at the start of each step. Spans nest on the thread that
opens them, the training step's; the autograd engine's threads open none.

STAGES is the one table of the step's stage names.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

# Short key -> span name of each stage of train/trainer.py::make_train_step.
STAGES = {
    "forward": "step/forward",     # the forward: renders, pbr and the losses
    "render": "step/render",       # each render of the step, inside forward
    "pbr": "step/pbr",             # the PBR pass, inside forward
    "backward": "step/backward",   # autograd.grad (the engine's threads issue)
    "reduce": "step/reduce",       # the data-parallel collectives
    "update": "step/update",       # densification statistics and Adam
    "light": "step/light",         # the light's Adam step
}

SPAN_CAPACITY = 1 << 16
COUNT_CAPACITY = 1 << 14


class Recorder:
    """The in-memory log: two rings of fixed size, allocated by enable()."""

    def __init__(self):
        self.on = False
        self.step = 0
        self.spans: list | None = None    # (seq, step, name, parent, t0, t1, profiled)
        self.counts: list | None = None   # (step, name, value)
        self.n_spans = self.n_counts = 0  # entries written since reset()
        self.seq = 0                      # ids of the spans opened so far
        self.open: list[int] = []         # ids of the spans open now


_REC = Recorder()


class _Span:
    __slots__ = ("name", "rf", "seq", "parent", "t0")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.rf = record_function(name) if profiled else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        rec = _REC
        self.parent = rec.open[-1] if rec.open else -1
        self.seq = rec.seq
        rec.seq += 1
        rec.open.append(self.seq)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = _REC
        rec.open.pop()
        if rec.spans is not None:
            rec.spans[rec.n_spans % SPAN_CAPACITY] = (
                self.seq, rec.step, self.name, self.parent, self.t0, t1,
                self.rf is not None)
            rec.n_spans += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over one stage of the step (see the module doc)."""
    if _REC.on:
        return _Span(name, _profiler._is_profiler_enabled)
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def count(name: str, value) -> None:
    """Log `value` (a scalar tensor, kept by reference, or a number) under
    `name` for the current step; nothing while the recorder is off."""
    rec = _REC
    if rec.on:
        rec.counts[rec.n_counts % COUNT_CAPACITY] = (rec.step, name, value)
        rec.n_counts += 1


def set_step(step: int) -> None:
    """The id of the step whose spans and counts follow."""
    _REC.step = step


def recording() -> bool:
    """Whether the recorder is on: a counter that costs launches to compute
    is computed only then."""
    return _REC.on


def enable() -> None:
    rec = _REC
    if rec.spans is None:
        rec.spans = [None] * SPAN_CAPACITY
        rec.counts = [None] * COUNT_CAPACITY
    rec.on = True


def disable() -> None:
    _REC.on = False


def reset() -> None:
    """Empty the log (and drop the counters' references); enabled stays."""
    rec = _REC
    if rec.spans is not None:
        rec.spans = [None] * SPAN_CAPACITY
        rec.counts = [None] * COUNT_CAPACITY
    rec.n_spans = rec.n_counts = 0


def _host_values(values: list) -> list:
    """Tensors to floats with one sync per device; numbers as they are."""
    out = [float(v) if not isinstance(v, torch.Tensor) else None for v in values]
    by_device: dict = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        host = torch.stack([values[i].reshape(()).to(torch.float64)
                            for i in idx]).cpu().tolist()
        for i, x in zip(idx, host):
            out[i] = x
    return out


def snapshot(steps=None) -> dict:
    """What the log holds, of the given step ids (all when None):
    {"steps": the step ids seen, sorted, "profiled": those of them with a span
     opened under a profiler session, "lost": entries the rings overwrote,
     "outer_s": the outermost spans' durations summed (the time under any span),
     "spans": {name: {"n", "total_s", "self_s"}}, "counters": {name: [values]}}.
    A span's self time is its duration less its children's durations."""
    rec = _REC
    spans = [e for e in (rec.spans or ())[:min(rec.n_spans, SPAN_CAPACITY)]
             if e is not None]
    counts = [e for e in (rec.counts or ())[:min(rec.n_counts, COUNT_CAPACITY)]
              if e is not None]
    lost = (max(rec.n_spans - SPAN_CAPACITY, 0)
            + max(rec.n_counts - COUNT_CAPACITY, 0))
    children: dict[int, int] = {}
    for _, _, _, parent, t0, t1, _ in spans:
        if parent >= 0:
            children[parent] = children.get(parent, 0) + t1 - t0
    if steps is not None:
        steps = set(steps)
        spans = [e for e in spans if e[1] in steps]
        counts = [e for e in counts if e[0] in steps]
    out_spans: dict[str, dict] = {}
    outer = 0
    for seq, _, name, parent, t0, t1, _ in spans:
        s = out_spans.setdefault(name, {"n": 0, "total_s": 0.0, "self_s": 0.0})
        s["n"] += 1
        s["total_s"] += (t1 - t0) / 1e9
        s["self_s"] += (t1 - t0 - children.get(seq, 0)) / 1e9
        outer += t1 - t0 if parent < 0 else 0
    values = _host_values([v for _, _, v in counts])
    counters: dict[str, list] = {}
    for (_, name, _), v in zip(counts, values):
        counters.setdefault(name, []).append(v)
    seen = {e[1] for e in spans} | {e[0] for e in counts}
    profiled = {e[1] for e in spans if e[6]}
    return {"steps": sorted(seen), "profiled": sorted(profiled), "lost": lost,
            "outer_s": outer / 1e9, "spans": out_spans, "counters": counters}
