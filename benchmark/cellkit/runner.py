"""One run of one cell: set-up, the compared steps, warm-up, the timed or
traced window, then the reference and the comparison.

Order of a run: the inputs from the seed (scene and state, on the device);
the program's trainer on them; the compared steps, which are the window's
own calls (their loss, first gradient and change are read); a fixed
warm-up that crosses a 100-iteration boundary; then the window. With
--trace 0 the window runs for the given seconds and gives the end-to-end
metrics; with --trace 1 it is a fixed number of steps under torch.profiler,
after a stretch without it that gives the step's own wall, and gives the
per-layer metrics. After the window the peak memory is read,
the program is freed, and the reference recomputes the compared steps.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import compare, program
from . import scene as S
from . import trace as TR
from . import work as WK
from .reference import pbr as RP
from .reference import raster as RR

FORBIDDEN = ("jax", "jaxlib", "flax", "gs2m_tpu")


def say(*parts):
    print("[bench]", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Modules loaded whose top-level name (before the first dot) is one the
    harness must never load: JAX, its libraries and the JAX package."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Sampler:
    """nvidia-smi's SM clock and power, sampled every 5 seconds by its own
    process beside the window (sparsely, so its driver queries seldom meet
    the step's launches); nothing where the tool is missing (a CPU run)."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        self.proc = None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "5000", "-i", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return {}
        col = lambda i: [r[i] for r in rows]
        return {"samples": len(rows),
                "sm_mhz": [min(col(0)), statistics.median(col(0)), max(col(0))],
                "power_w": [min(col(1)), statistics.median(col(1)), max(col(1))],
                "temp_c": [min(col(2)), max(col(2))]}


def card() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout
        name, limit = [x.strip() for x in out.strip().split(",")[:2]]
        return {"name": name, "power_limit": limit}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {}


class Clock:
    """Step boundaries: CUDA events on a card (no sync per step), the host
    clock on the CPU."""

    def __init__(self, device: torch.device, capacity: int):
        self.cuda = device.type == "cuda"
        self.marks = ([torch.cuda.Event(enable_timing=True) for _ in range(capacity)]
                      if self.cuda else [0.0] * capacity)
        self.n = 0

    def mark(self):
        if self.cuda:
            self.marks[self.n].record()
        else:
            self.marks[self.n] = time.perf_counter()
        self.n += 1

    def intervals_ms(self) -> list:
        if self.cuda:
            return [self.marks[i - 1].elapsed_time(self.marks[i])
                    for i in range(1, self.n)]
        return [1e3 * (self.marks[i] - self.marks[i - 1]) for i in range(1, self.n)]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compared_steps(tr, cfg: dict, seed: int, device, n: int) -> dict:
    """The program's readings over its first n steps: each step's loss and
    terms, the first step's gradient norms (from Adam's first moments) and
    the change of every leaf after the n steps (against the start state,
    made again from the seed)."""
    losses, terms = [], []
    for i in range(n):
        m = tr.train_step()
        losses.append(m["loss"])
        terms.append({k: m[k] for k in ("Lrgb", "Lgeo", "Lmat")})
        if i == 0:
            grad = program.grad_norms(program.first_moments(tr))
    start = S.make_state(cfg, seed, device)
    start_leaves = dict(start.params)
    if start.light is not None:
        start_leaves["light"] = start.light
    change = program.change_norms(program.leaves(tr), start_leaves)
    return {"loss": [float(x) for x in losses], "grad": grad, "change": change,
            "terms": [{k: float(v) for k, v in t.items()} for t in terms]}


def reference(cfg: dict, scene, state, seed: int):
    """The configuration's plain reference, found by the name in its file:
    cellkit/reference/<reference>.py, class Reference."""
    if not cfg["reference"].isidentifier():
        raise ValueError(f"not a reference module: {cfg['reference']!r}")
    mod = importlib.import_module(f"cellkit.reference.{cfg['reference']}")
    return mod.Reference(cfg, scene, state, seed)


def reference_steps(cfg: dict, scene, state, seed: int, n: int) -> tuple:
    """The reference's readings over the same n steps from the same inputs."""
    ref = reference(cfg, scene, state, seed)
    r_loss, r_terms = [], []
    for i in range(n):
        out = ref.step()
        r_loss.append(out["loss"])
        r_terms.append({k: out[k] for k in ("Lrgb", "Lgeo", "Lmat")})
        if i == 0:
            mu = dict(ref.mu)
            if ref.material:
                mu["light"] = ref.light_mu
            grad = program.grad_norms(mu)
    now, start = dict(ref.params), dict(state.params)
    if ref.material:
        now["light"], start["light"] = ref.light, state.light
    return ref, {"loss": r_loss, "grad": grad,
                 "change": program.change_norms(now, start), "terms": r_terms}


class CellRun:
    def __init__(self, cfg: dict, traffic: dict, workload: str, seed: int,
                 seconds: float, trace: bool, device, t0: float, limits: dict,
                 end_to_end: list, per_layer: list | None = None,
                 readers: dict | None = None):
        self.cfg, self.traffic, self.workload = cfg, traffic, workload
        self.end_to_end = end_to_end
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t0, self.limits = t0, limits
        self.per_layer, self.readers = per_layer or [], readers or {}
        self.marks: dict[str, float] = {}

    def mark(self, name):
        self.marks[name] = time.perf_counter() - self.t0

    # --- set-up -----------------------------------------------------------------

    def setup(self):
        cfg, dev = self.cfg, self.device
        if cfg["state"]["iteration"] < cfg["optim"]["densify_until_iter"]:
            raise ValueError("the window must lie after densification")
        self.mark("imports and device")
        self.scene = S.make_scene(cfg, self.seed, dev)
        state = S.make_state(cfg, self.seed, dev)
        self.tr = program.build(cfg, self.scene, state, self.seed, dev)
        del state
        self.caps0 = program.caps(self.tr)
        self.mark("inputs and trainer")
        self.prog = compared_steps(self.tr, self.cfg, self.seed, dev,
                                   self.traffic["compared_steps"])
        self.mark("compared steps")
        for _ in range(self.traffic["warmup_steps"]):
            m = self.tr.train_step()
            if self.tr.iteration % self.traffic["app_check_every"] == 0:
                program.app_checks(self.tr, m)
        sync(dev)
        self.mark("warm-up")
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t0

    # --- windows ----------------------------------------------------------------

    def _step(self, i, losses, drops):
        m = self.tr.train_step()
        losses[i] = m["loss"]
        drops[i] = m["dropped"]
        if self.tr.iteration % self.traffic["app_check_every"] == 0:
            program.app_checks(self.tr, m)
        if program.caps(self.tr) != self.caps_now:
            self.caps_now = program.caps(self.tr)
            self.cap_changes += 1

    def timed_window(self):
        dev = self.device
        cap = int(self.seconds * self.traffic["max_steps_per_s"]) + 2
        losses = torch.zeros(cap, device=dev)
        drops = torch.zeros(cap, dtype=torch.int32, device=dev)
        clock = Clock(dev, cap + 1)
        self.cap_changes, self.caps_now = 0, self.caps0
        sampler = Sampler()
        sync(dev)
        proc0 = time.process_time()
        t_start = time.perf_counter()
        clock.mark()
        n = 0
        while time.perf_counter() - t_start < self.seconds and n < cap:
            self._step(n, losses, drops)
            clock.mark()
            n += 1
        issued = time.perf_counter() - t_start
        sync(dev)
        wall = time.perf_counter() - t_start
        cpu_s = time.process_time() - proc0
        self.clocks = sampler.stop()
        steps_ms = clock.intervals_ms()
        loss_h = losses[:n].cpu().numpy()
        drop_h = drops[:n].cpu().numpy()
        self.steps = self.attempted = n
        self.failed = int(np.sum(~np.isfinite(loss_h) | (drop_h > 0)))
        p95 = float(np.percentile(steps_ms, 95)) if steps_ms else math.nan
        beyond = int(np.sum(np.asarray(steps_ms) > p95))
        dec = np.percentile(steps_ms, [10, 25, 50, 75, 90]).round(3).tolist()
        say(f"window: {n} steps in {wall:.4f} s (the host issued them in "
            f"{issued:.4f} s); step p95 {p95:.4f} ms with {beyond} steps beyond "
            f"it; step ms at 10/25/50/75/90 % {dec}; process CPU {cpu_s:.3f} s")
        return {"train_it_per_s": n / wall, "train_step_p95_ms": p95}

    def traced_window(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        dev = self.device
        n, u = self.traffic["traced_steps"], self.traffic["untraced_steps"]
        losses = torch.zeros(n + 1 + u, device=dev)
        drops = torch.zeros(n + 1 + u, dtype=torch.int32, device=dev)
        self.cap_changes, self.caps_now = 0, self.caps0
        # The step's wall without the profiler, which stretches it.
        sync(dev)
        t_start = time.perf_counter()
        for i in range(u):
            self._step(n + 1 + i, losses, drops)
        sync(dev)
        untraced_step_s = (time.perf_counter() - t_start) / u
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=n, repeat=1))
        prof.start()
        self._step(n, losses, drops)       # the profiler's warm-up step
        sync(dev)
        prof.step()
        t_start = time.perf_counter()
        for i in range(n):
            self._step(i, losses, drops)
            if i < n - 1:
                prof.step()
        sync(dev)
        wall = time.perf_counter() - t_start
        prof.step()
        prof.stop()
        loss_h, drop_h = losses.cpu().numpy(), drops.cpu().numpy()
        self.steps, self.attempted = n, n + 1 + u
        self.failed = int(np.sum(~np.isfinite(loss_h) | (drop_h > 0)))
        self.clocks = {}
        self.record = TR.compact(prof, n, wall)
        self.record["untraced_step_s"] = untraced_step_s
        del prof
        say(f"traced window: {n} steps in {wall:.4f} s, device busy "
            f"{self.record['busy_s']:.4f} s, {self.record['launches']} launches; "
            f"{u} steps before it without the profiler at "
            f"{1e3 * untraced_step_s:.4f} ms a step")

    # --- after the window --------------------------------------------------------

    def work_alike(self, ref) -> dict:
        """Alive, capacity, instance cap, cap changes and the mean instances
        of the window's renders (by the reference's tile rectangles on the
        start state). The window's views are the trainer's draws replayed by
        the reference's copy of its rule from a fresh `ref` of the same seed;
        work_counts reads them too."""
        done = self.traffic["compared_steps"] + self.traffic["warmup_steps"] + (
            self.traffic["untraced_steps"] + 1 if self.trace else 0)
        draws = [ref.draw() for _ in range(done + self.steps)][done:]
        self.window_draws = draws
        tile = self.cfg["pipeline"]["tile"]
        per_view = {}
        total = 0
        for v, nv, _, nb, has_nb in draws:
            for c in (v, nv) + ((nb,) if has_nb else ()):
                if c not in per_view:
                    per_view[c] = RR.instances(ref.params, ref.alive, ref.cams[c], tile)
                total += per_view[c]
        return {"alive": int(ref.alive.sum()), "capacity": self.final_caps[0],
                "instance_cap": self.final_caps[1], "cap_changes": self.cap_changes,
                "mean_instances_per_step": total / max(len(draws), 1),
                "distinct_views": len({d[0] for d in draws})}

    def work_counts(self, ref) -> dict:
        """The traced steps' work by the frozen formulas (cellkit/work.py)."""
        H, W = ref.cams[0].height, ref.cams[0].width
        fc = 9 if ref.material else 5
        cache = {}

        def counted(view, f):
            if (view, f) not in cache:
                c = {"pairs": 0, "visible": 0}
                with torch.no_grad():
                    RR.render(ref.params, ref.alive, ref.cams[view], ref.deg, f,
                              ref.tile, ref.chunk, counts=c)
                cache[(view, f)] = c
            return cache[(view, f)]

        renders, k1, k2 = [], [0.0, {}], [0.0, {}]
        samples = pbr_pixels = 0
        for v, nv, has_n, nb, has_nb in self.window_draws:
            rs = [(v, fc, True), (nv, fc, True)]
            if has_nb:
                rs.append((nb, 5, False))
            for view, f, grad in rs:
                c = counted(view, f)
                rec = {"pairs": c["pairs"], "visible": c["visible"],
                       "channels": 3 + f, "grad": grad}
                renders.append(rec)
                w1 = WK.k1_work(c["pairs"], c["visible"], H * W, 3 + f)
                t, b = WK.least_seconds(w1)
                k1[0] += t
                k1[1][b] = k1[1].get(b, 0) + 1
                if grad:
                    t, b = WK.least_seconds(WK.k2_work(c["pairs"], c["visible"],
                                                       H * W, 3 + f))
                    k2[0] += t
                    k2[1][b] = k2[1].get(b, 0) + 1
            samples += ref.o["multi_view_sample_num"] * (int(has_n) + int(has_nb))
            pbr_pixels += H * W if ref.material else 0
        prefilter = 0
        if ref.material:
            diffuse_res, spec = RP.mip_plan(ref.light.shape[1])
            prefilter = WK.prefilter_ops(ref.light.shape[1], diffuse_res, spec)
        ops = WK.step_ops(renders, H * W * len(self.window_draws), samples,
                          pbr_pixels, prefilter * len(self.window_draws))
        return {"k1_least_s": k1[0], "k1_bound": k1[1], "k2_least_s": k2[0],
                "k2_bound": k2[1], "step_ops": ops}

    def run(self) -> dict:
        self.setup()
        say("setup: " + ", ".join(f"{k} at {v:.3f} s" for k, v in self.marks.items()))
        e2e = None
        if self.trace:
            self.traced_window()
        else:
            e2e = self.timed_window()
        dev = self.device
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
        # Free the program's state before the reference runs.
        gc.unfreeze()
        self.final_caps = program.caps(self.tr)
        self.tr = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        state = S.make_state(self.cfg, self.seed, dev)
        ref, rread = reference_steps(self.cfg, self.scene, state, self.seed,
                                     self.traffic["compared_steps"])
        del ref
        say(f"reference: {time.perf_counter() - t_ref:.3f} s")
        replay = reference(self.cfg, self.scene, state, self.seed)
        alike = self.work_alike(replay)
        say("work alike " + json.dumps(alike) + " clocks " + json.dumps(self.clocks))
        nums = compare.numbers(self.prog, rread)
        say("readings " + json.dumps({"program": self.prog, "reference": rread,
                                      "left_out": nums["left_out"]}))
        metrics = {}
        breakdown = None
        if self.trace:
            wk = self.work_counts(replay)
            say("work " + json.dumps(wk))
            ctx = {"trace": self.record, "work": wk, "cfg": self.cfg,
                   "peaks": WK.PEAKS}
            for m in self.per_layer:
                value = self.readers[m["name"]](ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = {"device_ops": TR.top_ops(self.record),
                         "idle_gaps": self.record["gaps"]}
        else:
            values = dict(e2e, peak_mem_gib=peak / 2 ** 30, setup_s=self.setup_s)
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in self.end_to_end}
        correct, rows = compare.judge(nums, self.limits)
        leaked = forbidden_modules()
        if leaked:
            raise SystemExit(f"forbidden modules loaded: {leaked}")
        ccard = card()
        say(f"{self.workload} seed {self.seed} on {ccard.get('name', dev.type)}, "
            f"{ccard.get('power_limit', 'no power limit read')}")
        say(f"correct {correct}; the numbers compared, each beside its limit:")
        for name, v, lim in rows:
            say(f"compared {name} {v!r} limit {lim!r}")
        device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
        if self.trace:
            device["busy_s"] = self.record["busy_s"]
            device["window_s"] = self.record["window_s"]
        out = {"correct": bool(correct), "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics, "device": device}
        if breakdown is not None:
            out["breakdown"] = breakdown
        out["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
        return out
