"""Readings that set a cell's comparison limits and buffer sizes, taken on
the card at the cell's own size; the benchmark's own runs never run this.

    python3 benchmark/readings.py --config <name> --seeds 1 2 3 ... \
        [--probe] [--control N] [--faults N] [--out <file.jsonl>]

For each seed, in one process: the program's compared steps against the
reference's (the sound reading, the lower end of each limit); with
--control N, on the first N seeds, the reference computed with TF32 (the nearest precision below
the configuration's float32 with TF32 off) against the reference (the
upper end); with --faults N, on the first N seeds, the program with a
fault planted underneath against the reference; with --probe, each view's
instance demand by the program's own binning at an unbounded cap (what
the configuration's instance_cap is set from). One JSON line per reading.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]

import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from cellkit import cells, compare, program, runner  # noqa: E402
from cellkit import scene as S  # noqa: E402

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def tf32():
    """The reference computed with TF32 in its matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


@contextlib.contextmanager
def planted(fault: str, tr=None):
    """A fault in the program's timed path, planted by replacing one of its
    functions for the duration: `unchanged` (the step leaves the state as it
    was: Adam and the light's update do nothing), `half_batch` (the
    photometric loss over the top half of the image's rows, the mean taken
    over them) or `altered` (every channel the blend produces, colour and
    features, off by one 8-bit level where it is produced)."""
    import gs2m_tpu_torch.models.losses as L
    import gs2m_tpu_torch.models.render as MR
    import gs2m_tpu_torch.train.trainer as TT

    undo = []

    def swap(mod, name, fn):
        undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "unchanged":
        swap(TT, "adam_update", lambda params, grads, state, lrs, **kw: (params, state))
        if tr is not None and tr.pbr_fns is not None:
            fns = tr.pbr_fns
            undo.append((None, fns, fns["light_update"]))
            fns["light_update"] = lambda light, grad, state, lr: (light, state)
    elif fault == "half_batch":
        orig = L.rgb_loss

        def half(pred, gt, lam):
            h = pred.shape[-2] // 2
            return orig(pred[..., :h, :], gt[..., :h, :], lam)
        swap(L, "rgb_loss", half)
    elif fault == "altered":
        orig = MR.rasterize_from_projected

        def altered(*a, **kw):
            out = orig(*a, **kw)
            return out._replace(color=out.color + 1.0 / 255.0,
                                buffer=out.buffer + 1.0 / 255.0)
        swap(MR, "rasterize_from_projected", altered)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for mod, name, fn in reversed(undo):
            if mod is None:
                name["light_update"] = fn
            else:
                setattr(mod, name, fn)


def program_reading(cfg, traffic, seed, dev, fault=None):
    scene = S.make_scene(cfg, seed, dev)
    tr = program.build(cfg, scene, S.make_state(cfg, seed, dev), seed, dev)
    ctx = planted(fault, tr) if fault else contextlib.nullcontext()
    with ctx:
        prog = runner.compared_steps(tr, cfg, seed, dev, traffic["compared_steps"])
    del tr
    gc.collect()
    return scene, prog


def probe(cfg, seed, dev) -> dict:
    """Each view's instance demand: the binning's expanded instances and its
    chunk-aligned slots, at an unbounded cap."""
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.ops.binning import bin_gaussians
    from gs2m_tpu_torch.ops.projection import project

    scene = S.make_scene(cfg, seed, dev)
    st = S.make_state(cfg, seed, dev)
    tr = program.build(cfg, scene, st, seed, dev)
    g: Gaussians = tr.gaussians
    tile, chunk = cfg["pipeline"]["tile"], cfg["pipeline"]["chunk"]
    cap = 2 ** 25
    totals, aligned = [], []
    with torch.no_grad():
        op = g.get_opacity[:, 0]
        for cam in tr.scene.train_cameras:
            pr = project(g, cam, 0, op, tile=tile, with_colors=False)
            b = bin_gaussians(pr, cam.height, cam.width, tile, cap, chunk,
                              opacities=op)
            totals.append(int(b.num_instances))
            aligned.append(int(b.num_aligned))
    return {"expanded_max": max(totals), "aligned_max": max(aligned),
            "expanded_mean": sum(totals) / len(totals),
            "aligned_mean": sum(aligned) / len(aligned)}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="post-densify-window")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--sound", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    cfg, traffic = cells.config(args.config), cells.traffic(args.traffic)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else sys.stdout

    def emit(rec):
        rec.update(config=args.config, card=torch.cuda.get_device_name(dev))
        print(json.dumps(rec), file=out, flush=True)

    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        if args.probe:
            emit({"kind": "probe", "seed": seed, **probe(cfg, seed, dev)})
            gc.collect()
            torch.cuda.empty_cache()
        if not (args.sound or i < args.control or i < args.faults):
            continue
        scene, prog = program_reading(cfg, traffic, seed, dev)
        state = S.make_state(cfg, seed, dev)
        _, ref = runner.reference_steps(cfg, scene, state, seed,
                                        traffic["compared_steps"])
        emit({"kind": "sound", "seed": seed, **compare.numbers(prog, ref),
              "program": prog, "reference": ref,
              "seconds": time.perf_counter() - t})
        if i < args.control:
            with tf32():
                _, low = runner.reference_steps(cfg, scene, state, seed,
                                                traffic["compared_steps"])
            emit({"kind": "control", "seed": seed, **compare.numbers(low, ref)})
        if i < args.faults:
            for fault in FAULTS:
                _, bad = program_reading(cfg, traffic, seed, dev, fault)
                emit({"kind": fault, "seed": seed, **compare.numbers(bad, ref)})
        del scene, state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
