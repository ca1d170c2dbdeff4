"""Run one cell of the benchmark of gs2m_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's number of CUDA
cards. The cell's configuration, traffic mix and metrics are found by name
(benchmark/cellkit/cells.py). The last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"], "compared"}; the numbers compared, each beside its limit, are
also the last lines of standard error. Exits non-zero, printing no result,
without enough cards or when JAX or the JAX package got loaded.
"""
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Every build and kernel cache at a fixed path inside the checkout. The
# program's CUDA kernels are built under build/kernels/ by its own loader.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cellkit import cells

    bench = cells.benchmark()
    wl = cells.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"[bench] {args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from cellkit import compare, runner

    cfg = cells.config(wl["config"])
    per_layer = cells.per_layer_for(bench, wl["name"]) if args.trace else []
    run = runner.CellRun(cfg, cells.traffic(wl["traffic"]), wl["name"], args.seed,
                         args.seconds, bool(args.trace), "cuda", T0,
                         compare.load_limits(cfg["name"]),
                         bench["end_to_end"], per_layer,
                         {m["name"]: cells.reader(m["name"]) for m in per_layer})
    out = run.run()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
