"""Run one cell of the port's benchmark once and print its result's line.

    python3 ptbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (`haskell_path_tracer_torch`)
on a machine with the cell's CUDA devices.  Set-up (building the program's
kernels on a checkout's first run, loading them, the scene, one warm-up unit)
is timed from the process's start; then the cell's traffic runs for
`--seconds` and until its unit in flight completes; with `--trace 1` under
`torch.profiler`, which gives the per-layer metrics.  Once the window has
closed, the plain reference checks what the window produced.  The last line
of standard output is one JSON object; the numbers compared, beside their
limits, are the last lines of standard error.
"""

import os
import sys
import time


def process_start() -> float:
    """The perf_counter reading at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "haskell_path_tracer_tpu")


def fail(message: str, code: int = 2):
    print(f"ptbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    import argparse
    import importlib.util
    import json

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache a run writes stays inside the checkout, at fixed paths.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, ".ptbench_cache", sub))
    sys.path.insert(0, ROOT)
    import torch

    from ptbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = [w["chips"] for w in bench["workloads"] if w["name"] == args.workload]
    if not chips:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[0]:
        fail(f"the cell needs {chips[0]} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if importlib.util.find_spec("haskell_path_tracer_torch") is None:
        fail("the program, haskell_path_tracer_torch, is not in this checkout")
    torch.set_num_threads(2)
    line = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                       "cuda:0", T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        fail(f"modules that the benchmark must not load are loaded: {loaded}", 3)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
