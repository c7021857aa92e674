"""Readings for a cell's limits: the program's numbers on many seeds and the
control's on a few, in one process.

    python3 ptbench/readings.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 2 --out readings.jsonl

Each seed is one run of the cell (`harness.run`) with a short window; on the
control seeds the reference in bfloat16 is also put in the program's place
(the precision below the configurations' float32); `--faults` names faults
of `faults.py` (comma-separated, or "all") to plant in the program's timed
path, from the end of set-up, on `--fault-seeds` (by default the control
seeds).  One JSON line per run
is appended to `--out`.  On the card only, as `run.py`.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default=None)
    parser.add_argument("--details", action="store_true")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from ptbench import faults, harness

    if not torch.cuda.is_available():
        print("ptbench: readings need a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    seeds = [(int(s), None) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    seeds += [(s, torch.bfloat16) for s in controls]
    planted = faults.FAULTS if args.faults == "all" else [f for f in args.faults.split(",") if f]
    planted_on = controls if args.fault_seeds is None else [int(s) for s in
                                                            args.fault_seeds.split(",") if s]
    seeds += [(s, f) for f in planted for s in planted_on]
    kind = harness.cell(bench, args.workload)[2]["kind"]
    for seed, what in seeds:
        t0 = time.perf_counter()
        if isinstance(what, str):
            line = harness.run(bench, args.workload, seed, args.seconds, False, "cuda:0", t0,
                               during=faults.planted(kind, what))
        else:
            line = harness.run(bench, args.workload, seed, args.seconds, False, "cuda:0", t0,
                               control_dtype=what, details=args.details)
        out = {"workload": args.workload, "seed": seed, "fault": what if isinstance(what, str)
               else None, "wall_s": time.perf_counter() - t0,
               "correct": line["correct"], "attempted": line["attempted"],
               "metrics": line["metrics"], "check_s": line["check_s"],
               "program": {k: v["value"] for k, v in line["checks"].items()},
               "control": line.get("control"), "details": line.get("details")}
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
        print(json.dumps(out), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
