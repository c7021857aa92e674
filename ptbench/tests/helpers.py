"""Tiny shapes for the CPU tests: each cell as it is, at a few pixels and
samples, so the program's plain paths and the reference both run here."""

import os
import time

from ptbench import harness

ROOT = harness.ROOT
CELLS = ("big1000_nee.render", "reference_parity.train", "big1000_nee.train")
MEASURED = ("big1000_nee.render", "big1000_nee.train")  # the cells in BENCHMARK.json


def tiny(workload: str) -> dict:
    over = {"config.width": 24, "config.height": 16}
    if workload.endswith(".render"):
        over.update({"traffic.spp": 6, "traffic.candidate_pixels": 300,
                     "traffic.checked_pixels": 48})
    else:
        over.update({"traffic.spp": 2, "traffic.checked_within": 8})
    if workload == "big1000_nee.train":
        # On the CPU the program runs its plain NEE route, which reads the
        # emitters from illuminance > 0 at every call instead of keeping
        # `light_idx`'s (diff/grad.py, "Frozen emitters"): after one update
        # the spheres' illuminance leaves 0 and the routes part.  The card
        # runs the kernels, which keep them, as the reference does; here one
        # step is checked, an episode's first, from the first state.
        over["traffic.checked_steps"] = 1
    return over


# The parity train cell's files are in ptbench/ but its entries are not in
# BENCHMARK.json (PERF.md, Open questions); the tests add them, as a later
# change would.
PARITY = {
    "configs": [{"name": "reference_parity", "source": "the reference program's world",
                 "file": "ptbench/configs/reference_parity.json", "reduced": [],
                 "why": "the reference program's world under the parity estimator"}],
    "workloads": [{"name": "reference_parity.train", "config": "reference_parity",
                   "traffic": "sgd_64spp", "chips": 1, "why": "parity SGD steps"}],
}


def bench(with_parity: bool = True) -> dict:
    b = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if with_parity:
        for key, entries in PARITY.items():
            b[key] += entries
        for m in b["end_to_end"] + b["per_layer"]:
            if "big1000_nee.train" in m.get("workloads", ()):
                m["workloads"].append("reference_parity.train")
    return b


def run_tiny(workload: str, seed: int = 2**31 + 7, trace: bool = False, **kw) -> dict:
    """One run of the cell on the CPU at a tiny size, a 0.2 s window."""
    return harness.run(bench(), workload, seed, 0.2, trace, "cpu", time.perf_counter(),
                       tiny(workload), **kw)
