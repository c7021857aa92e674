"""The program's own spans in a traced run, and the readings they give.

The port opens profiler spans named "hpt.*" at its layer boundaries
(`haskell_path_tracer_torch/utils/metrics.py:span`), on the clock of the
device activity in the same trace.  `trace.collect` keeps only the
benchmark's "ptbench." spans, so no registered per-layer metric reads the
program's; this module holds what reads them: `collect`, which keeps them
too, and `READINGS`, each a reading over a `trace.Record` that holds them.

    python3 ptbench/spans.py --workload <name> --seed <n> [--seconds 40]

makes one traced run of the cell (`harness.run` with the trace on) with
`collect` in `trace.collect`'s place, and prints one JSON line: the line
of `run.py --trace 1`, whose breakdown then names each idle gap by the
innermost span the host was in, program or benchmark, and under "spans"
the readings of the cell, the idle seconds by that innermost span, and each
span's count and host seconds.  On the card only, as `run.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptbench import trace  # noqa: E402

PROGRAM = "hpt."
_BENCHMARK_COLLECT = trace.collect  # `traced` puts `collect` in its place


def collect(prof) -> tuple:
    """`trace.collect`'s (window, spans, device events) with the program's
    CPU spans kept as well, and any device event named as one of them (a
    profiler's mirror of a span, not device work) dropped."""
    window, spans, device = _BENCHMARK_COLLECT(prof)
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU") and e.name().startswith(PROGRAM):
            spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return window, spans, [ev for ev in device if not ev[0].startswith(PROGRAM)]


def union(intervals) -> list:
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_union(rec, names) -> list:
    """The union of the spans named `names`, clipped to the window."""
    w0, w1 = rec.window
    return union((max(s, w0), min(e, w1)) for n, s, e in rec.spans
                 if n in names and e > w0 and s < w1)


def idle_intervals(rec) -> list:
    """The window less the union of its device activity."""
    out, end = [], rec.window[0]
    for s, e in union((s, e) for _, s, e in rec.device):
        if s > end:
            out.append([end, s])
        end = max(end, e)
    if rec.window[1] > end:
        out.append([end, rec.window[1]])
    return out


def host_ms_per_unit(rec, names):
    """Host ms per unit in the union of the spans named `names`."""
    spans = span_union(rec, names)
    if not spans or not rec.units:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / rec.units


def idle_pct_in(rec, names):
    """The share of the window, in %, in which no device activity ran while
    the host was inside a span named `names`."""
    spans = span_union(rec, names)
    if not spans or rec.window_s <= 0:
        return None
    return 100.0 * overlap_ns(idle_intervals(rec), spans) * 1e-9 / rec.window_s


def count_per_unit(rec, names):
    """The spans named `names` that start in the window, per unit."""
    w0, w1 = rec.window
    n = sum(1 for name, s, _ in rec.spans if name in names and w0 <= s < w1)
    return n / rec.units if n and rec.units else None


# name: (reading, the spans it reads).  A name's suffix is its cell's kind.
READINGS = {
    "seed_ms_per_frame.render": (host_ms_per_unit, ("hpt.rng.seed",)),
    "seed_idle_pct.render": (idle_pct_in, ("hpt.rng.seed",)),
    "step_idle_pct.render": (idle_pct_in, ("hpt.render.step",)),
    "pack_ms_per_frame.render": (host_ms_per_unit, ("hpt.camera.rays", "hpt.nee.tables")),
    "forward_ms_per_step.train": (host_ms_per_unit, ("hpt.grad.forward",)),
    "backward_ms_per_step.train": (host_ms_per_unit, ("hpt.grad.backward",)),
    "forward_idle_pct.train": (idle_pct_in, ("hpt.grad.forward",)),
    "host_reads_per_step.train": (count_per_unit, ("hpt.host_read",)),
}


def readings(rec, workload: str) -> dict:
    """The readings of the cell's kind (its name's suffix) on `rec`."""
    kind = workload.rpartition(".")[2]
    return {name: fn(rec, names) for name, (fn, names) in READINGS.items()
            if name.endswith("." + kind)}


def idle_by_span(rec) -> dict:
    """Idle seconds of the window by the innermost span the host was in at
    each gap's middle (`trace.breakdown`'s label), largest first."""
    inner = [sp for sp in rec.spans if sp[0] != trace.WINDOW]
    out = {}
    for a, b in idle_intervals(rec):
        mid = (a + b) // 2
        hold = [sp for sp in inner if sp[1] <= mid <= sp[2]]
        label = min(hold, key=lambda sp: sp[2] - sp[1])[0] if hold else "outside the spans"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_by_span(rec) -> dict:
    """{name: [spans that start in the window, host seconds in their union
    clipped to it]} for every span but the window's, longest first."""
    w0, w1 = rec.window
    names = {n for n, _, _ in rec.spans if n != trace.WINDOW}
    out = {n: [sum(1 for m, s, _ in rec.spans if m == n and w0 <= s < w1),
               sum(e - s for s, e in span_union(rec, (n,))) * 1e-9] for n in names}
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def traced(bench: dict, workload: str, seed: int, seconds: float, device,
           overrides: dict | None = None) -> dict:
    """One traced run of the cell with the program's spans kept: the
    result's line, with "spans" = {"readings", "idle_s_by_span",
    "host_by_span"}."""
    from ptbench import harness

    kept = []

    def keep(prof):
        kept.append(collect(prof))
        return kept[-1]

    original, trace.collect = trace.collect, keep
    try:
        line = harness.run(bench, workload, seed, seconds, True, device, time.perf_counter(),
                           overrides)
    finally:
        trace.collect = original
    window, spans, events = kept[0]
    rec = trace.Record(window=window, spans=spans, device=events, units=line["attempted"])
    line["spans"] = {"readings": readings(rec, workload), "idle_s_by_span": idle_by_span(rec),
                     "host_by_span": host_by_span(rec)}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=40.0)
    args = parser.parse_args(argv)
    import torch

    from ptbench import harness

    if not torch.cuda.is_available():
        print("ptbench: the spans' readings need a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    print(json.dumps(traced(bench, args.workload, args.seed, args.seconds, "cuda:0")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
