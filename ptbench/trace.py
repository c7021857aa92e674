"""The traced run's records, read from `torch.profiler` in memory.

`collect` takes the profiler's events: the benchmark's own spans (CPU
`record_function` labels that start with "ptbench.") and every device
activity (kernels, copies, sets), clipped to the traced span (the start
of the measured window).  The
per-layer readers (`ptbench/metrics/*.py`) take a `Record`; `breakdown`
gives the line's device operations and idle gaps.  The events stay in
memory: a traced run writes nothing to disk.
"""

from __future__ import annotations

import importlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

from .work import WorkInputs
from .work import peaks

WINDOW = "ptbench.traced"
UNIT = "ptbench.unit"
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Record:
    window: tuple                     # (start ns, end ns) of the traced span
    spans: list                       # [(name, start ns, end ns)]
    device: list                      # [(name, start ns, end ns)], clipped to the window
    units: int                        # units completed in the traced span
    kernels: list = field(default_factory=list)   # the cell's work modules, main first
    work: WorkInputs | None = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def span_seconds(self, name: str) -> list:
        return [(e - s) * 1e-9 for n, s, e in self.spans if n == name]

    def kernel_events(self) -> list:
        return [ev for ev in self.device if not ev[0].startswith(NOT_KERNELS)]

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        total, end = 0, None
        for _, s, e in sorted(self.device, key=lambda ev: ev[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def matched(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [ev for ev in self.kernel_events() if rx.search(ev[0])]

    def work_of(self, module: str):
        """(ops, bytes, seconds on the device) of a work module's kernel over
        the window, or None where the trace holds no launch of it."""
        mod = importlib.import_module(f"ptbench.work.{module}")
        events = self.matched(mod.MATCH)
        if not events or not self.units or self.work is None:
            return None
        ops, nbytes = mod.work(self.work, len(events) / self.units)
        return ops * self.units, nbytes * self.units, sum(e - s for _, s, e in events) * 1e-9


def roofline_pct(rec: Record):
    """The cell's main kernel's share of its roofline, in %."""
    got = rec.work_of(rec.kernels[0]) if rec.kernels else None
    if got is None or got[2] <= 0:
        return None
    ops, nbytes, seconds = got
    return 100.0 * peaks.bound_s(nbytes, ops) / seconds


def step_mfu_pct(rec: Record):
    """The counted fp32 operations of all the cell's kernels over the window,
    as a share of the chip's fp32 peak, in %."""
    works = [rec.work_of(m) for m in rec.kernels]
    works = [w for w in works if w is not None]
    if not works or rec.window_s <= 0:
        return None
    return 100.0 * sum(w[0] for w in works) / (rec.window_s * peaks.PEAK_FP32_PER_S)


def per_unit(values: list):
    return sum(values) / len(values) * 1e3 if values else None


def collect(prof) -> tuple:
    """(window, spans, device events) from a finished profiler."""
    spans, device = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        start = e.start_ns()
        end = start + e.duration_ns()
        if kind.endswith("CPU"):
            if e.name().startswith("ptbench."):
                spans.append((e.name(), start, end))
        elif kind.endswith("CUDA") and not e.name().startswith("ptbench."):
            # (The profiler mirrors each span on the device's timeline.)
            device.append((e.name(), start, end))
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0]
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    return (w0, w1), spans, device


def breakdown(rec: Record) -> dict:
    """The 10 device operations that took most time, and the 10 longest idle
    gaps, each named by the innermost benchmark span the host was in."""
    by_name = defaultdict(int)
    for n, s, e in rec.device:
        by_name[n] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], rec.window[0]
    for _, s, e in sorted(rec.device, key=lambda ev: ev[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if rec.window[1] > end:
        gaps.append((end, rec.window[1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    inner = [sp for sp in rec.spans if sp[0] not in (WINDOW,)]

    def label(a, b):
        mid = (a + b) // 2
        hold = [sp for sp in inner if sp[1] <= mid <= sp[2]]
        return min(hold, key=lambda sp: sp[2] - sp[1])[0] if hold else "outside the spans"

    return {"device_ops": [[n, t * 1e-9] for n, t in ops],
            "idle_gaps": [[label(a, b), (b - a) * 1e-9] for a, b in gaps]}
