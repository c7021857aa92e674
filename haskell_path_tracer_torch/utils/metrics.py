"""Structured metrics and per-phase timing.

Counterpart of ``haskell_path_tracer_tpu/utils/metrics.py``: a rays/s
counter, per-phase wall times and one-line JSON records, with the optional
trace on `torch.profiler`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class RenderMetrics:
    width: int = 0
    height: int = 0
    bounces: int = 0
    samples: int = 0
    wall_seconds: float = 0.0
    dispatches: int = 0
    phase_seconds: dict = field(default_factory=dict)

    @property
    def ray_segments(self) -> int:
        return self.width * self.height * self.samples * self.bounces

    @property
    def rays_per_second(self) -> float:
        return self.ray_segments / self.wall_seconds if self.wall_seconds else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "resolution": f"{self.width}x{self.height}",
                "spp": self.samples,
                "bounces": self.bounces,
                "wall_s": round(self.wall_seconds, 4),
                "dispatches": self.dispatches,
                "rays_per_s": round(self.rays_per_second),
                "phases": {
                    k: round(v, 4) for k, v in self.phase_seconds.items()
                },
            }
        )

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + dt


def log(event: str, stream=None, **fields) -> None:
    """One structured log line: {"event": ..., "t": ..., **fields}, on
    `stream` (the current sys.stderr by default)."""
    rec = {"event": event, "t": round(time.time(), 3)}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr if stream is None else stream, flush=True)


@contextmanager
def profiler_trace(log_dir: str | None):
    """Optional `torch.profiler` trace of the region (CPU, and CUDA when a
    GPU is present), written as a Chrome trace into `log_dir`."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
