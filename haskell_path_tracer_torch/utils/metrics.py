"""Structured metrics, per-phase timing and the port's trace spans.

Counterpart of ``haskell_path_tracer_tpu/utils/metrics.py``: a rays/s
counter, per-phase wall times and one-line JSON records, with the optional
trace on `torch.profiler`.

`span(name)` marks a region of the port's host work in a `torch.profiler`
trace, on the profiler's own clock, beside the device activity it launches.
Every span the port opens starts with "hpt.":

    hpt.rng.seed          a batch's rng states made (`ops/rng.py:gen_seeds`,
                          `render/nee.py:stateless_states`), upload included
    hpt.render.step       one step of the Renderer's schedule
    hpt.camera.rays       the primary rays (`models/camera.py:primary_rays`)
    hpt.nee.tables        the NEE kernels' tables packed (`ops/nee.py`)
    hpt.nee.presort       the primary probe and its argsort
    hpt.launch.<kernel>   the host's call into a kernel's library, which
                          blocks when the launch queue is full
    hpt.grad.forward      `diff/grad.py:loss_and_grad`'s forward and loss
    hpt.grad.backward     its `torch.autograd.grad`
    hpt.host_read         a device-to-host read (`host_read`): one span per
                          read, its length the wait for the device
    hpt.cli.<phase>       a `RenderMetrics.phase` of the CLI

A span nests in the span of the call that caused it.  The spans are
function-scoped record functions, not `torch.profiler.record_function`'s
user-scoped ones: the profiler mirrors a user-scoped span onto the device's
timeline, where a reader of the trace would count it as device activity.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch


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
        """Adds the region's wall time to `phase_seconds[name]`, inside
        span "hpt.cli.<name>"."""
        with span("hpt.cli." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + dt


_NO_SPAN = nullcontext()


def span(name: str):
    """A profiler span named `name` while a `torch.profiler` records (the
    autograd engine's threads included), else one shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def host_read(t: torch.Tensor):
    """`t` as a numpy array on the host, in span "hpt.host_read": from a
    CUDA device the read waits for the work queued before it."""
    with span("hpt.host_read"):
        return t.cpu().numpy()


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
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
