"""Lower bounds on the work of the port's kernels, one module per kernel.

A module names the CUDA function it counts (`MATCH`, a regular expression
over the profiler's kernel names) and gives `work(inputs, launches)`: the
fp32 operations and bytes of one unit of the cell's traffic (a frame, a
step), from the cell's inputs alone (`WorkInputs`) and the launches of the
kernel per unit that the trace counted.  None reads the program's
counters or telemetry.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class WorkInputs:
    counts: tuple          # (spheres, planes)
    lights: int            # emissive spheres
    pixels: int            # pixels per launch
    hits: int              # pixels whose primary ray hits
    spp: int               # samples per pixel in one unit
    hit_mix: dict = field(default_factory=dict)  # {(kind, brdf): hit pixels}
