"""What both loops share: the cell's context, seeds, spans, and the
program's scene and camera made from the benchmark's arrays.

The program is the PyTorch and CUDA port, `haskell_path_tracer_torch`; the
loops reach it only through its public entry points.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Context:
    """One run of one cell."""

    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    trace: bool
    arrays: dict
    state: dict = field(default_factory=dict)

    def span(self, name: str):
        """A `torch.profiler.record_function` span in a traced run."""
        if self.trace:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for the stream `keys` of the run's `seed`."""
    words = [seed % (1 << 64) & 0xFFFFFFFF, seed % (1 << 64) >> 32]
    words += [k if isinstance(k, int) else int.from_bytes(k.encode()[:8], "little")
              for k in keys]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return int(state[0]) | (int(state[1]) & 0x7FFFFFFF) << 32


def generator(ctx: Context, *keys) -> torch.Generator:
    g = torch.Generator(device=ctx.device)
    g.manual_seed(derive(ctx.seed, *keys))
    return g


def rng_states(ctx: Context, count: int, *keys) -> torch.Tensor:
    """`count` grids of SFC32 states int32 [count, H, W, 4], drawn on the
    device in one call."""
    h, w = ctx.config["height"], ctx.config["width"]
    words = torch.randint(-(1 << 31), 1 << 31, (count, h, w, 4), dtype=torch.int64,
                          device=ctx.device, generator=generator(ctx, *keys))
    return words.to(torch.int32)


def program_scene(arrays: dict, device):
    """The program's Scene of the arrays (its dataclasses, on `device`)."""
    from haskell_path_tracer_torch.models.objects import Materials, Planes, Scene, Spheres

    def t(key):
        return torch.as_tensor(arrays[key], device=device)

    def materials(prefix):
        return Materials(color=t(prefix + "_color"), illuminance=t(prefix + "_illum"),
                         brdf_kind=t(prefix + "_kind"), brdf_param=t(prefix + "_param"))

    return Scene(spheres=Spheres(pos=t("sphere_pos"), radius=t("sphere_radius"),
                                 material=materials("sphere")),
                 planes=Planes(pos=t("plane_pos"), normal=t("plane_normal"),
                               material=materials("plane")))


def program_camera(spec: dict, device):
    from haskell_path_tracer_torch.models.objects import Camera

    return Camera.create(spec["position"], spec["rotation"], spec["fov"], device)


def reference_rays(ctx: Context):
    """The camera's primary rays by the reference, flat [H * W, 3]."""
    from ..reference import core as C

    cam = ctx.config["camera"]
    f32 = dict(dtype=torch.float32, device=ctx.device)
    o, d = C.primary_rays(torch.tensor(cam["position"], **f32),
                          torch.tensor(cam["rotation"], **f32),
                          torch.tensor(cam["fov"], **f32), ctx.config["width"],
                          ctx.config["height"])
    return o.reshape(-1, 3), d.reshape(-1, 3)


def free_device_memory(ctx: Context) -> None:
    """Drop what the program kept, before the reference runs."""
    import gc

    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()
