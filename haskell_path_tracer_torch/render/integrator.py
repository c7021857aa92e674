"""Integrators: the inline bounce loop.

Counterpart of ``haskell_path_tracer_tpu/render/integrator.py`` (the
reference's `render Inline` / `traceInline`).  Per pixel the loop carries
(ray, rng, result, throughput).  Per bounce:

  * dead lanes — near-zero throughput or a miss — zero their throughput
    and keep their ray, rng and result;
  * live lanes: result += emittance * throughput; throughput *= the BRDF
    modifier; the ray is the sampled bounce; the rng advances by 3 draws.

Optional Russian roulette takes a 4th draw per bounce.

`render_batch_inline` runs that loop as plain tensor ops, one sample at a
time; `render_batch_fused` runs all `spp` samples in one call of the
megakernel (`ops/megakernel.py`), which launches the CUDA kernel on CUDA
tensors.
"""

from __future__ import annotations

import torch

from ..core import linalg
from ..models.camera import primary_rays
from ..models.objects import Accumulator, Camera, Rays, Scene
from ..ops import brdf as brdf_ops
from ..ops import rng as rng_ops
from ..ops.intersect import nearest_hit
from ..ops.megakernel import trace_inline_fused

DEFAULT_BOUNCES = 15  # the reference's maxIterations / Inline limit


def trace_inline(
    scene: Scene,
    rays: Rays,
    rng_state: torch.Tensor,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    rr_start: int = 3,
):
    """Trace one sample per ray to completion.  Returns (radiance [..., 3],
    final rng_state)."""
    ray_o, ray_d, rng = rays.origin, rays.direction, rng_state
    result = torch.zeros_like(ray_o)
    throughput = torch.ones_like(ray_o)
    for i in range(num_bounces):
        hit = nearest_hit(ray_o, ray_d, scene)
        dead = linalg.near_zero(throughput) | ~hit.hit

        next_o, next_d, tmod, rng2 = brdf_ops.sample(hit, ray_d, rng)
        new_result = result + brdf_ops.emittance(hit) * throughput
        new_throughput = throughput * tmod

        if russian_roulette:
            # Survival probability = max throughput channel (clamped);
            # survivors are scaled by 1/p to stay unbiased.
            u, rng2 = rng_ops.sfc32_float(rng2)
            p_survive = torch.clamp(new_throughput.amax(dim=-1), 0.05, 1.0)
            if i >= rr_start:
                killed = u >= p_survive
                new_throughput = torch.where(
                    killed[..., None],
                    0.0,
                    new_throughput * (1.0 / p_survive)[..., None],
                )

        d3 = dead[..., None]
        ray_o = torch.where(d3, ray_o, next_o)
        ray_d = torch.where(d3, ray_d, next_d)
        rng = torch.where(d3, rng, rng2)
        result = torch.where(d3, result, new_result)
        throughput = torch.where(d3, 0.0, new_throughput)
    return result, rng


def render_sample_inline(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
) -> Accumulator:
    """One progressive sample: trace every pixel once and fold it into the
    accumulator."""
    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_inline(
        scene, rays, acc.rng, num_bounces, russian_roulette
    )
    return Accumulator(
        color=acc.color + radiance, rng=rng_out, iterations=acc.iterations + 1
    )


def render_batch_inline(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
) -> Accumulator:
    """`spp` samples with the plain tensor-op loop."""
    for _ in range(spp):
        acc = render_sample_inline(
            scene, camera, acc, num_bounces, russian_roulette,
            row_offset, full_height,
        )
    return acc


def render_batch_fused(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
    has_dielectric: bool | None = None,
) -> Accumulator:
    """`spp` samples in one megakernel call: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors.  Same semantics as
    `render_batch_inline`; radiance can differ in rare lanes where a
    transcendental's last bit flips a discrete bounce decision."""
    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_inline_fused(
        scene, rays, acc.rng, num_bounces=num_bounces, spp=spp,
        russian_roulette=russian_roulette, has_dielectric=has_dielectric,
    )
    return Accumulator(
        color=acc.color + radiance, rng=rng_out, iterations=acc.iterations + spp
    )


def render_batch_auto(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
    has_dielectric: bool | None = None,
) -> Accumulator:
    """The CUDA megakernel exactly when the accumulator lives on a CUDA
    device, the plain tensor-op loop otherwise."""
    if acc.color.is_cuda:
        return render_batch_fused(
            scene, camera, acc, spp, num_bounces, russian_roulette,
            row_offset, full_height, has_dielectric=has_dielectric,
        )
    return render_batch_inline(
        scene, camera, acc, spp, num_bounces, russian_roulette,
        row_offset, full_height,
    )


def make_accumulator(
    width: int, height: int, seed: int | None, device
) -> Accumulator:
    """Zeroed accumulator with host-seeded SFC32 states on `device`."""
    return Accumulator(
        color=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        rng=rng_ops.gen_seeds((height, width), seed, device),
        iterations=0,
    )

