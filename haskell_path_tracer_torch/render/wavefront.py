"""The wavefront integrator, and deterministic dielectric splitting.

Counterpart of ``haskell_path_tracer_tpu/render/wavefront.py`` (the
reference's `Streams` algorithm).  Lane i is pixel i throughout, so
radiance accumulates per lane and the rng writes back positionally:

  * `render_sample_wavefront` runs the bounce loop over the whole queue of
    primary rays, one `nearest_hit` per bounce, with the inline
    integrator's death rule, so on split-free scenes it equals the inline
    integrator, rng and radiance.  It runs every one of `num_bounces`
    bounces, where the JAX package's loop stops once the live count is 0:
    a dead lane stays dead, so the result and the occupancy are the same,
    and on a CUDA device no bounce waits for a count on the host.  Above
    CHUNKED_THRESHOLD primitives `nearest_hit` on CUDA tensors is the
    nearest-sphere kernel (``ops/sphere_fold.py``), once per bounce;
  * `render_sample_wavefront_split` splits every glass hit into both
    Fresnel branches: the lane continues as the reflection (weight F) and
    pushes the refraction (weight 1 - F) on its own stack of
    round(queue_factor) slots (children beyond it are dropped, which only
    removes energy), then walks the split tree depth first;
  * `render_batch_split_auto` is the splitting integrator's entry point:
    the CUDA kernel of ``ops/split.py`` (one launch per batch) on CUDA
    tensors, this module's tensor loop elsewhere.

`WavefrontStats.occupancy[b]` counts the rays that enter bounce b (the
segments processed at depth b, with splitting); `depth_histogram` turns it
into path depths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import linalg
from ..models.camera import primary_rays
from ..models.objects import BRDF_DIELECTRIC, Accumulator, Camera, Scene
from ..ops import brdf as brdf_ops
from ..ops import rng as rng_ops
from ..ops.intersect import EPSILON, nearest_hit
from ..ops.split import clamp_stack_depth, trace_split_fused


class WavefrontStats(NamedTuple):
    """Per-bounce telemetry: `occupancy[b]` rays entered bounce b (the last
    entry: still alive after the last bounce); `capacity` is the lanes a
    bounce could hold, pixels, or pixels x steps with splitting."""

    occupancy: torch.Tensor  # [num_bounces + 1] int32
    capacity: int


def depth_histogram(stats: WavefrontStats) -> torch.Tensor:
    """Entry b counts the rays whose path shaded exactly b bounces (those
    that died during bounce b); the last entry counts the rays alive at
    the bounce cap.  Sums to occupancy[0]."""
    occ = stats.occupancy
    return torch.cat([occ[:-1] - occ[1:], occ[-1:]])


def _stack_slots(num_bounces: int, queue_factor: float) -> int:
    # Python's round: halves go to the even neighbour, as in the JAX package.
    return clamp_stack_depth(num_bounces, int(round(queue_factor)))


def render_sample_wavefront(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = 15,
    russian_roulette: bool = False,
    rr_start: int = 3,
    return_stats: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
):
    """One progressive sample through the wavefront queue; with
    `return_stats` also its `WavefrontStats`."""
    height, width = acc.color.shape[:2]
    n = height * width
    rays = primary_rays(camera, width, height, row_offset, full_height)
    ray_o, ray_d = rays.origin.reshape(n, 3), rays.direction.reshape(n, 3)
    throughput = torch.ones_like(ray_o)
    accum = torch.zeros_like(ray_o)
    rng = acc.rng.reshape(n, 4)
    counts = [torch.tensor(n, dtype=torch.int32, device=ray_o.device)]
    for bounce in range(num_bounces):
        hit = nearest_hit(ray_o, ray_d, scene)
        # The death test reads the stored throughput, before emission.
        alive = hit.hit & ~linalg.near_zero(throughput)
        a3 = alive[..., None]
        accum = torch.where(a3, accum + brdf_ops.emittance(hit) * throughput, accum)
        next_o, next_d, tmod, rng2 = brdf_ops.sample(hit, ray_d, rng)
        new_thpt = throughput * tmod
        if russian_roulette:
            u, rng2 = rng_ops.sfc32_float(rng2)
            p_survive = torch.clamp(new_thpt.amax(dim=-1), 0.05, 1.0)
            if bounce >= rr_start:
                killed = u >= p_survive
                new_thpt = torch.where(killed[..., None], 0.0, new_thpt * (1.0 / p_survive)[..., None])
        ray_o = torch.where(a3, next_o, ray_o)
        ray_d = torch.where(a3, next_d, ray_d)
        throughput = torch.where(a3, new_thpt, 0.0)
        rng = torch.where(a3, rng2, rng)
        counts.append(alive.sum(dtype=torch.int32))
    out = Accumulator(
        color=acc.color + accum.reshape(height, width, 3),
        rng=rng.reshape(height, width, 4),
        iterations=acc.iterations + 1,
    )
    if return_stats:
        return out, WavefrontStats(occupancy=torch.stack(counts), capacity=n)
    return out


def render_sample_wavefront_split(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = 15,
    queue_factor: float = 2.0,
    return_stats: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
):
    """One progressive sample with deterministic dielectric splitting, the
    XLA path's functions (`nearest_hit`, `brdf_ops.sample`,
    `brdf_ops.dielectric_split`) on [P, 3] lanes.  Every alive segment
    draws three uniforms (a glass lane's are discarded); at most
    num_bounces x (1 + slots) steps, ending early (on the CPU) once every
    lane is done.  With `return_stats` the occupancy counts the segments
    processed at each depth, children included."""
    height, width = acc.color.shape[:2]
    n = height * width
    slots = _stack_slots(num_bounces, queue_factor)
    max_steps = num_bounces * (1 + slots)
    rays = primary_rays(camera, width, height, row_offset, full_height)
    ray_o, ray_d = rays.origin.reshape(n, 3), rays.direction.reshape(n, 3)
    dev = ray_o.device
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    throughput = torch.ones_like(ray_o)
    accum = torch.zeros_like(ray_o)
    rng = acc.rng.reshape(n, 4)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    sp = torch.zeros(n, dtype=torch.int32, device=dev)
    stk_o = torch.zeros((slots, n, 3), device=dev)
    stk_d = torch.zeros((slots, n, 3), device=dev)
    stk_t = torch.zeros((slots, n, 3), device=dev)
    stk_depth = torch.zeros((slots, n), dtype=torch.int32, device=dev)
    occupancy = torch.zeros(num_bounces + 1, dtype=torch.int64, device=dev)
    for _ in range(max_steps):
        # A lane with no segment and no child stays so; on a CUDA device
        # the loop runs on rather than wait for this count.
        if not live.is_cuda and not live.any():
            break
        hit = nearest_hit(ray_o, ray_d, scene)
        alive = live & hit.hit & ~linalg.near_zero(throughput) & (depth < num_bounces)
        a3 = alive[..., None]
        if return_stats:
            occupancy += torch.bincount(depth[alive].long(), minlength=num_bounces + 1)
        accum = torch.where(a3, accum + brdf_ops.emittance(hit) * throughput, accum)

        next_o, next_d, tmod, rng2 = brdf_ops.sample(hit, ray_d, rng)
        is_diel = alive & (hit.brdf_kind == BRDF_DIELECTRIC)
        refl_dir, refr_dir, f_refl = brdf_ops.dielectric_split(ray_d, hit.normal, hit.brdf_param)
        # This lane continues as the reflection, weight F.
        d3 = is_diel[..., None]
        next_d = torch.where(d3, refl_dir, next_d)
        next_o = torch.where(d3, hit.point + refl_dir * EPSILON, next_o)
        tmod = torch.where(d3, hit.color * f_refl[..., None], tmod)
        new_thpt = throughput * tmod

        # The refraction child, weight 1 - F: pushed unless under total
        # internal reflection, negligible, out of bounces or out of slots.
        child_thpt = throughput * hit.color * (1.0 - f_refl)[..., None]
        push = (is_diel & (f_refl < 1.0) & ~linalg.near_zero(child_thpt)
                & (depth + 1 < num_bounces) & (sp < slots))
        child_o = hit.point + refr_dir * EPSILON
        for slot in range(slots):
            w = push & (sp == slot)
            w3 = w[..., None]
            stk_o[slot] = torch.where(w3, child_o, stk_o[slot])
            stk_d[slot] = torch.where(w3, refr_dir, stk_d[slot])
            stk_t[slot] = torch.where(w3, child_thpt, stk_t[slot])
            stk_depth[slot] = torch.where(w, depth + 1, stk_depth[slot])
        sp = torch.where(push, sp + 1, sp)

        ray_o = torch.where(a3, next_o, ray_o)
        ray_d = torch.where(a3, next_d, ray_d)
        depth = torch.where(alive, depth + 1, depth)
        throughput = torch.where(a3, new_thpt, 0.0)
        rng = torch.where(a3, rng2, rng)

        # A lane whose segment died resumes with its deepest pending child.
        pop = live & ~alive & (sp > 0)
        top = (sp - 1).clamp(min=0).long()
        lanes = torch.arange(n, device=dev)
        p3 = pop[..., None]
        ray_o = torch.where(p3, stk_o[top, lanes], ray_o)
        ray_d = torch.where(p3, stk_d[top, lanes], ray_d)
        throughput = torch.where(p3, stk_t[top, lanes], throughput)
        depth = torch.where(pop, stk_depth[top, lanes], depth)
        sp = torch.where(pop, sp - 1, sp)
        live = alive | pop

    out = Accumulator(
        color=acc.color + accum.reshape(height, width, 3),
        rng=rng.reshape(height, width, 4),
        iterations=acc.iterations + 1,
    )
    if return_stats:
        return out, WavefrontStats(occupancy=occupancy.to(torch.int32), capacity=n * max_steps)
    return out


def _batch(sample, acc: Accumulator, spp: int, num_bounces: int, return_stats: bool,
           capacity_per_pixel: int):
    """`spp` calls of `sample(acc, return_stats)`; with `return_stats` the
    occupancy summed over them."""
    occ = torch.zeros(num_bounces + 1, dtype=torch.int32, device=acc.color.device)
    for _ in range(spp):
        acc = sample(acc, return_stats)
        if return_stats:
            acc, stats = acc
            occ = occ + stats.occupancy
    if not return_stats:
        return acc
    h, w = acc.color.shape[:2]
    return acc, WavefrontStats(occupancy=occ, capacity=h * w * capacity_per_pixel)


def render_batch_wavefront(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 15,
    russian_roulette: bool = False,
    return_stats: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
):
    """`spp` wavefront samples; with `return_stats` the occupancy summed
    over them (capacity: the pixels)."""
    return _batch(
        lambda a, stats: render_sample_wavefront(
            scene, camera, a, num_bounces, russian_roulette, return_stats=stats,
            row_offset=row_offset, full_height=full_height),
        acc, spp, num_bounces, return_stats, 1)


def render_batch_wavefront_split(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 15,
    queue_factor: float = 2.0,
    return_stats: bool = False,
    row_offset: int = 0,
    full_height: int | None = None,
):
    """`spp` deterministic-splitting samples with the tensor loop; with
    `return_stats` the occupancy (children included) summed over them
    (capacity: pixels x steps)."""
    return _batch(
        lambda a, stats: render_sample_wavefront_split(
            scene, camera, a, num_bounces, queue_factor, return_stats=stats,
            row_offset=row_offset, full_height=full_height),
        acc, spp, num_bounces, return_stats,
        num_bounces * (1 + _stack_slots(num_bounces, queue_factor)))


def render_batch_split_auto(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 15,
    queue_factor: float = 2.0,
    kernel: str = "auto",
    row_offset: int = 0,
    full_height: int | None = None,
) -> Accumulator:
    """`spp` deterministic-splitting samples.  `kernel="auto"` launches the
    CUDA kernel (`ops/split.py:trace_split_fused`, one launch) exactly when
    the accumulator lives on a CUDA device and runs
    `render_batch_wavefront_split` elsewhere; "cuda" launches the kernel
    and raises off the GPU; "torch" runs the tensor loop.  The same
    estimator either way: the stack has round(queue_factor) slots."""
    if kernel not in ("auto", "torch", "cuda"):
        raise ValueError(f"kernel must be 'auto', 'torch' or 'cuda', not {kernel!r}")
    on_cuda = acc.color.is_cuda
    if kernel == "cuda" and not on_cuda:
        raise ValueError(f"kernel='cuda' needs CUDA tensors; the accumulator is on {acc.color.device}")
    if kernel == "torch" or not on_cuda:
        return render_batch_wavefront_split(scene, camera, acc, spp, num_bounces, queue_factor,
                                            row_offset=row_offset, full_height=full_height)
    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_split_fused(scene, rays, acc.rng, num_bounces, spp, round(queue_factor))
    return Accumulator(color=acc.color + radiance, rng=rng_out, iterations=acc.iterations + spp)
