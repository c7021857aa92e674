"""The differentiable inline parity trace: the forward megakernel and a
backward kernel, bound into a `torch.autograd.Function`.

Replaces ``haskell_path_tracer_tpu/ops/pallas_megakernel_vjp.py`` — its
custom VJP (`_make_diff_fn`, `trace_inline_pallas_diff`) and the backward
kernel `_bwd_kernel` (launched by `_bwd_call`).  `TraceInlineFusedDiff`'s
forward is the forward kernel of ``ops/megakernel.py`` (`launch_kernel`,
Russian roulette off); its backward is `launch_backward`, the hand-written
CUDA kernel in ``csrc/megakernel_vjp.cu``, which replays each sample's
bounces and sweeps them in reverse with every decision detached.  On CPU
tensors `trace_inline_fused_diff` runs the plain version,
`ops/megakernel.py:trace_tables_reference`, under autograd, and
`backward_reference` is the plain version of the backward kernel.

Two modes, chosen by size.  With more than one sample, and rng states (16 B
per pixel and sample) that fit half the free device memory, the forward is
the recording instance, which also writes every pixel's rng at the start of
every sample, and the backward runs one thread per (pixel, sample) from
those states; otherwise the forward records nothing and the backward runs
one thread per pixel, which replays the samples in turn.  Both take the
same decisions and sum the same terms.

Gradients: the packed tables (geom [P, 8|16], mat [P, 8]; autograd maps
them back to the scene's leaves through `scene_tables`) and the primary
rays.  The rng is a constant of the gradient: `rng_out` is not
differentiable.

Tolerance against the plain version: a scale-normalised error
``max|a - b| / (max|b| + 1e-6)`` below 1e-2 for the ray cotangents and
for each column of the table cotangents' sphere and plane rows, 2e-2 for
the columns of the box and triangle rows (tests/test_pallas_vjp.py's
bounds, taken per column so that brdf_param is not measured against the
far larger illuminance cotangents).  The
kernel sums the table cotangents (and, per sample, the ray cotangents)
with atomics in an order that changes from run to run, and its
transcendentals round differently from PyTorch's, which can flip a
knife-edge decision in a rare lane; grazing lanes amplify a last-bit
difference in the forward into a larger one in the gradient.

The kernel is bound by fp32 ALU and SFU work: the replay repeats the
forward bounce and the adjoint costs about twice that again, while the
memory traffic is 52 B read and 24 B written per pixel, and 16 B read per
pixel and sample in the per-sample mode (see the note at the top of the
CUDA source).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..models.objects import Rays, Scene
from ..utils.metrics import span
from . import megakernel as MK

SOURCE = os.path.join(MK.CSRC, "megakernel_vjp.cu")
# What the C entry point returns when num_bounces exceeds the replay's
# residual array (kMaxBounces in the CUDA source).
_CUDA_ERROR_INVALID_VALUE = 1

# Launches of the backward kernel by `launch_backward`: LAUNCHES counts
# every launch, SAMPLE_LAUNCHES those with one thread per (pixel, sample)
# among them.  Callers reset them to 0 to count the launches of a run.
LAUNCHES = 0
SAMPLE_LAUNCHES = 0
# Bytes of rng state per pixel and sample that the per-sample mode's
# forward records and its backward reads.
STATE_BYTES = 16

_lib = None


def library_path() -> str:
    return MK.library_file(SOURCE, "megakernel_vjp")


def build() -> str:
    """Compile csrc/megakernel_vjp.cu for sm_90a unless this source's
    library exists; returns its path.  Raises on a failed build."""
    return MK.build_library(SOURCE, "megakernel_vjp")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        for launch in (lib.hpt_megakernel_vjp_launch, lib.hpt_megakernel_vjp_samples_launch):
            launch.argtypes = [
                vp, i, vp, i, i, i, i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp,
            ]
            launch.restype = i
        lib.hpt_megakernel_vjp_resources.argtypes = [i, i, i, i, vp, vp]
        lib.hpt_megakernel_vjp_resources.restype = None
        _lib = lib
    return _lib


def _check_inputs(geom, mat, counts, rays, rng, g_rad, num_bounces, spp):
    device = rng.device
    H, W = rng.shape[:2]
    P = sum(counts)
    MK._check("rng", rng, torch.int32, (H, W, 4), device)
    MK._check("rays.origin", rays.origin, torch.float32, (H, W, 3), device)
    MK._check("rays.direction", rays.direction, torch.float32, (H, W, 3), device)
    MK._check("g_rad", g_rad, torch.float32, (H, W, 3), device)
    MK._check("geom", geom, torch.float32, (P, geom.shape[1]), device)
    MK._check("mat", mat, torch.float32, (P, 8), device)
    if geom.shape[1] not in (8, 16):
        raise ValueError(f"geom has {geom.shape[1]} columns, expected 8 or 16")
    if min(spp, num_bounces) < 0:
        raise ValueError("spp and num_bounces must be >= 0")


def kernel_resources(geom, counts, has_dielectric=False, per_sample=False) -> dict:
    """What the card gives the backward kernel's instance that a launch on
    these tables takes (`ops/megakernel.py:resources`)."""
    return MK.resources(_library().hpt_megakernel_vjp_resources, geom.shape[1],
                        sum(counts), int(has_dielectric), int(per_sample))


def free_device_bytes(device) -> int:
    """Bytes a new tensor on `device` could take: the card's free memory and
    what PyTorch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def per_sample(rng, spp, free_bytes) -> bool:
    """Whether a gradient of `spp` samples on `rng`'s pixels takes one
    thread per (pixel, sample), given `free_bytes` of device memory: it has
    more than one sample, and their recorded states, held from the forward
    to the backward, take at most half of the free memory, which leaves the
    other half to the backward's outputs and the caller.  The share caps
    memory, not speed: above one sample the per-sample mode won at every
    shape measured, and at one sample, where the two kernels do the same
    work, one thread per pixel, which sums no samples, was 4.5% faster at
    3840x2160 / 1 / 4 (PERF.md)."""
    return spp > 1 and 2 * STATE_BYTES * rng.shape[0] * rng.shape[1] * spp <= free_bytes


def launch_backward(geom, mat, counts, rays, rng, g_rad, num_bounces, spp,
                    has_dielectric, rng_samples=None):
    """Launch the backward kernel: the cotangents (d_geom, d_mat, d_origin,
    d_direction) of the radiance sum's cotangent `g_rad` [H, W, 3], for the
    trace `launch_kernel` runs with Russian roulette off on the same
    operands.  With `rng_samples` [H, W, spp, 4] (the recording forward's,
    or `rng` itself at one sample) one thread per (pixel, sample) replays
    its sample from its recorded rng, counted in `SAMPLE_LAUNCHES` too;
    without, one thread per pixel replays them in turn from `rng`.  Checks
    every operand, allocates the outputs, launches on the current stream
    without synchronising and counts the launch in `LAUNCHES`."""
    global LAUNCHES, SAMPLE_LAUNCHES
    _check_inputs(geom, mat, counts, rays, rng, g_rad, num_bounces, spp)
    device = rng.device
    H, W = rng.shape[:2]
    if rng_samples is not None:
        MK._check("rng_samples", rng_samples, torch.int32, (H, W, spp, 4), device)
    d_geom = torch.zeros_like(geom)
    d_mat = torch.zeros_like(mat)
    # The per-sample kernel adds its ray cotangents, the per-pixel one writes them.
    alloc = torch.empty if rng_samples is None else torch.zeros
    d_origin = alloc((H, W, 3), dtype=torch.float32, device=device)
    d_direction = alloc((H, W, 3), dtype=torch.float32, device=device)
    lib = _library()
    launch = (lib.hpt_megakernel_vjp_launch if rng_samples is None
              else lib.hpt_megakernel_vjp_samples_launch)
    stream = torch.cuda.current_stream(device).cuda_stream
    with span("hpt.launch.megakernel_backward"):
        err = launch(
            geom.data_ptr(), geom.shape[1], mat.data_ptr(), *counts,
            rays.origin.data_ptr(), rays.direction.data_ptr(),
            (rng if rng_samples is None else rng_samples).data_ptr(),
            g_rad.data_ptr(), d_geom.data_ptr(), d_mat.data_ptr(),
            d_origin.data_ptr(), d_direction.data_ptr(),
            H * W, spp, num_bounces, int(has_dielectric), stream,
        )
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"megakernel_vjp refused num_bounces={num_bounces}: the replay "
            "keeps at most kMaxBounces bounces (csrc/megakernel_vjp.cu)"
        )
    if err != 0:
        raise RuntimeError(f"megakernel_vjp launch failed: cudaError {err}")
    LAUNCHES += 1
    SAMPLE_LAUNCHES += int(rng_samples is not None)
    return d_geom, d_mat, d_origin, d_direction


class TraceInlineFusedDiff(torch.autograd.Function):
    """(radiance sum [H, W, 3], rng_out [H, W, 4]) of `spp` samples, as
    differentiable functions of (geom, mat, origin, direction).  Forward:
    the forward kernel; backward: the backward kernel.  CUDA tensors only.

    In the per-sample mode (`per_sample`) the forward is the recording
    instance and the backward takes one thread per (pixel, sample)."""

    @staticmethod
    def forward(ctx, geom, mat, origin, direction, rng, counts, num_bounces,
                spp, has_dielectric, russian_roulette=False):
        if russian_roulette:
            raise ValueError("the differentiable trace runs without Russian roulette")
        rays = Rays(origin=origin, direction=direction)
        record = per_sample(rng, spp, free_device_bytes(rng.device))
        out = MK.launch_kernel(geom, mat, counts, rays, rng, num_bounces, spp,
                               False, 3, has_dielectric, record=record)
        radiance, rng_out = out[:2]
        samples = out[2] if record else None
        ctx.save_for_backward(geom, mat, origin, direction, rng, samples)
        ctx.config = (counts, num_bounces, spp, has_dielectric)
        ctx.mark_non_differentiable(rng_out)
        return radiance, rng_out

    @staticmethod
    def backward(ctx, g_rad, _g_rng):
        geom, mat, origin, direction, rng, samples = ctx.saved_tensors
        counts, num_bounces, spp, has_dielectric = ctx.config
        d_geom, d_mat, d_origin, d_direction = launch_backward(
            geom, mat, counts, Rays(origin=origin, direction=direction), rng,
            g_rad.contiguous(), num_bounces, spp, has_dielectric, samples,
        )
        return d_geom, d_mat, d_origin, d_direction, None, None, None, None, None, None


def trace_inline_fused_diff(
    scene: Scene,
    rays: Rays,
    rng: torch.Tensor,
    num_bounces: int = 4,
    spp: int = 1,
    has_dielectric: bool | None = None,
):
    """Differentiable fused trace: (radiance sum [H, W, 3], rng_out
    [H, W, 4]) with gradients to every continuous scene leaf (through the
    table packing) and to the primary rays; the rng is a constant.

    CUDA tensors go through `TraceInlineFusedDiff` (one launch of each
    kernel per forward and backward), or, where no gradient can follow,
    launch the forward kernel alone (it records nothing); CPU tensors run
    the plain version under autograd.  `has_dielectric=None` reads the
    scene's kinds."""
    has_dielectric = MK._resolve_has_dielectric(scene, has_dielectric)
    geom, mat = MK.scene_tables(scene)
    counts = MK.primitive_counts(scene)
    if rng.is_cuda:
        origin, direction = rays.origin.contiguous(), rays.direction.contiguous()
        if not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (geom, mat, origin, direction))):
            return MK.launch_kernel(geom, mat, counts, Rays(origin=origin, direction=direction),
                                    rng, num_bounces, spp, False, 3, has_dielectric)
        return TraceInlineFusedDiff.apply(
            geom, mat, origin, direction, rng, counts, num_bounces, spp, has_dielectric,
        )
    return MK.trace_tables_reference(
        geom, mat, counts, rays, rng, num_bounces, spp, False, 3,
        has_dielectric,
    )


def backward_reference(geom, mat, counts, rays, rng, g_rad, num_bounces,
                       spp, has_dielectric):
    """Plain version of the backward kernel: (d_geom, d_mat, d_origin,
    d_direction), the cotangents of `g_rad` through
    `trace_tables_reference`, by `torch.autograd.grad`.

    The radiance is a sum over samples, and each sample starts from the
    rng the one before it left, so the samples are differentiated one at a
    time and their cotangents summed: autograd then holds one sample's
    bounces (some 500 B per pixel per bounce) instead of all of them."""
    leaves = [t.detach().requires_grad_() for t in
              (geom, mat, rays.origin, rays.direction)]
    total = [torch.zeros_like(t) for t in leaves]
    for _ in range(spp):
        with torch.enable_grad():
            radiance, rng = MK.trace_tables_reference(
                leaves[0], leaves[1], counts,
                Rays(origin=leaves[2], direction=leaves[3]), rng,
                num_bounces, 1, False, 3, has_dielectric,
            )
            grads = torch.autograd.grad(radiance, leaves, g_rad, allow_unused=True)
        for acc, g in zip(total, grads):
            if g is not None:
                acc += g
    return tuple(total)
