"""Deterministic dielectric splitting in one launch: every sample's split
tree of a pixel, walked depth first on a per-lane stack.

Replaces ``haskell_path_tracer_tpu/ops/pallas_split.py:_split_kernel_body``
(launched there by ``trace_split_pallas``).  On CUDA tensors
`trace_split_fused` launches the hand-written CUDA kernel in
``csrc/split.cu`` (its per-pixel code in ``csrc/split.cuh``); on CPU
tensors it runs the plain PyTorch version, `trace_split_reference`, which
follows the TPU kernel's lockstep traversal step for step on the packed
tables of ``ops/megakernel.py``: the same fold (`_nearest_hit_fold`), BRDF
sample (`_brdf_sample_from_vec` without the glass block) and Fresnel split
(`_dielectric_split_planes`), three draws per alive segment, the same push
and pop rules.  `render/wavefront.py:render_sample_wavefront_split` is the
same estimator on the XLA path's functions.

The kernel is bound by fp32 ALU and SFU work, as the inline megakernel:
per processed segment a fold over every primitive and one BRDF sample or
Fresnel split, against 40 B read and 28 B written per pixel per launch.
Each thread runs its pixel's samples as one flat loop of steps
(`csrc/split.cuh:split_step`) whose rng and radiance are the nested sample
x step loop's bit for bit; `kernel_resources` reports the instance's
registers, stack and occupancy.
It is built at first use with nvcc (`ops/megakernel.py:build_library`),
named by a hash of its source, its headers and the flags.  Nothing falls
back: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..core import linalg
from ..models.objects import Rays, Scene
from . import megakernel as MK
from . import rng as rng_ops
from .intersect import EPSILON

SOURCE = os.path.join(MK.CSRC, "split.cu")
HEADERS = (os.path.join(MK.CSRC, "split.cuh"), os.path.join(MK.CSRC, "bounce.cuh"))
# The deepest stack the kernel takes (kMaxStack in csrc/split.cuh).
MAX_STACK = 64

# Launches of the CUDA kernel by `launch_split`.  Callers reset the count
# to 0 to count the launches of a run.
LAUNCHES = {"split_kernel": 0}

_lib = None


def clamp_stack_depth(num_bounces: int, stack_depth: int) -> int:
    """The stack a trace of `num_bounces` takes: at least one slot, and no
    more than num_bounces - 1 (a path pushes at most one child per depth,
    so that many never drop one)."""
    return max(1, min(num_bounces - 1, int(stack_depth)))


# Plain PyTorch version ---------------------------------------------------


def _dielectric_split_planes(dx, dy, dz, nx, ny, nz, ior):
    """The TPU kernel's `_dielectric_split_planes` on [H, W] planes, op for
    op: (reflected x3, refracted x3, reflection weight).  `linalg.sqrt` is
    the correctly rounded square root on the CPU too."""
    where = torch.where
    cos_i = -(dx * nx + dy * ny + dz * nz)
    inside = cos_i < 0.0
    fnx, fny, fnz = where(inside, -nx, nx), where(inside, -ny, ny), where(inside, -nz, nz)
    aci = cos_i.abs()
    eta = where(inside, ior, 1.0 / ior)
    sin2 = eta * eta * torch.clamp(1.0 - aci * aci, min=0.0)
    tir = sin2 > 1.0
    cos_t = where(tir, 0.0, linalg.sqrt(where(tir, 1.0, torch.clamp(1.0 - sin2, min=1e-12))))
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    c1 = 1.0 - aci
    c2 = c1 * c1
    f_refl = where(tir, 1.0, r0 + (1.0 - r0) * (c1 * (c2 * c2)))
    ia = dx * fnx + dy * fny + dz * fnz
    rx, ry, rz = dx - 2.0 * ia * fnx, dy - 2.0 * ia * fny, dz - 2.0 * ia * fnz
    k = eta * aci - cos_t
    tx, ty, tz = eta * dx + k * fnx, eta * dy + k * fny, eta * dz + k * fnz
    tn = torch.clamp(linalg.sqrt(tx * tx + ty * ty + tz * tz), min=1e-20)
    return rx, ry, rz, tx / tn, ty / tn, tz / tn, f_refl


def trace_split_reference(
    scene: Scene,
    rays: Rays,
    rng: torch.Tensor,
    num_bounces: int = 15,
    spp: int = 1,
    stack_depth: int = 2,
    telemetry: bool = False,
):
    """Plain PyTorch version of the splitting kernel on [H, W] planes:
    (radiance sum over `spp` samples [H, W, 3] f32, final rng [H, W, 4]
    int32), and with `telemetry` the processed segments per winning table
    row [P] int64 and the steps of each sample [spp, H, W] int32 (a step
    is one iteration of the nested loop's step body: a segment traced, a
    child popped, or the dead segment that ends the sample).
    `stack_depth` is taken as `trace_split_fused` takes it, through
    `clamp_stack_depth`.  The step loop ends once every lane is done,
    which changes nothing: a lane with no segment and no child stays so."""
    where = torch.where
    geom, mat = MK.scene_tables(scene)
    counts = MK.primitive_counts(scene)
    stack_depth = clamp_stack_depth(num_bounces, stack_depth)
    max_steps = num_bounces * (1 + stack_depth)
    po, pd = rays.origin.unbind(-1), rays.direction.unbind(-1)
    zeros = torch.zeros_like(po[0])
    izeros = torch.zeros(zeros.shape, dtype=torch.int32, device=zeros.device)
    acc = (zeros,) * 3
    per_row = torch.zeros(sum(counts), dtype=torch.int64, device=zeros.device)
    steps = torch.zeros((spp, *zeros.shape), dtype=torch.int32, device=zeros.device)
    for s in range(spp):
        o, d = po, pd
        th = (torch.ones_like(zeros),) * 3
        res = (zeros,) * 3
        depth, sp = izeros, izeros
        live = torch.ones(zeros.shape, dtype=torch.bool, device=zeros.device)
        # Per slot: origin, direction, throughput (9 planes) and depth.
        stk = [[zeros] * 9 + [izeros] for _ in range(stack_depth)]
        for _ in range(max_steps):
            if not live.any():
                break
            h = MK._nearest_hit_fold(geom, mat, counts, *o, *d)
            q = th[0] * th[0] + th[1] * th[1] + th[2] * th[2]
            alive = live & h["hit"] & (q > linalg.NEAR_ZERO_EPS) & (depth < num_bounces)
            if telemetry:
                per_row += torch.bincount(h["best"][alive], minlength=len(per_row))
                steps[s] += live.to(torch.int32)
            color = (h["cr"], h["cg"], h["cb"])
            # Emission at the old throughput.
            res = tuple(r + where(alive, c * h["il"] * t, 0.0) for r, c, t in zip(res, color, th))
            v, rng2 = rng_ops.gen_vec(rng)
            sample = MK._brdf_sample_from_vec(h, *d, *v.unbind(-1), has_dielectric=False)
            no, nd, tm = sample[0:3], sample[3:6], sample[6:9]
            # Glass: this lane continues as the reflection, weight F; the
            # refraction child, weight 1 - F, is pushed.
            rx, ry, rz, tx, ty, tz, f_refl = _dielectric_split_planes(
                *d, h["nx"], h["ny"], h["nz"], h["pr"])
            hp = (h["hx"], h["hy"], h["hz"])
            is_diel = alive & (h["kd"] == 2.0)
            nd = tuple(where(is_diel, r, n) for r, n in zip((rx, ry, rz), nd))
            no = tuple(where(is_diel, p + r * EPSILON, n) for p, r, n in zip(hp, (rx, ry, rz), no))
            tm = tuple(where(is_diel, c * f_refl, t) for c, t in zip(color, tm))
            omf = 1.0 - f_refl
            ct = tuple(t * c * omf for t, c in zip(th, color))
            ct_q = ct[0] * ct[0] + ct[1] * ct[1] + ct[2] * ct[2]
            push = (is_diel & (f_refl < 1.0) & (ct_q > linalg.NEAR_ZERO_EPS)
                    & (depth + 1 < num_bounces) & (sp < stack_depth))
            child = (*(p + t * EPSILON for p, t in zip(hp, (tx, ty, tz))), tx, ty, tz, *ct, depth + 1)
            for slot in range(stack_depth):
                w = push & (sp == slot)
                stk[slot] = [where(w, c, s) for c, s in zip(child, stk[slot])]
            sp = where(push, sp + 1, sp)

            # Advance the alive segments; a dead one's throughput is zero.
            o = tuple(where(alive, n, x) for n, x in zip(no, o))
            d = tuple(where(alive, n, x) for n, x in zip(nd, d))
            depth = where(alive, depth + 1, depth)
            th = tuple(where(alive, t * m, 0.0) for t, m in zip(th, tm))
            rng = where(alive[..., None], rng2, rng)

            # A lane whose segment died pops its deepest pending child.
            pop = live & ~alive & (sp > 0)
            top = sp - 1
            pv = [zeros] * 9 + [izeros]
            for slot in range(stack_depth):
                m = top == slot
                pv = [where(m, s, p) for s, p in zip(stk[slot], pv)]
            o = tuple(where(pop, p, x) for p, x in zip(pv[0:3], o))
            d = tuple(where(pop, p, x) for p, x in zip(pv[3:6], d))
            th = tuple(where(pop, p, x) for p, x in zip(pv[6:9], th))
            depth = where(pop, pv[9], depth)
            sp = where(pop, sp - 1, sp)
            live = alive | pop
        acc = tuple(a + r for a, r in zip(acc, res))
    out = (torch.stack(acc, dim=-1), rng)
    return (*out, per_row, steps) if telemetry else out


# The CUDA kernel ---------------------------------------------------------


def library_path() -> str:
    return MK.library_file(SOURCE, "split", HEADERS)


def build() -> str:
    """Compile csrc/split.cu for sm_90a unless this source's library
    exists; returns its path.  Raises on a failed build."""
    return MK.build_library(SOURCE, "split", HEADERS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.hpt_split_launch.argtypes = [
            vp, i, vp, i, i, i, i, vp, vp, vp, vp, vp, i, i, i, i, vp,
        ]
        lib.hpt_split_launch.restype = i
        lib.hpt_split_resources.argtypes = [i, i, i, i, vp, vp]
        lib.hpt_split_resources.restype = i
        _lib = lib
    return _lib


def kernel_resources(geom, counts, stack_depth, spp) -> dict:
    """What the card gives the splitting kernel's instance that a launch of
    `spp` samples on these tables with `stack_depth` slots takes
    (`ops/megakernel.py:resources`)."""
    return MK.resources(_library().hpt_split_resources, geom.shape[1], sum(counts),
                        stack_depth, spp)


def launch_split(geom, mat, counts, rays, rng, num_bounces, spp, stack_depth):
    """Launch the splitting kernel on packed tables (`MK.scene_tables`) and
    the per-kind primitive `counts`, with `stack_depth` slots (1 ..
    MAX_STACK, as given).  Checks every operand, allocates the outputs,
    launches on the current stream without synchronising and counts the
    launch in LAUNCHES["split_kernel"]."""
    device = rng.device
    if not rng.is_cuda:
        raise ValueError(f"launch_split takes CUDA tensors, not {device}")
    H, W = rng.shape[:2]
    P = sum(counts)
    MK._check("rng", rng, torch.int32, (H, W, 4), device)
    MK._check("rays.origin", rays.origin, torch.float32, (H, W, 3), device)
    MK._check("rays.direction", rays.direction, torch.float32, (H, W, 3), device)
    MK._check("geom", geom, torch.float32, (P, geom.shape[1]), device)
    MK._check("mat", mat, torch.float32, (P, 8), device)
    if geom.shape[1] not in (8, 16):
        raise ValueError(f"geom has {geom.shape[1]} columns, expected 8 or 16")
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"stack_depth {stack_depth} outside 1 .. {MAX_STACK}")
    if min(spp, num_bounces) < 0:
        raise ValueError("spp and num_bounces must be >= 0")
    radiance = torch.empty((H, W, 3), dtype=torch.float32, device=device)
    rng_out = torch.empty((H, W, 4), dtype=torch.int32, device=device)
    err = _library().hpt_split_launch(
        geom.data_ptr(), geom.shape[1], mat.data_ptr(), *counts,
        rays.origin.data_ptr(), rays.direction.data_ptr(), rng.data_ptr(),
        radiance.data_ptr(), rng_out.data_ptr(), H * W, spp, num_bounces,
        stack_depth, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"split kernel launch failed: cudaError {err}")
    LAUNCHES["split_kernel"] += 1
    return radiance, rng_out


def trace_split_fused(
    scene: Scene,
    rays: Rays,
    rng: torch.Tensor,
    num_bounces: int = 15,
    spp: int = 1,
    stack_depth: int = 2,
):
    """`spp` deterministic-splitting samples, summed: (radiance [H, W, 3]
    f32, final rng [H, W, 4] int32), with a stack of
    clamp_stack_depth(num_bounces, stack_depth) slots.  CUDA tensors launch
    the CUDA kernel (and count in LAUNCHES); CPU tensors run
    `trace_split_reference`."""
    stack_depth = clamp_stack_depth(num_bounces, stack_depth)
    if not rng.is_cuda:
        return trace_split_reference(scene, rays, rng, num_bounces, spp, stack_depth)
    return launch_split(*MK.scene_tables(scene), MK.primitive_counts(scene), rays, rng,
                        num_bounces, spp, stack_depth)
