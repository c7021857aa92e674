"""Sphere-table folds: the nearest sphere, and the dual query of one
physical/NEE bounce.

Counterpart of ``haskell_path_tracer_tpu/ops/pallas_intersect.py``:

  * `sphere_nearest` replaces its `sphere_nearest_pallas` and the kernel
    `_sphere_fold_kernel` (launched by `_run_kernel`): each ray's nearest
    sphere over a large table, the primary hit of the dual-query trace
    (`render/nee.py:_trace_physical_fused`) above CHUNKED_THRESHOLD
    primitives;
  * `sphere_dual_query` replaces its `sphere_dual_query` and the kernel
    `_dual_fold_kernel` (launched by `_run_dual_kernel`): one pass over the
    sphere table answers both the BSDF ray's nearest sphere and the shadow
    ray's occlusion from a shared shade point.

Both kernels are hand-written CUDA C++ in ``csrc/sphere_fold.cu`` (the
per-ray work in ``csrc/sphere_fold.cuh``: several rays per thread, the
table streamed through shared memory in tiles, the dual fold over its
compacted live lanes), built at first use with nvcc like the other kernels
(`ops/megakernel.py:build_library`); on CPU tensors the plain versions,
`ops/intersect.py:sphere_nearest_chunked` and `sphere_dual_reference`, run
instead.  Nothing falls back: a failed build or launch raises.

`SphereNearest` and `SphereDualQuery` are differentiable in the ray and the
spheres through the winner's closed-form distance (`winner_t`), the JAX
package's `_bwd` and `_dual_bwd`: the gradient of a min of distances is
the gradient of the winning one.  That backward is XLA in the JAX package,
not a Pallas kernel, so it is plain PyTorch here.  The winner, the
occlusion and the shadow geometry are detached decisions.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..core import linalg
from . import megakernel as MK
from .intersect import (
    EPSILON,
    INFINITE,
    sphere_nearest_chunked,
    sphere_occluded_any,
)
from ..models.objects import Spheres
from ..utils.metrics import span

SOURCE = os.path.join(MK.CSRC, "sphere_fold.cu")
HEADERS = tuple(os.path.join(MK.CSRC, h)
                for h in ("sphere_fold.cuh", "tiles.cuh", "nee.cuh", "bounce.cuh"))

# Launches of each kernel by `launch_nearest_fold` and `launch_dual_fold`.
# Callers reset the counts to 0 to count the launches of a run.
LAUNCHES = {"nearest_fold": 0, "dual_fold": 0}

_lib = None


def library_path() -> str:
    return MK.library_file(SOURCE, "sphere_fold", HEADERS)


def build() -> str:
    """Compile csrc/sphere_fold.cu unless this source's library exists."""
    return MK.build_library(SOURCE, "sphere_fold", HEADERS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.hpt_dual_fold_launch.argtypes = [
            vp, i, vp, vp, vp, vp, vp, vp, ctypes.c_float, vp, vp, vp, vp, i, vp,
        ]
        lib.hpt_dual_fold_launch.restype = i
        lib.hpt_nearest_fold_launch.argtypes = [vp, i, vp, vp, ctypes.c_float, vp, vp, i, vp]
        lib.hpt_nearest_fold_launch.restype = i
        lib.hpt_sphere_fold_resources.argtypes = [i, i, i, vp, vp]
        lib.hpt_sphere_fold_resources.restype = i
        _lib = lib
    return _lib


def kernel_resources(dual: bool, num_rays: int, num_spheres: int) -> dict:
    """What the card gives the fold instance that a launch of the dual
    (else the nearest) fold on num_rays rays and num_spheres spheres takes
    (`ops/megakernel.py:resources`)."""
    return MK.resources(_library().hpt_sphere_fold_resources, int(dual), num_rays, num_spheres)


def _check_table(spheres, device):
    MK._check("spheres", spheres, torch.float32, (spheres.shape[0], 4), device)
    if spheres.data_ptr() % 16:
        raise ValueError("spheres: the kernels copy rows 16 bytes at a time; "
                         "pass a 16-byte-aligned table (`sphere_table`)")


def sphere_table(pos, radius) -> torch.Tensor:
    """The fold's table [P, 4]: center and radius^2."""
    return torch.cat([pos, (radius * radius)[:, None]], dim=-1).contiguous()


def launch_nearest_fold(spheres, ray_o, ray_d, eps: float = 0.0):
    """Launch the nearest-sphere kernel on the table `spheres` [P, 4]
    (`sphere_table`) and [R] rays, accepting t >= eps: (t f32, prim int32).
    Checks every operand, launches on the current stream without
    synchronising and counts the launch in LAUNCHES["nearest_fold"]."""
    device = ray_o.device
    if not ray_o.is_cuda:
        raise ValueError(f"launch_nearest_fold takes CUDA tensors, not {device}")
    r = ray_o.shape[0]
    P = spheres.shape[0]
    _check_table(spheres, device)
    MK._check("ray_o", ray_o, torch.float32, (r, 3), device)
    MK._check("ray_d", ray_d, torch.float32, (r, 3), device)
    t = torch.empty(r, dtype=torch.float32, device=device)
    prim = torch.empty(r, dtype=torch.int32, device=device)
    with span("hpt.launch.nearest_fold"):
        err = _library().hpt_nearest_fold_launch(
            spheres.data_ptr(), P, ray_o.data_ptr(), ray_d.data_ptr(), eps, t.data_ptr(),
            prim.data_ptr(), r, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nearest-fold launch failed: cudaError {err}")
    LAUNCHES["nearest_fold"] += 1
    return t, prim


def launch_dual_fold(spheres, ray_o, d_bsdf, d_shadow, t_light, light_idx, alive,
                     eps: float = EPSILON):
    """Launch the dual-fold kernel on the table `spheres` [P, 4]
    (`sphere_table`) and [R] rays: (t f32, prim int32, occluded bool).
    Checks every operand, launches on the current stream without
    synchronising and counts the launch in LAUNCHES["dual_fold"]."""
    device = ray_o.device
    if not ray_o.is_cuda:
        raise ValueError(f"launch_dual_fold takes CUDA tensors, not {device}")
    r = ray_o.shape[0]
    P = spheres.shape[0]
    _check_table(spheres, device)
    for name, t in (("ray_o", ray_o), ("d_bsdf", d_bsdf), ("d_shadow", d_shadow)):
        MK._check(name, t, torch.float32, (r, 3), device)
    MK._check("t_light", t_light, torch.float32, (r,), device)
    MK._check("light_idx", light_idx, torch.int32, (r,), device)
    MK._check("alive", alive, torch.int32, (r,), device)
    t = torch.empty(r, dtype=torch.float32, device=device)
    prim = torch.empty(r, dtype=torch.int32, device=device)
    occ = torch.empty(r, dtype=torch.int32, device=device)
    live = torch.empty(r + 1, dtype=torch.int32, device=device)  # the live lanes' count and list
    with span("hpt.launch.dual_fold"):
        err = _library().hpt_dual_fold_launch(
            spheres.data_ptr(), P, ray_o.data_ptr(), d_bsdf.data_ptr(), d_shadow.data_ptr(),
            t_light.data_ptr(), light_idx.data_ptr(), alive.data_ptr(), eps,
            t.data_ptr(), prim.data_ptr(), occ.data_ptr(), live.data_ptr(), r,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dual-fold launch failed: cudaError {err}")
    LAUNCHES["dual_fold"] += 1
    return t, prim, occ != 0


def sphere_dual_reference(ray_o, d_bsdf, d_shadow, t_light, light_idx, alive, pos, radius,
                          eps: float = EPSILON):
    """Plain version of the dual-fold kernel: the nearest-sphere fold
    (`sphere_nearest_chunked`) and the shadow test (`sphere_occluded_any`),
    in the kernel's f32 sequence; dead lanes (alive = 0) return
    (INFINITE, 0, False)."""
    spheres = Spheres(pos=pos, radius=radius, material=None)
    t, prim = sphere_nearest_chunked(ray_o, d_bsdf, spheres, eps)
    occ = sphere_occluded_any(ray_o, d_shadow, t_light, light_idx.long(), spheres)
    live = alive != 0
    return (torch.where(live, t, INFINITE), torch.where(live, prim, 0).to(torch.int32),
            occ & live)


def winner_t(ray_o, ray_d, pos, radius, prim, hit):
    """The closed-form distance to each ray's winning sphere (0 where `hit`
    is False), differentiable in every argument but the decisions."""
    c, rad = pos[prim], radius[prim]
    l = c - ray_o
    tca = linalg.dot(l, ray_d)
    d2 = linalg.quadrance(l) - tca * tca
    arg = torch.where(hit, torch.clamp(rad * rad - d2, min=1e-12), 1.0)
    thc = torch.where(hit, torch.sqrt(arg), 0.0)
    return torch.where(hit, tca - thc, 0.0)


def _winner_t_grads(g_t, ray_o, ray_d, pos, radius, prim, hit):
    """The cotangent g_t of the winners' distances into (ray_o, ray_d, pos,
    radius), through `winner_t`."""
    leaves = [x.detach().requires_grad_() for x in (ray_o, ray_d, pos, radius)]
    with torch.enable_grad():
        t = winner_t(*leaves, prim.long(), hit)
        return torch.autograd.grad(t, leaves, g_t)


class SphereNearest(torch.autograd.Function):
    """(t, prim int32) of `sphere_nearest`; the kernel on CUDA tensors, the
    plain chunked fold on the CPU.  Backward: the cotangent of t through
    `winner_t` into (ray_o, ray_d, pos, radius)."""

    @staticmethod
    def forward(ctx, ray_o, ray_d, pos, radius, eps):
        if ray_o.is_cuda:
            t, prim = launch_nearest_fold(sphere_table(pos, radius), ray_o.contiguous(),
                                          ray_d.contiguous(), eps)
        else:
            t, prim = sphere_nearest_chunked(
                ray_o, ray_d, Spheres(pos=pos, radius=radius, material=None), eps)
            prim = prim.to(torch.int32)
        ctx.save_for_backward(ray_o, ray_d, pos, radius, prim, t < INFINITE)
        ctx.mark_non_differentiable(prim)
        return t, prim

    @staticmethod
    def backward(ctx, g_t, _g_prim):
        return (*_winner_t_grads(g_t, *ctx.saved_tensors), None)


def sphere_nearest(ray_o, ray_d, pos, radius, eps: float = 0.0):
    """Each ray's nearest sphere over [R, 3] rays: (t [R], prim [R] int32),
    accepting t >= eps (`ops/intersect.py:sphere_distances`' rule),
    (INFINITE, 0) on a miss, the lowest index winning ties.  Differentiable
    in (ray_o, ray_d, pos, radius) through the winner's distance."""
    return SphereNearest.apply(ray_o, ray_d, pos, radius, eps)


class SphereDualQuery(torch.autograd.Function):
    """(t, prim int32, occluded bool) of `sphere_dual_query`; the kernel
    on CUDA tensors, the plain version on the CPU.  Backward: the cotangent
    of t through `winner_t` into (ray_o, d_bsdf, pos, radius)."""

    @staticmethod
    def forward(ctx, ray_o, d_bsdf, d_shadow, t_light, light_idx, alive, pos, radius, eps):
        if ray_o.is_cuda:
            t, prim, occ = launch_dual_fold(
                sphere_table(pos, radius), ray_o.contiguous(), d_bsdf.contiguous(),
                d_shadow.contiguous(), t_light.contiguous(),
                light_idx.to(torch.int32).contiguous(), alive.to(torch.int32).contiguous(), eps)
        else:
            t, prim, occ = sphere_dual_reference(
                ray_o, d_bsdf, d_shadow, t_light, light_idx, alive, pos, radius, eps)
        ctx.save_for_backward(ray_o, d_bsdf, pos, radius, prim, t < INFINITE)
        ctx.mark_non_differentiable(prim, occ)
        return t, prim, occ

    @staticmethod
    def backward(ctx, g_t, _g_prim, _g_occ):
        grads = _winner_t_grads(g_t, *ctx.saved_tensors)
        return (grads[0], grads[1], None, None, None, None, grads[2], grads[3], None)


def sphere_dual_query(ray_o, d_bsdf, d_shadow, t_light, light_idx, alive, pos, radius,
                      eps: float = EPSILON):
    """Both per-bounce sphere queries from the shade points ray_o [R, 3]:
    `(t, prim, occluded)`, where (t, prim) is the nearest sphere along
    d_bsdf under offset-origin acceptance (t >= eps, measured from ray_o;
    INFINITE and 0 on a miss, the lowest index winning ties) and
    `occluded` says whether a sphere other than light_idx [R] meets
    d_shadow at t in [EPSILON, t_light).  Lanes with alive [R] = 0 skip the
    fold and return (INFINITE, 0, False).  Differentiable in (ray_o,
    d_bsdf, pos, radius) through the winner's distance."""
    return SphereDualQuery.apply(ray_o, d_bsdf, d_shadow, t_light, light_idx, alive, pos,
                                 radius, eps)
