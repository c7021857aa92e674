"""The physical/NEE megakernel and the primary-hit probe.

Replaces ``haskell_path_tracer_tpu/ops/pallas_nee.py:_nee_kernel`` (the
whole physical/NEE sample x bounce loop, launched there by
``_trace_nee_from_tables``) and ``_primary_kernel`` (the camera rays'
nearest (t0, prim0), launched by ``primary_probe`` and the presort).  Both
are hand-written CUDA C++ in ``csrc/nee_megakernel.cu`` (device functions
in ``csrc/nee.cuh``), one library, built at first use with nvcc like the
parity kernels (`ops/megakernel.py:build_library`).

On CUDA tensors `trace_physical_nee` launches the NEE kernel and
`primary_probe` the probe; on CPU tensors they run the plain versions,
`trace_physical_nee_reference` (`spp` calls of
`render/nee.py:trace_physical(nee=True)`, summed) and
`ops/intersect.py:nearest_t_prim(..., 0.0)`.  Nothing falls back: a failed
build or launch raises.

The NEE kernel is bound by fp32 work: per live bounce a thread folds every
sphere twice (the BSDF ray's nearest hit and the shadow ray's any-hit, one
shared `center - point` vector), so at 1000 spheres the fold is ~50k
operations against ~300 for the shading and the light sample.  Device
memory traffic is 40 B in and 28 B out per pixel per launch.  The fold
tables sit in shared memory when they fit in 48 KB (about 3000 spheres)
and are otherwise read through the L1 cache, where every lane of a warp
reads the same row.

Presort (`presort=True`): the probe's t0 is argsorted (sky last, stable)
and the NEE kernel takes the order as an int32 lane map, thread i working
on pixel order[i] and reading the probe's (t0, prim0) instead of folding:
per pixel the results are bit-identical to raster order.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core import linalg
from ..models.objects import BRDF_DIELECTRIC, BRDF_GLOSSY, Rays, Scene
from . import megakernel as MK
from .intersect import _payload_table, nearest_t_prim

SOURCE = os.path.join(MK.CSRC, "nee_megakernel.cu")
HEADERS = (os.path.join(MK.CSRC, "nee.cuh"), os.path.join(MK.CSRC, "bounce.cuh"))

# Launches of each CUDA kernel by `launch_nee` and `launch_probe`.  Callers
# reset them to 0 to count the launches of a run.
LAUNCHES = {"nee_megakernel": 0, "primary_probe": 0}

# presort=None takes the presort from PRESORT_MIN_SPHERES spheres and
# PRESORT_MIN_SPP samples on (the JAX package's gate), where the H100
# measured it faster: on suite config 4's scene the depth order keeps the
# lanes of a warp on paths of like length (PERF.md).
PRESORT_MIN_SPHERES, PRESORT_MIN_SPP = 64, 8

_lib = None


def nee_eligible(scene: Scene) -> bool:
    """Whether the NEE kernel takes the scene: 0 < spheres < 2^24 (light
    and primitive indices travel as f32 in the light table).  The light
    set is static in the port: it is read from the scene's tensors."""
    return 0 < scene.spheres.count < (1 << 24)


def scene_light_indices(scene: Scene) -> tuple:
    """The NEE emitters as a static tuple in `sample_light`'s index space:
    spheres first (i < spheres names sphere i), then triangles (i names
    triangle i - spheres).  Reads the illuminance on the host."""
    ns = scene.spheres.count
    idx = [int(i) for i in np.nonzero(scene.spheres.material.illuminance.cpu().numpy() > 0.0)[0]]
    if scene.triangles.count:
        til = scene.triangles.material.illuminance.cpu().numpy()
        idx += [ns + int(i) for i in np.nonzero(til > 0.0)[0]]
    return tuple(idx)


@dataclass(frozen=True)
class NeeTables:
    """The kernels' tables, packed once per scene.

    fold     f32 [4 S + 8 M + 8 B + 12 T], the rows the folds stream:
             spheres [cx, cy, cz, r^2], planes [p(3), n(3), 0, 0],
             boxes [lo(3), hi(3), 0, 0], triangles [v0(3), e1(3), e2(3),
             |e1 x e2|, 0, 0] (16-byte rows, float4 loads)
    payload  f32 [S+M+B+T, 12], the winner's row read by its index:
             `ops/intersect.py:_payload_table` (aux, aux2, color,
             illuminance, brdf_param, brdf_kind)
    lights   f32 [max(L, 1), 16], one row per emitter of `light_idx`:
             [kind (0 sphere, 1 triangle), global prim, color *
             illuminance (3), center | v0 (3), radius, e1 (3), e2 (3), 0]
    scene    the source scene (the plain versions run on it)
    """

    fold: torch.Tensor
    payload: torch.Tensor
    lights: torch.Tensor
    counts: tuple
    num_lights: int
    scene: Scene


def nee_scene_tables(scene: Scene, light_idx=None) -> NeeTables:
    """Pack `scene` for the kernels; `light_idx` is `scene_light_indices`
    (read from the scene when None)."""
    if light_idx is None:
        light_idx = scene_light_indices(scene)
    sp, pl, bx, tr = scene.spheres, scene.planes, scene.boxes, scene.triangles
    ns, npl, nb = sp.count, pl.count, bx.count

    def rows(*cols, width):
        t = torch.cat(cols, dim=-1)
        return torch.cat([t, t.new_zeros(t.shape[0], width - t.shape[1])], dim=-1)

    e1 = tr.v1 - tr.v0
    e2 = tr.v2 - tr.v0
    fold = torch.cat([
        rows(sp.pos, (sp.radius * sp.radius)[:, None], width=4).reshape(-1),
        rows(pl.pos, pl.normal, width=8).reshape(-1),
        rows(bx.lo, bx.hi, width=8).reshape(-1),
        rows(tr.v0, e1, e2, linalg.norm(linalg.cross(e1, e2))[:, None], width=12).reshape(-1),
    ])

    lights = sp.pos.new_zeros(1, 16)
    if len(light_idx):
        li = torch.tensor(light_idx, dtype=torch.int64)
        if sp.pos.is_cuda:
            # From pinned memory the copy does not wait for the stream:
            # a progressive step packs the tables every time.
            li = li.pin_memory().to(sp.pos.device, non_blocking=True)
        s = torch.clamp(li, max=ns - 1)
        zeros = sp.pos.new_zeros(len(li), 1)
        m = sp.material
        lights = torch.cat([
            zeros, li[:, None].to(torch.float32), m.color[s] * m.illuminance[s][:, None],
            sp.pos[s], sp.radius[s][:, None], zeros.expand(-1, 7),
        ], dim=-1)
        if tr.count:
            k = torch.clamp(li - ns, 0, tr.count - 1)
            m = tr.material
            tri_rows = torch.cat([
                zeros + 1.0, (li + npl + nb)[:, None].to(torch.float32),
                m.color[k] * m.illuminance[k][:, None], tr.v0[k], zeros, e1[k], e2[k], zeros,
            ], dim=-1)
            lights = torch.where((li >= ns)[:, None], tri_rows, lights)
    return NeeTables(
        fold=fold.contiguous(),
        payload=_payload_table(scene).contiguous(),
        lights=lights.contiguous(),
        counts=(ns, npl, nb, tr.count),
        num_lights=len(light_idx),
        scene=scene,
    )


# The CUDA kernels --------------------------------------------------------


def library_path() -> str:
    return MK.library_file(SOURCE, "nee_megakernel", HEADERS)


def build() -> str:
    """Compile csrc/nee_megakernel.cu unless this source's library exists."""
    return MK.build_library(SOURCE, "nee_megakernel", HEADERS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.hpt_nee_launch.argtypes = [
            vp, vp, vp, i, i, i, i, i,  # tables, counts, lights
            vp, vp, vp, vp, vp, vp,  # origin, direction, rng, t0, prim0, order
            vp, vp, vp,  # radiance, rng_out, steps
            i, i, i, i, i, vp,
        ]
        lib.hpt_nee_launch.restype = i
        lib.hpt_probe_launch.argtypes = [vp, i, i, i, i, vp, vp, vp, vp, i, vp]
        lib.hpt_probe_launch.restype = i
        _lib = lib
    return _lib


def _check_tables(tables: NeeTables, device):
    ns, npl, nb, nt = tables.counts
    if not 0 < ns < (1 << 24) or sum(tables.counts) >= (1 << 24):
        raise ValueError(f"the NEE kernels take 0 < spheres < 2^24 and < 2^24 primitives: {tables.counts}")
    MK._check("fold", tables.fold, torch.float32, (4 * ns + 8 * npl + 8 * nb + 12 * nt,), device)
    MK._check("payload", tables.payload, torch.float32, (sum(tables.counts), 12), device)
    MK._check("lights", tables.lights, torch.float32, (max(tables.num_lights, 1), 16), device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_probe(tables: NeeTables, rays: Rays):
    """Launch the probe: the camera rays' nearest (t0 f32, prim0 int32),
    eps = 0, over all four kinds, in the rays' leading shape.  Counts the
    launch in LAUNCHES["primary_probe"]."""
    device = rays.origin.device
    shape = tuple(rays.origin.shape[:-1])
    n = int(np.prod(shape))
    _check_tables(tables, device)
    MK._check("rays.origin", rays.origin, torch.float32, (*shape, 3), device)
    MK._check("rays.direction", rays.direction, torch.float32, (*shape, 3), device)
    t0 = torch.empty(shape, dtype=torch.float32, device=device)
    prim0 = torch.empty(shape, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().hpt_probe_launch(
        tables.fold.data_ptr(), *tables.counts, rays.origin.data_ptr(),
        rays.direction.data_ptr(), t0.data_ptr(), prim0.data_ptr(), n, stream,
    )
    if err != 0:
        raise RuntimeError(f"primary probe launch failed: cudaError {err}")
    LAUNCHES["primary_probe"] += 1
    return t0, prim0


def launch_nee(tables: NeeTables, rays: Rays, rng, num_bounces, spp, has_glossy=True,
               has_diel=True, order=None, primary=None, telemetry=False):
    """Launch the NEE kernel: `spp` samples of the physical/NEE estimator
    summed, on [H, W] rays and rng.  `order` (int32 [H*W], a permutation)
    makes thread i work on pixel order[i]; `primary` = (t0, prim0) from
    `launch_probe` replaces the kernel's own primary fold.  Returns
    (radiance [H, W, 3], rng [H, W, 4] int32), and the live bounces per
    pixel [H, W] int32 with `telemetry`.  Checks every operand, launches
    on the current stream without synchronising and counts the launch in
    LAUNCHES["nee_megakernel"]."""
    device = rng.device
    H, W = rng.shape[:2]
    _check_tables(tables, device)
    MK._check("rng", rng, torch.int32, (H, W, 4), device)
    MK._check("rays.origin", rays.origin, torch.float32, (H, W, 3), device)
    MK._check("rays.direction", rays.direction, torch.float32, (H, W, 3), device)
    if order is not None:
        MK._check("order", order, torch.int32, (H * W,), device)
    t0 = prim0 = None
    if primary is not None:
        t0, prim0 = primary
        MK._check("t0", t0, torch.float32, (H, W), device)
        MK._check("prim0", prim0, torch.int32, (H, W), device)
    if min(spp, num_bounces) < 0:
        raise ValueError("spp and num_bounces must be >= 0")
    radiance = torch.empty((H, W, 3), dtype=torch.float32, device=device)
    rng_out = torch.empty((H, W, 4), dtype=torch.int32, device=device)
    steps = torch.empty((H, W), dtype=torch.int32, device=device) if telemetry else None
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().hpt_nee_launch(
        tables.fold.data_ptr(), tables.payload.data_ptr(), tables.lights.data_ptr(),
        *tables.counts, tables.num_lights,
        rays.origin.data_ptr(), rays.direction.data_ptr(), rng.data_ptr(),
        _ptr(t0), _ptr(prim0), _ptr(order),
        radiance.data_ptr(), rng_out.data_ptr(), _ptr(steps),
        H * W, spp, num_bounces, int(has_glossy), int(has_diel), stream,
    )
    if err != 0:
        raise RuntimeError(f"NEE megakernel launch failed: cudaError {err}")
    LAUNCHES["nee_megakernel"] += 1
    return (radiance, rng_out, steps) if telemetry else (radiance, rng_out)


# Entry points -------------------------------------------------------------


def primary_probe(tables: NeeTables, rays: Rays):
    """The camera rays' nearest (t0, prim0 int32), eps = 0: the probe
    kernel on CUDA tensors, `nearest_t_prim` on the CPU."""
    if rays.origin.is_cuda:
        return launch_probe(tables, rays)
    t0, prim0 = nearest_t_prim(rays.origin, rays.direction, tables.scene, 0.0)
    return t0, prim0.to(torch.int32)


def trace_physical_nee_reference(scene: Scene, rays: Rays, rng, num_bounces: int = 8,
                                 spp: int = 1, kinds=None, telemetry: bool = False):
    """Plain version of the NEE kernel: `spp` calls of
    `render/nee.py:trace_physical(nee=True)`, the rng threaded through,
    radiance summed; with `telemetry` also the live bounces per lane."""
    from ..render import nee as RN

    if kinds is None:
        kinds = RN._present_kinds(scene)
    acc = torch.zeros_like(rays.origin)
    steps = torch.zeros(rays.origin.shape[:-1], dtype=torch.int32, device=rng.device)
    for _ in range(spp):
        radiance, rng, live = RN._trace(scene, rays, rng, num_bounces, True, kinds)
        acc = acc + radiance
        steps = steps + live
    return (acc, rng, steps) if telemetry else (acc, rng)


def _presort_order(t0):
    """Lanes by ascending primary depth, sky (INFINITE) last; stable, so
    equal depths keep raster order."""
    return torch.argsort(t0.reshape(-1), stable=True).to(torch.int32)


def trace_physical_nee(scene: Scene, rays: Rays, rng, num_bounces: int = 8, spp: int = 1,
                       light_idx=None, kinds=None, presort: bool | None = None,
                       telemetry: bool = False):
    """`spp` samples of the physical/NEE estimator, summed: (radiance
    [H, W, 3], final rng [H, W, 4]) and, with `telemetry`, the live
    bounces per pixel [H, W] int32.

    CUDA tensors launch the NEE kernel, CPU tensors run
    `trace_physical_nee_reference`.  `presort` first runs the probe and
    works through the pixels in depth order (None: from
    PRESORT_MIN_SPHERES spheres and PRESORT_MIN_SPP samples on); on the CPU
    the plain version runs on the permuted lanes.  Per pixel the result is
    bit-identical either way.  `light_idx` and `kinds` are read
    from the scene when None."""
    from ..render.nee import _present_kinds

    if kinds is None:
        kinds = _present_kinds(scene)
    if presort is None:
        presort = scene.spheres.count >= PRESORT_MIN_SPHERES and spp >= PRESORT_MIN_SPP
    H, W = rng.shape[:2]
    if not rng.is_cuda:
        if not presort:
            return trace_physical_nee_reference(scene, rays, rng, num_bounces, spp, kinds, telemetry)
        t0, _ = nearest_t_prim(rays.origin, rays.direction, scene, 0.0)
        order = _presort_order(t0).long()
        lanes = Rays(origin=rays.origin.reshape(-1, 3)[order][None],
                     direction=rays.direction.reshape(-1, 3)[order][None])
        out = trace_physical_nee_reference(
            scene, lanes, rng.reshape(-1, 4)[order][None], num_bounces, spp, kinds, telemetry)
        unsorted = []
        for x in out:
            flat = torch.empty_like(x[0])
            flat[order] = x[0]
            unsorted.append(flat.reshape(H, W, *x.shape[2:]))
        return tuple(unsorted)
    tables = nee_scene_tables(scene, light_idx)
    has_glossy = BRDF_GLOSSY in kinds
    has_diel = BRDF_DIELECTRIC in kinds
    if presort:
        t0, prim0 = launch_probe(tables, rays)
        return launch_nee(tables, rays, rng, num_bounces, spp, has_glossy, has_diel,
                          order=_presort_order(t0), primary=(t0, prim0), telemetry=telemetry)
    return launch_nee(tables, rays, rng, num_bounces, spp, has_glossy, has_diel,
                      telemetry=telemetry)
