"""The differentiable physical/NEE trace: the NEE megakernel forward and a
backward kernel, bound into a `torch.autograd.Function`.

Replaces ``haskell_path_tracer_tpu/ops/pallas_nee_vjp.py`` — its custom VJP
(`_make_nee_diff_fn`, `trace_physical_nee_pallas_diff`) and the backward
kernel `_nee_bwd_kernel` (launched by `_nee_bwd_call`), in both of that
kernel's modes.  `TracePhysicalNeeDiff`'s forward is the NEE megakernel of
``ops/nee.py`` (`launch_nee`, bit-equal to the render path's); its backward
is `launch_nee_backward`, the hand-written CUDA kernel in
``csrc/nee_megakernel_vjp.cu``, which replays each sample's bounces from
one residual word per (sample, bounce) and sweeps them in reverse with every
decision detached: the winner, the shadow decision, the hit and dead masks,
the BRDF branch and the six uniforms of each bounce.

Two modes, as in the TPU package.  Residual mode (its `grad_residuals` /
`fold_residuals`): when the words fit in RESIDUAL_MAX_BYTES and the light
tile in RESIDUAL_LIGHT_TILE_MAX_BYTES (`records_residuals`) the forward is
the NEE kernel's recording instance, which also writes one int32 word per
(sample, bounce) with the bounce's winner and its occlusion, hit and live
bits (`ops/nee.py`: PRIM_SHIFT, OCC_BIT, HIT_BIT, LIVE_BIT), and the
backward replays from those words without a single fold.  Replay mode,
above either limit: the forward records nothing, and the backward runs the
forward's own flat loop again one chunk of samples at a time, recording the
chunk's words into a per-thread buffer, then reverses the chunk from them
as the residual mode does.  Both take the forward's decisions bit for bit,
so they give the same ray cotangents bit for bit and the same table
cotangents up to the order of the atomic sums.

Gradients: the NEE tables (`NeeTables.fold`, `.payload`, `.lights`) and
the primary rays.  Autograd of `ops/nee.py:nee_scene_tables` maps the
tables' cotangents back to the scene's leaves: a sphere's radius through
r^2, an emitter's color and illuminance through their product, a
triangle's vertices through its edges and its unit normal e1 x e2.  The rng
is a constant of the gradient: `rng_out` is not differentiable.  Boxes are
not differentiated by the kernel (`diff/grad.py` sends box scenes to the
plain route).

The Function takes CUDA tensors only; on CPU tensors
`trace_physical_nee_diff` runs the plain version,
`ops/nee.py:trace_physical_nee_reference`, under autograd.
`backward_reference`, the plain version of the backward, is autograd of that
trace, one sample at a time, or, given residual words, autograd of
`trace_from_words`, the plain version of the residual mode's replay.
`bounce_reference` is one live bounce of the kernel at the table level, the
oracle of the adjoint's host test (tests/test_torch_nee_adjoint_host.py).

Ties: the kernel recomputes the distance of the fold's winner, the first
index at the least t, so a tie's cotangent goes to that winner alone, as
in the TPU kernel; autograd of the plain fold's min splits it between the
tied primitives.  The two agree wherever no two primitives meet a ray at
the same t.

Sorted gradient frame: with `sorted_lanes` the probe's primary depths are
argsorted (sky last) and both kernels take that lane order, thread i
working on pixel order[i] with the probe's (t0, prim0): per pixel the
results are those of raster order, and no differentiable gather is needed.
The residual words stay in lane order between the two kernels.

Tolerance against the plain version: loss rtol 1e-5 and, per `SceneParams`
field, a normalised error max|a - b| / max|b| below 5e-3
(tests/test_pallas_nee_vjp.py).  The kernel sums the table cotangents with
atomics in an order that changes from run to run, and grazing lanes amplify
a last-bit difference of the forward in the gradient.

The replay mode is bound by fp32 work: each chunk's flat loop repeats the
forward's dual fold at every live bounce, the recording forward's work,
and its reverse is the residual mode's.  The residual mode's work is the
adjoint alone, under a thousand operations per bounce, and its atomic sums
(see the note at the top of the CUDA source).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from ..core import linalg
from ..models.objects import BRDF_DIELECTRIC, BRDF_GLOSSY, BRDF_MATTE, Rays, Scene
from . import megakernel as MK
from . import nee as NE
from . import rng as rng_ops
from .intersect import INFINITE, PLANE_DENOM_EPS, Hit

SOURCE = os.path.join(MK.CSRC, "nee_megakernel_vjp.cu")
HEADERS = tuple(os.path.join(MK.CSRC, h) for h in ("nee_vjp.cuh", "nee.cuh", "bounce.cuh"))
# The reverse's residual array (kMaxBounces in the CUDA source).
MAX_BOUNCES = 16
# What the C entry point returns for more bounces than MAX_BOUNCES or for
# a scene with boxes.
_CUDA_ERROR_INVALID_VALUE = 1

# The gradient's forward records residual words, 4 B per lane, sample and
# bounce, when they take at most this many bytes; above it the backward
# replays the folds.  2 GiB: the TPU package's budget of 64 int32 planes
# at 4K (`MAX_RESIDUAL_PLANES`, set there by VMEM) in bytes, under 3% of
# the H100's 80 GB; writing and reading the words back costs 2 bytes /
# 3.35 TB/s, 1.3 ms at the cap, where the fold replay they spare costs
# hundreds of milliseconds at suite config 7 (PERF.md).  Tests set it to 0
# to take the replay mode.
RESIDUAL_MAX_BYTES = 1 << 31
# The residual mode keeps the light cotangents (64 B per emitter row) in a
# shared-memory tile, so it is taken only when that tile fits in the 48 KB
# any block may take without opting in for more: up to 768 emitters.  The
# replay mode takes any number: above 768 its light rows take global
# atomics.
RESIDUAL_LIGHT_TILE_MAX_BYTES = 48 * 1024
# Both modes sum the fold and payload cotangents (64 B per sphere) in
# shared-memory tiles too, each block adding its tiles to the output once,
# when the three tiles take at most RESIDUAL_TILE_MAX_BYTES (and fit in the
# card's opt-in shared memory per block, which the launch checks; the
# replay mode also keeps them out where they would cost its kernel a
# resident block per SM); larger tables take one global atomic per entry
# and bounce.  113 KB: the most that keeps two blocks resident per SM of an
# H100 (228 KB of shared memory per SM, 1 KB of it reserved per block).
# On an H100 at suite config 7's shapes the residual mode's tiles won
# 2.4-2.6x with 3 blocks per SM (1000 spheres) and 1.65-1.8x with 2 (1600),
# and lost 9-11% with 1 (3400; PERF.md, phase 20).  Tests set it to 0 to
# take the global atomics.
RESIDUAL_TILE_MAX_BYTES = 113 * 1024

# Launches of the backward kernel by `launch_nee_backward`: LAUNCHES counts
# every launch, RESIDUAL_LAUNCHES those of the residual mode among them.
# Callers reset them to 0 to count the launches of a run.
LAUNCHES = 0
RESIDUAL_LAUNCHES = 0

_lib = None


def library_path() -> str:
    return MK.library_file(SOURCE, "nee_megakernel_vjp", HEADERS)


def build() -> str:
    """Compile csrc/nee_megakernel_vjp.cu unless this source's library
    exists; returns its path.  Raises on a failed build."""
    return MK.build_library(SOURCE, "nee_megakernel_vjp", HEADERS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.hpt_nee_vjp_launch.argtypes = [
            vp, vp, vp, i, i, i, i, i,  # tables, counts, lights
            vp, vp, vp, vp, vp, vp, vp,  # origin, direction, rng, t0, prim0, order, g_rad
            vp, i,  # words, tiles_in_smem
            vp, vp, vp, vp, vp, vp,  # d_fold, d_payload, d_lights, d_origin, d_direction, next_lane
            i, i, i, i, i, vp,
        ]
        lib.hpt_nee_vjp_launch.restype = i
        lib.hpt_nee_vjp_resources.argtypes = [i, i, i, i, i, i, i, i, i, vp, vp]
        lib.hpt_nee_vjp_resources.restype = i
        _lib = lib
    return _lib


def kernel_resources(tables: NE.NeeTables, residual: bool, has_glossy=False,
                     has_diel=False) -> dict:
    """What the card gives the backward's instance that a launch on these
    tables takes, in the residual or the replay mode
    (`ops/megakernel.py:resources`).  Raises when the card refuses the
    query."""
    def query(*args):
        err = _library().hpt_nee_vjp_resources(*args)
        if err != 0:
            raise RuntimeError(f"NEE backward resource query failed: cudaError {err}")

    return MK.resources(query, *tables.counts, tables.num_lights, int(has_glossy), int(has_diel),
                        int(residual), int(residual_tiles_in_smem(tables)))


# Scene leaves -------------------------------------------------------------


def _leaves(scene: Scene):
    """`diff/grad.py:scene_to_params(scene)` detached as tensors that
    require grad."""
    from ..diff.grad import scene_to_params

    return [t.detach().requires_grad_() for t in scene_to_params(scene)]


def _leaf_scene(leaves, template: Scene) -> Scene:
    from ..diff.grad import SceneParams, params_to_scene

    return params_to_scene(SceneParams(*leaves), template)


def table_grads_to_leaves(scene: Scene, light_idx, d_fold, d_payload, d_lights) -> dict:
    """The cotangents of `nee_scene_tables(scene, light_idx)` mapped back to
    the scene's leaves by autograd: {SceneParams field: gradient}."""
    from ..diff.grad import SceneParams

    if light_idx is None:
        light_idx = NE.scene_light_indices(scene)
    leaves = _leaves(scene)
    with torch.enable_grad():
        tabs = NE.nee_scene_tables(_leaf_scene(leaves, scene), light_idx)
        pairs = [(t, g) for t, g in ((tabs.fold, d_fold), (tabs.payload, d_payload),
                                     (tabs.lights, d_lights)) if t.requires_grad]
        grads = torch.autograd.grad([t for t, _ in pairs], leaves, [g for _, g in pairs],
                                    allow_unused=True)
    return {f: torch.zeros_like(x) if g is None else g
            for f, g, x in zip(SceneParams._fields, grads, leaves)}


# Plain versions: one bounce at the table level, the backward -------------


def _kinds(has_glossy, has_diel) -> frozenset:
    return frozenset({BRDF_MATTE} | ({BRDF_GLOSSY} if has_glossy else set())
                     | ({BRDF_DIELECTRIC} if has_diel else set()))


def bounce_reference(fold, payload, lights, counts, num_lights, o, d, th, t_det, prim,
                     prev_spec, u, us, occ, has_glossy=True, has_diel=True):
    """One bounce of the NEE kernel at the table level, on lanes [N]:
    continuous in the tables (fold, payload, lights) and the state (o, d,
    th [N, 3]); every decision given — the fold's (t_det, prim) of this
    bounce, prev_spec, the uniforms u and us [N, 3] and the shadow decision
    occ (bool [N]).  The kernel's arithmetic in the plain version's ops
    (`render/nee.py:_trace`): the winner's distance recomputed in closed
    form from its fold row, the payload row read by index.

    Returns (h, nd, nth, emission, nee, is_spec): the next origin,
    direction and throughput, the bounce's two radiance terms and whether
    its BSDF was specular."""
    from ..render import nee as RN

    ns, npl, nb, nt = counts
    if nb:
        raise ValueError("the NEE kernels' gradient does not take boxes")
    prim = prim.long()
    is_sph = prim < ns
    is_pl = (prim >= ns) & (prim < ns + npl)
    cols = torch.arange(12, device=fold.device)

    def rows(base, width, idx):
        return fold[(base + width * idx)[:, None] + cols[:width]]

    t = torch.zeros(prim.shape, dtype=torch.float32, device=o.device)
    for mask, part in ((is_sph, "sphere"), (is_pl, "plane"), (prim >= ns + npl + nb, "triangle")):
        idx = torch.nonzero(mask).reshape(-1)
        if not len(idx):
            continue
        oi, di = o[idx], d[idx]
        if part == "sphere":
            g = rows(0, 4, prim[idx])
            l = g[:, :3] - oi
            tca = linalg.dot(l, di)
            d2 = linalg.quadrance(l) - tca * tca
            r2 = g[:, 3]
            outside = d2 > r2
            thc = torch.where(
                outside, 0.0, linalg.sqrt(torch.where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12))))
            ti = tca - thc
        elif part == "plane":
            g = rows(4 * ns, 8, prim[idx] - ns)
            denom = linalg.dot(di, g[:, 3:6])
            num = linalg.dot(g[:, :3] - oi, g[:, 3:6])
            ti = num / torch.where(denom == 0.0, PLANE_DENOM_EPS * 0.5, denom)
        else:
            g = rows(4 * ns + 8 * npl + 8 * nb, 12, prim[idx] - ns - npl - nb)
            v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
            pvec = linalg.cross(di, e2)
            det = linalg.dot(e1, pvec)
            inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
            qvec = linalg.cross(oi - v0, e1)
            ti = linalg.dot(e2, qvec) * inv_det
        t = t.index_put((idx,), ti)
    hit = t_det < INFINITE
    t = torch.where(hit, t, 0.0)

    pay = payload[prim]
    aux, color, il = pay[:, 0:3], pay[:, 6:9], pay[:, 9]
    kind = torch.round(pay[:, 11]).to(torch.int32)
    h = o + d * t[:, None]
    n = torch.where(is_sph[:, None], linalg.normalize_safe(h - aux), aux)
    record = Hit(t=t, hit=hit, prim=prim, point=h, normal=n, color=color, illuminance=il,
                 brdf_kind=kind, brdf_param=pay[:, 10])

    emission = torch.where((prev_spec | is_pl)[:, None], (color * il[:, None]) * th, 0.0)
    _, nd, tmod, is_spec = RN._physical_bounce(
        record, d, u[:, 0], u[:, 1], u[:, 2], kinds=_kinds(has_glossy, has_diel))

    nee = torch.zeros_like(emission)
    if num_lights:
        L = float(num_lights)
        k = torch.clamp(torch.floor(us[:, 0] * L), 0.0, L - 1.0).long()
        row = lights[k]
        c, rad, e1, e2 = row[:, 5:8], row[:, 8], row[:, 9:12], row[:, 12:15]
        b, ipd = RN._cone_sample(c, rad, h, us[:, 1], us[:, 2])
        if nt:
            is_tl = row[:, 0] != 0.0
            dir_t, ip_t = RN._tri_area_sample_rows(c, e1, e2, h, us[:, 1], us[:, 2])
            b = torch.where(is_tl[:, None], dir_t, b)
            ipd = torch.where(is_tl, ip_t, ipd)
            t_l = torch.where(is_tl, RN._tri_t_rows(c, e1, e2, h, b), RN._sphere_t_single(h, b, c, rad))
        else:
            t_l = RN._sphere_t_single(h, b, c, rad)
        inv_pdf = torch.where(ipd > 1e-9, ipd * L, 0.0)
        cos_i = linalg.dot(b, n)
        w = ~occ & (t_l < INFINITE) & (kind == BRDF_MATTE) & (cos_i > 0.0)
        term = th * RN._div(color, RN.PI) * row[:, 2:5] * (cos_i * inv_pdf)[:, None]
        nee = torch.where(w[:, None], term, 0.0)
    return h, nd, th * tmod, emission, nee, is_spec


def trace_from_words(tables: NE.NeeTables, rays: Rays, rng, words, num_bounces: int, spp: int,
                     has_glossy=True, has_diel=True):
    """Plain version of the residual mode's replay: `spp` samples of the
    NEE estimator with every decision taken from the residual words
    [spp * num_bounces, lanes] int32 (lanes in the rays' order, as
    `launch_nee(record=True)` writes them in the raster frame): the winner
    and the shadow decision from the word, the distance recomputed from the
    winner's fold row, a path ending at its first word without LIVE_BIT
    (what follows is not read).  No fold runs.  Returns (radiance sum
    [..., 3], rng [..., 4]), differentiable in the tables and the rays."""
    shape = rays.origin.shape[:-1]
    o0, d0 = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    rng = rng.reshape(-1, 4)
    words = words.reshape(spp * num_bounces, -1)
    acc = torch.zeros_like(o0)
    for s in range(spp):
        o, d, th = o0, d0, torch.ones_like(o0)
        prev_spec = torch.ones(o0.shape[:1], dtype=torch.bool, device=o0.device)
        alive = torch.ones_like(prev_spec)
        for b in range(num_bounces):
            w = words[s * num_bounces + b]
            alive = alive & ((w & NE.LIVE_BIT) != 0)
            prim = torch.where(alive, w >> NE.PRIM_SHIFT, 0)
            un, rng2 = rng_ops.gen_vec(rng)
            un2, rng2 = rng_ops.gen_vec(rng2)
            h, nd, nth, emission, nee, is_spec = bounce_reference(
                tables.fold, tables.payload, tables.lights, tables.counts, tables.num_lights,
                o, d, th, torch.where(alive, 0.0, INFINITE), prim, prev_spec,
                (un + 1.0) * 0.5, (un2 + 1.0) * 0.5, (w & NE.OCC_BIT) != 0, has_glossy, has_diel)
            a3 = alive[:, None]
            acc = acc + torch.where(a3, emission + nee, 0.0)
            o, d, th = torch.where(a3, h, o), torch.where(a3, nd, d), torch.where(a3, nth, th)
            prev_spec = torch.where(alive, is_spec, prev_spec)
            rng = torch.where(a3, rng2, rng)
    return acc.reshape(*shape, 3), rng.reshape(*shape, 4)


def backward_reference(scene: Scene, rays: Rays, rng, g_rad, num_bounces: int, spp: int,
                       kinds=None, words=None):
    """Plain version of the backward kernel: autograd of
    `trace_physical_nee_reference`, one sample at a time (each sample
    starts from the rng the one before it left); with `words`, the residual
    mode's: autograd of `trace_from_words`, every decision taken from the
    words.  Returns ({SceneParams field: gradient}, d_origin,
    d_direction)."""
    from ..diff.grad import SceneParams
    from ..render import nee as RN

    leaves = _leaves(scene)
    o = rays.origin.detach().requires_grad_()
    d = rays.direction.detach().requires_grad_()
    total = [torch.zeros_like(x) for x in (*leaves, o, d)]
    if kinds is None:
        kinds = RN._present_kinds(scene)
    passes = []
    if words is not None:
        light_idx = NE.scene_light_indices(scene)
        with torch.enable_grad():
            tabs = NE.nee_scene_tables(_leaf_scene(leaves, scene), light_idx)
            rad, _ = trace_from_words(tabs, Rays(origin=o, direction=d), rng, words, num_bounces,
                                      spp, BRDF_GLOSSY in kinds, BRDF_DIELECTRIC in kinds)
            passes.append(torch.autograd.grad(rad, [*leaves, o, d], g_rad, allow_unused=True))
    else:
        for _ in range(spp):
            with torch.enable_grad():
                rad, rng, _ = RN._trace(_leaf_scene(leaves, scene), Rays(origin=o, direction=d), rng,
                                        num_bounces, True, kinds)
                passes.append(torch.autograd.grad(rad, [*leaves, o, d], g_rad, allow_unused=True))
    for grads in passes:
        for acc, x in zip(total, grads):
            if x is not None:
                acc += x
    return dict(zip(SceneParams._fields, total[:-2])), total[-2], total[-1]


# The CUDA kernel ----------------------------------------------------------


def records_residuals(pixels: int, spp: int, num_bounces: int, num_lights: int) -> bool:
    """Whether the gradient's forward records residual words: when they
    take at most RESIDUAL_MAX_BYTES and the backward's light tile (64 B per
    emitter row, one row without emitters) at most
    RESIDUAL_LIGHT_TILE_MAX_BYTES."""
    return 4 * pixels * spp * num_bounces <= RESIDUAL_MAX_BYTES and _light_tile_fits(num_lights)


def _light_tile_fits(num_lights: int) -> bool:
    return 64 * max(num_lights, 1) <= RESIDUAL_LIGHT_TILE_MAX_BYTES


def residual_tiles_in_smem(tables: NE.NeeTables) -> bool:
    """Whether the residual mode may sum the fold and payload cotangents in
    shared-memory tiles: when all three tiles fit in
    RESIDUAL_TILE_MAX_BYTES."""
    entries = tables.fold.numel() + tables.payload.numel() + tables.lights.numel()
    return 4 * entries <= RESIDUAL_TILE_MAX_BYTES


def launch_nee_backward(tables: NE.NeeTables, rays: Rays, rng, g_rad, num_bounces, spp,
                        has_glossy=True, has_diel=True, order=None, primary=None, words=None):
    """Launch the backward kernel: the cotangents (d_fold, d_payload,
    d_lights, d_origin, d_direction) of the radiance sum's cotangent `g_rad`
    [H, W, 3] for the trace `ops/nee.py:launch_nee` runs on the same
    operands (`order` and `primary` as there).  With `words`, the residual
    words that `launch_nee(..., record=True)` wrote with the same `order`,
    the residual mode, which runs no fold and does not read `primary`;
    without, the replay mode, which records each chunk's words itself.
    Either mode places its cotangent tiles by `residual_tiles_in_smem`.
    Checks every operand, launches on the current stream without
    synchronising and counts the launch in LAUNCHES, and in
    RESIDUAL_LAUNCHES with `words`."""
    global LAUNCHES, RESIDUAL_LAUNCHES
    device = rng.device
    if not rng.is_cuda:
        raise ValueError(f"launch_nee_backward takes CUDA tensors, not {device}")
    H, W = rng.shape[:2]
    NE._check_tables(tables, device)
    if tables.counts[2]:
        raise ValueError("the NEE backward kernel does not take boxes")
    if min(spp, num_bounces) < 0:
        raise ValueError("spp and num_bounces must be >= 0")
    if num_bounces > MAX_BOUNCES:
        raise ValueError(
            f"the NEE backward kernel refused num_bounces={num_bounces}: its replay keeps at "
            f"most {MAX_BOUNCES} bounces (kMaxBounces, csrc/nee_megakernel_vjp.cu)")
    MK._check("rng", rng, torch.int32, (H, W, 4), device)
    MK._check("rays.origin", rays.origin, torch.float32, (H, W, 3), device)
    MK._check("rays.direction", rays.direction, torch.float32, (H, W, 3), device)
    MK._check("g_rad", g_rad, torch.float32, (H, W, 3), device)
    if order is not None:
        MK._check("order", order, torch.int32, (H * W,), device)
    t0 = prim0 = None
    if primary is not None:
        t0, prim0 = primary
        MK._check("t0", t0, torch.float32, (H, W), device)
        MK._check("prim0", prim0, torch.int32, (H, W), device)
    if words is not None:
        MK._check("words", words, torch.int32, (spp * num_bounces, H * W), device)
        if not _light_tile_fits(tables.num_lights):
            raise ValueError(f"the residual mode's light tile does not hold {tables.num_lights} "
                             f"emitter rows (RESIDUAL_LIGHT_TILE_MAX_BYTES)")
    d_fold = torch.zeros_like(tables.fold)
    d_payload = torch.zeros_like(tables.payload)
    d_lights = torch.zeros_like(tables.lights)
    d_origin = torch.empty((H, W, 3), dtype=torch.float32, device=device)
    d_direction = torch.empty((H, W, 3), dtype=torch.float32, device=device)
    # The replay mode's warps take their lanes from this counter.
    next_lane = torch.zeros(1, dtype=torch.int32, device=device) if words is None else None
    err = _library().hpt_nee_vjp_launch(
        tables.fold.data_ptr(), tables.payload.data_ptr(), tables.lights.data_ptr(),
        *tables.counts, tables.num_lights,
        rays.origin.data_ptr(), rays.direction.data_ptr(), rng.data_ptr(),
        NE._ptr(t0), NE._ptr(prim0), NE._ptr(order), g_rad.data_ptr(),
        NE._ptr(words), int(residual_tiles_in_smem(tables)),
        d_fold.data_ptr(), d_payload.data_ptr(), d_lights.data_ptr(),
        d_origin.data_ptr(), d_direction.data_ptr(), NE._ptr(next_lane),
        H * W, spp, num_bounces, int(has_glossy), int(has_diel),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the NEE backward kernel refused its operands: counts {tables.counts}, "
                         f"num_bounces={num_bounces}")
    if err != 0:
        raise RuntimeError(f"NEE backward kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    RESIDUAL_LAUNCHES += int(words is not None)
    return d_fold, d_payload, d_lights, d_origin, d_direction


class TracePhysicalNeeDiff(torch.autograd.Function):
    """(radiance sum [H, W, 3], rng_out [H, W, 4]) of `spp` NEE samples,
    differentiable in (fold, payload, lights, origin, direction), on CUDA
    tensors: the forward is `ops/nee.py:launch_nee`, the backward
    `launch_nee_backward` (with the lane order and the probe's primary hit
    when given).  With `record` the forward is the recording instance and
    the backward the residual mode, on the words the forward saved; else
    the production instance and the replay mode."""

    @staticmethod
    def forward(ctx, fold, payload, lights, origin, direction, rng, tables, num_bounces, spp,
                has_glossy, has_diel, order=None, primary=None, record=False):
        tabs = dataclasses.replace(tables, fold=fold, payload=payload, lights=lights)
        rays = Rays(origin=origin, direction=direction)
        out = NE.launch_nee(tabs, rays, rng, num_bounces, spp, has_glossy, has_diel,
                            order=order, primary=primary, record=record)
        radiance, rng_out = out[:2]
        words = out[2] if record else None
        t0, prim0 = primary if primary is not None else (None, None)
        ctx.save_for_backward(fold, payload, lights, origin, direction, rng, order, t0, prim0,
                              words)
        ctx.config = (tables, num_bounces, spp, has_glossy, has_diel)
        ctx.mark_non_differentiable(rng_out)
        return radiance, rng_out

    @staticmethod
    def backward(ctx, g_rad, _g_rng):
        fold, payload, lights, origin, direction, rng, order, t0, prim0, words = ctx.saved_tensors
        tables, num_bounces, spp, has_glossy, has_diel = ctx.config
        tabs = dataclasses.replace(tables, fold=fold, payload=payload, lights=lights)
        rays = Rays(origin=origin, direction=direction)
        grads = launch_nee_backward(
            tabs, rays, rng, g_rad.contiguous(), num_bounces, spp, has_glossy, has_diel,
            order=order, primary=None if t0 is None else (t0, prim0), words=words)
        return (*grads, None, None, None, None, None, None, None, None, None)


def sorted_default(scene: Scene) -> bool:
    """sorted_lanes=None's choice: the sorted frame from the forward's
    presort gate on, `ops/nee.py:PRESORT_MIN_SPHERES` spheres.  The TPU's
    gate added n * spp >= 2^22; on the H100 the sorted frame was the faster
    at both of suite config 7's shapes, 512x512 x 1 spp included (PERF.md)."""
    return scene.spheres.count >= NE.PRESORT_MIN_SPHERES


def trace_physical_nee_diff(scene: Scene, rays: Rays, rng, num_bounces: int = 8, spp: int = 1,
                            light_idx=None, kinds=None, sorted_lanes: bool | None = None):
    """Differentiable NEE trace: (radiance sum [H, W, 3], rng_out
    [H, W, 4]) with gradients to every continuous sphere, plane and
    triangle leaf (through `nee_scene_tables`) and to the primary rays; the
    rng is a constant.  `light_idx` (`scene_light_indices`) freezes the
    emitter set; `kinds` elides absent BRDF branches (both read from the
    scene when None).

    CUDA tensors go through `TracePhysicalNeeDiff`: one NEE launch forward
    (the recording instance when a gradient can follow and
    `records_residuals`), one backward launch (the residual mode then,
    else the replay mode), and with `sorted_lanes` one probe launch that
    both share (None: `sorted_default`).  CPU tensors run the plain
    version, `trace_physical_nee_reference`, under autograd."""
    from ..render.nee import _present_kinds

    if scene.boxes.count:
        raise ValueError("the NEE gradient kernels do not take boxes: use diff/grad.py's "
                         "backend='torch'")
    if not NE.nee_eligible(scene):
        raise ValueError(f"the NEE kernels take 0 < spheres < 2^24; this scene has "
                         f"{scene.spheres.count}")
    if kinds is None:
        kinds = _present_kinds(scene)
    if not rng.is_cuda:
        return NE.trace_physical_nee_reference(scene, rays, rng, num_bounces, spp, kinds)
    if light_idx is None:
        light_idx = NE.scene_light_indices(scene)
    tables = NE.nee_scene_tables(scene, light_idx)
    if sorted_lanes is None:
        sorted_lanes = sorted_default(scene)
    order = primary = None
    if sorted_lanes:
        with torch.no_grad():
            detached = dataclasses.replace(tables, fold=tables.fold.detach())
            t0, prim0 = NE.launch_probe(
                detached, Rays(origin=rays.origin.detach(), direction=rays.direction.detach()))
        order, primary = NE._presort_order(t0), (t0, prim0)
    H, W = rng.shape[:2]
    differentiable = torch.is_grad_enabled() and any(
        x.requires_grad for x in (tables.fold, tables.payload, tables.lights, rays.origin,
                                  rays.direction))
    return TracePhysicalNeeDiff.apply(
        tables.fold, tables.payload, tables.lights, rays.origin.contiguous(),
        rays.direction.contiguous(), rng, tables, num_bounces, spp,
        BRDF_GLOSSY in kinds, BRDF_DIELECTRIC in kinds, order, primary,
        differentiable and records_residuals(H * W, spp, num_bounces, tables.num_lights),
    )
