"""The inline parity megakernel: the whole sample x bounce loop in one launch.

Replaces ``haskell_path_tracer_tpu/ops/pallas_megakernel.py:_megakernel_body``
(launched there by ``trace_inline_pallas``).  On a CUDA tensor
`trace_inline_fused` launches the hand-written CUDA kernel in
``csrc/megakernel.cu``; on a CPU tensor it runs the plain PyTorch version,
`trace_inline_fused_reference`, which follows the TPU kernel's
``_bounce_core`` op for op on the same packed tables.

The kernel is bound by fp32 ALU and SFU work: about 6 sin/cos, 1 sqrt and
7 primitive tests per bounce in the reference scene.  The only memory
traffic is 40 B read and 28 B written per pixel per launch, so its design
keeps the loop state in registers and the scene tables in shared memory
(see the note at the top of the CUDA source).

The kernel is built at first use with nvcc into ``_build/`` beside this
package (a shared library with a plain C entry point, bound with ctypes)
and is named by a hash of its sources and flags, so a stale build is never
loaded.  The bounce itself lives in ``csrc/bounce.cuh``, which the backward
kernel (``ops/megakernel_vjp.py``) shares.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..models.objects import Rays, Scene
from ..core import linalg
from .intersect import EPSILON, INFINITE, PLANE_DENOM_EPS
from . import rng as rng_ops
from .brdf import INV_TWO_PI

PI = float(np.float32(np.pi))

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCE = os.path.join(CSRC, "megakernel.cu")
# Headers the kernel sources include; a library's name hashes them too.
HEADERS = (os.path.join(CSRC, "bounce.cuh"),)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
# Dynamic shared memory a block may take without opting in.
_SMEM_LIMIT = 48 * 1024

# Launches of the CUDA kernel by `trace_inline_fused` (one per call on CUDA
# tensors).  Callers reset it to 0 to count the launches of a run.
LAUNCHES = 0

_lib = None


# Table packing ----------------------------------------------------------


def _mat_rows8(m) -> torch.Tensor:
    z = torch.zeros_like(m.illuminance)
    return torch.stack(
        [
            m.color[:, 0], m.color[:, 1], m.color[:, 2],
            m.illuminance, m.brdf_param, m.brdf_kind.to(torch.float32),
            z, z,
        ],
        dim=-1,
    )


def scene_tables(scene: Scene):
    """Pack the scene into (geom [P, 8|16], mat [P, 8]) f32 tables — the
    layout of the JAX package's ``_scene_tables``.

    Sphere+plane scenes use 8 geometry columns, with scenes that have boxes
    or triangles widening to 16:

      sphere    [cx, cy, cz, radius, 0, 0, 0, 1]   (8 columns)
      sphere    [cx, cy, cz, radius, 0...]         (16 columns)
      plane     [px, py, pz, nx, ny, nz, 0...]
      box       [lox, loy, loz, hix, hiy, hiz, 0...]
      triangle  [v0(3), e1(3), e2(3), n_unit(3), |cross(e1, e2)|, 0...]
      mat       [cr, cg, cb, illuminance, brdf_param, brdf_kind, 0, 0]
    """
    sp, pl, bx, tr = scene.spheres, scene.planes, scene.boxes, scene.triangles
    mat = torch.cat(
        [_mat_rows8(part.material) for part in (sp, pl, bx, tr)], dim=0
    )
    if not (bx.count or tr.count):
        zs = torch.zeros_like(sp.radius)
        geom_s = torch.stack(
            [sp.pos[:, 0], sp.pos[:, 1], sp.pos[:, 2], sp.radius,
             zs, zs, zs, torch.ones_like(sp.radius)],
            dim=-1,
        )
        zp = torch.zeros_like(pl.pos[:, 0])
        geom_p = torch.cat([pl.pos, pl.normal, zp[:, None], zp[:, None]], -1)
        return torch.cat([geom_s, geom_p], dim=0), mat

    def pad(rows):
        return torch.cat([rows, rows.new_zeros(rows.shape[0], 16 - rows.shape[1])], -1)

    e1 = tr.v1 - tr.v0
    e2 = tr.v2 - tr.v0
    n = linalg.cross(e1, e2)
    n_norm = torch.sqrt(torch.clamp(linalg.quadrance(n), min=1e-20))
    geom = torch.cat(
        [
            pad(torch.cat([sp.pos, sp.radius[:, None]], -1)),
            pad(torch.cat([pl.pos, pl.normal], -1)),
            pad(torch.cat([bx.lo, bx.hi], -1)),
            pad(torch.cat([tr.v0, e1, e2, n / n_norm[:, None], n_norm[:, None]], -1)),
        ],
        dim=0,
    )
    return geom, mat


def primitive_counts(scene: Scene):
    """(spheres, planes, boxes, triangles): the row ranges of the tables."""
    return (scene.spheres.count, scene.planes.count, scene.boxes.count,
            scene.triangles.count)


def _resolve_has_dielectric(scene: Scene, has_dielectric):
    return scene.has_dielectric() if has_dielectric is None else bool(has_dielectric)


# Plain PyTorch version ---------------------------------------------------


def _nearest_hit_fold(geom, mat, counts, ox, oy, oz, dx, dy, dz):
    """Where-fold over the table rows (first index wins ties); returns a
    dict of hit planes, as the TPU kernel's `_nearest_hit_fold`, and the
    winner's row `best` (-1 where every row misses)."""
    ns, npl, nb, nt = counts
    where = torch.where
    best_t = torch.full_like(ox, INFINITE)
    zero = torch.zeros_like(ox)
    b_ax, b_ay, b_az = zero, zero, zero
    b_cr, b_cg, b_cb, b_il, b_pr, b_kd, b_sp = (zero,) * 7
    best = torch.full_like(ox, -1, dtype=torch.int64)
    for p in range(ns + npl + nb + nt):
        g, m = geom[p], mat[p]
        if p < ns:
            cx, cy, cz, rad = g[0], g[1], g[2], g[3]
            lx, ly, lz = cx - ox, cy - oy, cz - oz
            tca = lx * dx + ly * dy + lz * dz
            d2 = lx * lx + ly * ly + lz * lz - tca * tca
            r2 = rad * rad
            outside = d2 > r2
            thc_arg = where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12))
            thc = where(outside, 0.0, torch.sqrt(thc_arg))
            t = tca - thc
            miss = (tca < 0.0) | outside | (t < 0.0)
            t = where(miss, INFINITE, t)
            ax_, ay_, az_, is_sphere = cx, cy, cz, 1.0
        elif p < ns + npl:
            px, py, pz, nx, ny, nz = g[0], g[1], g[2], g[3], g[4], g[5]
            denom = dx * nx + dy * ny + dz * nz
            num = (px - ox) * nx + (py - oy) * ny + (pz - oz) * nz
            denom_safe = where(denom == 0.0, PLANE_DENOM_EPS * 0.5, denom)
            dist = num / denom_safe
            miss = (denom > PLANE_DENOM_EPS) | (dist < 0.0)
            t = where(miss, INFINITE, dist)
            ax_, ay_, az_, is_sphere = nx, ny, nz, 0.0
        elif p < ns + npl + nb:
            lox, loy, loz, hix, hiy, hiz = g[0], g[1], g[2], g[3], g[4], g[5]
            tiny = 1e-12

            def slab(lo, hi, o, d):
                d_safe = where(d.abs() < tiny, where(d < 0, -tiny, tiny), d)
                inv = 1.0 / d_safe
                t1 = (lo - o) * inv
                t2 = (hi - o) * inv
                return torch.minimum(t1, t2), torch.maximum(t1, t2)

            x_lo, x_hi = slab(lox, hix, ox, dx)
            y_lo, y_hi = slab(loy, hiy, oy, dy)
            z_lo, z_hi = slab(loz, hiz, oz, dz)
            t_near = torch.maximum(x_lo, torch.maximum(y_lo, z_lo))
            t_far = torch.minimum(x_hi, torch.minimum(y_hi, z_hi))
            miss = (t_near > t_far) | (t_near <= 0.0)
            t = where(miss, INFINITE, t_near)
            t_box = where(miss, 0.0, t_near)
            qx = (ox + dx * t_box - (lox + hix) * 0.5) / torch.clamp((hix - lox) * 0.5, min=1e-12)
            qy = (oy + dy * t_box - (loy + hiy) * 0.5) / torch.clamp((hiy - loy) * 0.5, min=1e-12)
            qz = (oz + dz * t_box - (loz + hiz) * 0.5) / torch.clamp((hiz - loz) * 0.5, min=1e-12)
            aqx, aqy, aqz = qx.abs(), qy.abs(), qz.abs()
            takex = (aqx >= aqy) & (aqx >= aqz)
            takey = ~takex & (aqy >= aqz)
            ax_ = where(takex, torch.sign(qx), 0.0)
            ay_ = where(takey, torch.sign(qy), 0.0)
            az_ = where(takex | takey, 0.0, torch.sign(qz))
            is_sphere = 0.0
        else:
            v0x, v0y, v0z = g[0], g[1], g[2]
            e1x, e1y, e1z = g[3], g[4], g[5]
            e2x, e2y, e2z = g[6], g[7], g[8]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / where(det.abs() < 1e-30, 1e-30, det)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            miss = (
                (det <= PLANE_DENOM_EPS * g[12])
                | (u < 0.0) | (v < 0.0) | (u + v > 1.0) | (t < 0.0)
            )
            t = where(miss, INFINITE, t)
            ax_, ay_, az_, is_sphere = g[9], g[10], g[11], 0.0

        better = t < best_t
        best_t = where(better, t, best_t)
        b_ax = where(better, ax_, b_ax)
        b_ay = where(better, ay_, b_ay)
        b_az = where(better, az_, b_az)
        b_cr = where(better, m[0], b_cr)
        b_cg = where(better, m[1], b_cg)
        b_cb = where(better, m[2], b_cb)
        b_il = where(better, m[3], b_il)
        b_pr = where(better, m[4], b_pr)
        b_kd = where(better, m[5], b_kd)
        b_sp = where(better, is_sphere, b_sp)
        best = where(better, p, best)

    hit = best_t < INFINITE
    t_safe = where(hit, best_t, 0.0)
    hx, hy, hz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    sx, sy, sz = hx - b_ax, hy - b_ay, hz - b_az
    sq = sx * sx + sy * sy + sz * sz
    sq_ok = sq > 1e-20
    inv = where(sq_ok, 1.0 / torch.sqrt(where(sq_ok, sq, 1.0)), 1e20)
    is_s = b_sp > 0.5
    return dict(
        hit=hit, hx=hx, hy=hy, hz=hz,
        nx=where(is_s, sx * inv, b_ax),
        ny=where(is_s, sy * inv, b_ay),
        nz=where(is_s, sz * inv, b_az),
        cr=b_cr, cg=b_cg, cb=b_cb, il=b_il, pr=b_pr, kd=b_kd, best=best,
    )


def _brdf_sample_from_vec(h, dx, dy, dz, vx, vy, vz, has_dielectric):
    """The TPU kernel's `_brdf_sample_from_vec`: (next origin x3, next
    direction x3, throughput modifier x3)."""
    where = torch.where
    nx, ny, nz, p = h["nx"], h["ny"], h["nz"], h["pr"]

    # linalg's quaternion functions evaluate the kernel's expressions term
    # for term on stacked [..., 3] tensors.
    v = torch.stack([vx, vy, vz], dim=-1)

    def rot(angles, x, y, z):
        q = linalg.angles_to_quaternion(angles)
        return linalg.quat_rotate(q, torch.stack([x, y, z], dim=-1)).unbind(-1)

    mx, my, mz = rot(PI * v, nx, ny, nz)
    m_b = p / PI * (mx * nx + my * ny + mz * nz)

    ia = dx * nx + dy * ny + dz * nz
    rx, ry, rz = dx - 2.0 * ia * nx, dy - 2.0 * ia * ny, dz - 2.0 * ia * nz
    gx, gy, gz = rot((1.0 - p)[..., None] * v, rx, ry, rz)
    g_b = torch.clamp(gx * rx + gy * ry + gz * rz, min=0.0)

    kd = h["kd"]
    is_g = kd == 1.0
    ox2, oy2, oz2 = where(is_g, gx, mx), where(is_g, gy, my), where(is_g, gz, mz)
    scale = where(is_g, g_b, m_b) * INV_TWO_PI
    if has_dielectric:
        cos_i = -(dx * nx + dy * ny + dz * nz)
        inside = cos_i < 0.0
        fnx, fny, fnz = where(inside, -nx, nx), where(inside, -ny, ny), where(inside, -nz, nz)
        aci = cos_i.abs()
        eta = where(inside, p, 1.0 / torch.clamp(p, min=1e-6))
        sin2 = eta * eta * torch.clamp(1.0 - aci * aci, min=0.0)
        tir = sin2 > 1.0
        cos_t = where(
            tir, 0.0,
            torch.sqrt(where(tir, 1.0, torch.clamp(1.0 - sin2, min=1e-12))),
        )
        r0 = (1.0 - p) / (1.0 + p)
        r0 = r0 * r0
        c1 = 1.0 - aci
        c2 = c1 * c1
        fres = r0 + (1.0 - r0) * (c1 * (c2 * c2))
        refl_p = where(tir, 1.0, fres)
        take_refl = (vx + 1.0) * 0.5 < refl_p
        k = eta * aci - cos_t
        tx_, ty_, tz_ = eta * dx + k * fnx, eta * dy + k * fny, eta * dz + k * fnz
        tq = tx_ * tx_ + ty_ * ty_ + tz_ * tz_
        tq_ok = tq > 1e-20
        tinv = where(tq_ok, 1.0 / torch.sqrt(where(tq_ok, tq, 1.0)), 1e20)
        is_d = kd == 2.0
        ox2 = where(is_d, where(take_refl, rx, tx_ * tinv), ox2)
        oy2 = where(is_d, where(take_refl, ry, ty_ * tinv), oy2)
        oz2 = where(is_d, where(take_refl, rz, tz_ * tinv), oz2)
        scale = where(is_d, 1.0, scale)

    return (
        h["hx"] + ox2 * EPSILON, h["hy"] + oy2 * EPSILON, h["hz"] + oz2 * EPSILON,
        ox2, oy2, oz2,
        h["cr"] * scale, h["cg"] * scale, h["cb"] * scale,
    )


def bounce_reference(geom, mat, counts, o, d, th, v, has_dielectric):
    """One bounce of the plain version — the TPU kernel's `_bounce_core` —
    on [H, W] planes: the ray o, d (3 planes each), throughput th and
    random vector v.  Returns (next origin, next direction, next
    throughput, emission) as 3-plane tuples, and the dead mask.  A dead
    lane keeps its ray, adds no emission and zeroes its throughput."""
    where = torch.where
    ox, oy, oz = o
    dx, dy, dz = d
    th_r, th_g, th_b = th
    vx, vy, vz = v
    h = _nearest_hit_fold(geom, mat, counts, ox, oy, oz, dx, dy, dz)
    q = th_r * th_r + th_g * th_g + th_b * th_b
    dead = (q <= linalg.NEAR_ZERO_EPS) | ~h["hit"]
    (no_x, no_y, no_z, nd_x, nd_y, nd_z, tm_r, tm_g, tm_b) = (
        _brdf_sample_from_vec(h, dx, dy, dz, vx, vy, vz, has_dielectric)
    )
    em = (
        where(dead, 0.0, h["cr"] * h["il"] * th_r),
        where(dead, 0.0, h["cg"] * h["il"] * th_g),
        where(dead, 0.0, h["cb"] * h["il"] * th_b),
    )
    nth = (
        where(dead, 0.0, th_r * tm_r),
        where(dead, 0.0, th_g * tm_g),
        where(dead, 0.0, th_b * tm_b),
    )
    no = (where(dead, ox, no_x), where(dead, oy, no_y), where(dead, oz, no_z))
    nd = (where(dead, dx, nd_x), where(dead, dy, nd_y), where(dead, dz, nd_z))
    return no, nd, nth, em, dead


def trace_tables_reference(
    geom, mat, counts, rays: Rays, rng: torch.Tensor, num_bounces: int,
    spp: int, russian_roulette: bool, rr_start: int, has_dielectric: bool,
):
    """Plain PyTorch version of the megakernel at the table level: packed
    (geom, mat) tables (`scene_tables`), the per-kind `counts`, and
    [H, W] planes.  Differentiable in geom, mat and the rays, with every
    decision detached, so autograd through it is the plain version of the
    backward kernel (ops/megakernel_vjp.py).

    Returns (radiance sum over `spp` samples [H, W, 3] f32, final rng
    [H, W, 4] int32)."""
    where = torch.where
    po = rays.origin.unbind(-1)
    pd = rays.direction.unbind(-1)
    acc_r = acc_g = acc_b = torch.zeros_like(po[0])
    for _ in range(spp):
        o, d = po, pd
        res_r = res_g = res_b = torch.zeros_like(po[0])
        th = (torch.ones_like(po[0]),) * 3
        for i in range(num_bounces):
            v, rng2 = rng_ops.gen_vec(rng)
            o, d, nth, em, dead = bounce_reference(
                geom, mat, counts, o, d, th, v.unbind(-1), has_dielectric
            )
            if russian_roulette:
                nth_r, nth_g, nth_b = nth
                u, rng2 = rng_ops.sfc32_float(rng2)
                p_surv = torch.clamp(
                    torch.maximum(nth_r, torch.maximum(nth_g, nth_b)), 0.05, 1.0
                )
                if i >= rr_start:
                    killed = u >= p_surv
                    scale = 1.0 / p_surv
                    nth = (
                        where(killed, 0.0, nth_r * scale),
                        where(killed, 0.0, nth_g * scale),
                        where(killed, 0.0, nth_b * scale),
                    )
            rng = where(dead[..., None], rng, rng2)
            res_r, res_g, res_b = res_r + em[0], res_g + em[1], res_b + em[2]
            th = nth
        acc_r, acc_g, acc_b = acc_r + res_r, acc_g + res_g, acc_b + res_b
    return torch.stack([acc_r, acc_g, acc_b], dim=-1), rng


def trace_inline_fused_reference(
    scene: Scene,
    rays: Rays,
    rng: torch.Tensor,
    num_bounces: int = 15,
    spp: int = 1,
    russian_roulette: bool = False,
    rr_start: int = 3,
    has_dielectric: bool | None = None,
):
    """Plain PyTorch version of the megakernel on [H, W] planes: the scene's
    tables through `trace_tables_reference`.

    Returns (radiance sum over `spp` samples [H, W, 3] f32, final rng
    [H, W, 4] int32).  `has_dielectric=None` reads the scene's kinds."""
    return trace_tables_reference(
        *scene_tables(scene), primitive_counts(scene), rays, rng, num_bounces,
        spp, russian_roulette, rr_start,
        _resolve_has_dielectric(scene, has_dielectric),
    )


# The CUDA kernel ---------------------------------------------------------


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return nvcc


def library_file(source: str, stem: str, headers=HEADERS) -> str:
    """The path of `source`'s built library: `stem` and a hash of the
    source, the headers it includes and the flags."""
    digest = hashlib.sha256()
    for path in (source, *headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_library(source: str, stem: str, headers=HEADERS) -> str:
    """Compile `source` for sm_90a unless its library exists; returns its
    path.  Raises on a failed build."""
    path = library_file(source, stem, headers)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def library_path() -> str:
    return library_file(SOURCE, "megakernel")


def build() -> str:
    """Compile csrc/megakernel.cu unless this source's library exists."""
    return build_library(SOURCE, "megakernel")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.hpt_megakernel_launch.argtypes = [
            vp, i, vp, i, i, i, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp,
        ]
        lib.hpt_megakernel_launch.restype = i
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_kernel(geom, mat, counts, rays, rng, num_bounces, spp,
                  russian_roulette, rr_start, has_dielectric):
    """Launch the CUDA kernel on packed tables (`scene_tables`) and the
    per-kind primitive `counts` (spheres, planes, boxes, triangles).
    Checks every operand, allocates the outputs, launches on the current
    stream without synchronising and counts the launch in `LAUNCHES`."""
    global LAUNCHES
    device = rng.device
    H, W = rng.shape[:2]
    P = sum(counts)
    _check("rng", rng, torch.int32, (H, W, 4), device)
    _check("rays.origin", rays.origin, torch.float32, (H, W, 3), device)
    _check("rays.direction", rays.direction, torch.float32, (H, W, 3), device)
    _check("geom", geom, torch.float32, (P, geom.shape[1]), device)
    _check("mat", mat, torch.float32, (P, 8), device)
    if geom.shape[1] not in (8, 16):
        raise ValueError(f"geom has {geom.shape[1]} columns, expected 8 or 16")
    if 4 * P * (geom.shape[1] + 8) > _SMEM_LIMIT:
        raise ValueError(f"{P} primitives exceed the kernel's shared-memory tables")
    if min(spp, num_bounces) < 0:
        raise ValueError("spp and num_bounces must be >= 0")
    radiance = torch.empty((H, W, 3), dtype=torch.float32, device=device)
    rng_out = torch.empty((H, W, 4), dtype=torch.int32, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.hpt_megakernel_launch(
        geom.data_ptr(), geom.shape[1], mat.data_ptr(), *counts,
        rays.origin.data_ptr(), rays.direction.data_ptr(), rng.data_ptr(),
        radiance.data_ptr(), rng_out.data_ptr(),
        H * W, spp, num_bounces, int(russian_roulette), rr_start,
        int(has_dielectric), stream,
    )
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return radiance, rng_out


def trace_inline_fused(
    scene: Scene,
    rays: Rays,
    rng: torch.Tensor,
    num_bounces: int = 15,
    spp: int = 1,
    russian_roulette: bool = False,
    rr_start: int = 3,
    has_dielectric: bool | None = None,
):
    """`spp` samples of the inline parity trace, summed: (radiance [H, W, 3]
    f32, final rng [H, W, 4] int32).

    CUDA tensors launch the CUDA kernel (and count in `LAUNCHES`); CPU
    tensors run `trace_inline_fused_reference`.  `has_dielectric=False`
    skips the glass block, which draws no uniforms, so it changes nothing
    on glass-free scenes; None reads the scene's kinds."""
    if not rng.is_cuda:
        return trace_inline_fused_reference(
            scene, rays, rng, num_bounces, spp, russian_roulette, rr_start,
            has_dielectric,
        )
    has_dielectric = _resolve_has_dielectric(scene, has_dielectric)
    return launch_kernel(*scene_tables(scene), primitive_counts(scene), rays, rng,
                         num_bounces, spp, russian_roulette, rr_start,
                         has_dielectric)
