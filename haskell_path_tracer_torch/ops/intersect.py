"""Vectorized ray-primitive intersection and nearest-hit resolution.

Counterpart of ``haskell_path_tracer_tpu/ops/intersect.py``, with the
reference's accept/reject rules:

  * sphere: miss when `tca < 0` (center behind the origin), `d2 > r^2`
    (the ray passes outside) or `t = tca - thc < 0` (origin inside);
  * plane: one-sided — miss when `denom > 1e-6` or `dist < 0`;
  * box: branchless slabs, only the entry face hits;
  * triangle: Möller–Trumbore with the plane's one-sided rule, scaled by
    the triangle's |cross(e1, e2)|.

Misses encode as `t = INFINITE` (f32 max).  Nearest-hit ties go to the
lowest primitive index, in the order spheres ++ planes ++ boxes ++
triangles.  The hit payload is read with an index gather of the winner's
row (the JAX package's one-hot matmul existed for the TPU's matrix unit).

Above `CHUNKED_THRESHOLD` primitives the spheres are folded in chunks of
`CHUNK_SIZE` (a strict `<` between chunks keeps the first index on ties)
and the other kinds merged after them in index order: the JAX package's
XLA fallback, in plain tensor ops.  `sphere_occluded_any` and
`shadow_occluded` are the physical/NEE family's shadow test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import linalg
from ..models.objects import Planes, Scene, Spheres

INFINITE = float(np.finfo(np.float32).max)

# Self-intersection offset of the next ray's origin.
EPSILON = float(np.float32(0.002))

PLANE_DENOM_EPS = float(np.float32(1e-6))

# Above this primitive count the sphere fold runs in chunks of CHUNK_SIZE,
# so no [rays, P] distance plane is materialised.
CHUNKED_THRESHOLD = 128
CHUNK_SIZE = 128


def sphere_distances(ray_o, ray_d, spheres: Spheres, reject_below=0.0):
    """Distances from rays [..., 3] to every sphere: [..., N], misses =
    INFINITE.  The sqrt's argument is pinned on miss lanes (double where),
    so masked lanes stay finite."""
    l = spheres.pos - ray_o[..., None, :]  # [..., N, 3]
    tca = linalg.dot(l, ray_d[..., None, :])
    d2 = linalg.quadrance(l) - tca * tca
    r2 = spheres.radius * spheres.radius
    outside = d2 > r2
    thc_arg = torch.where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12))
    thc = torch.where(outside, 0.0, linalg.sqrt(thc_arg))
    t = tca - thc
    miss = (tca < reject_below) | outside | (t < reject_below)
    return torch.where(miss, INFINITE, t)


def plane_distances(ray_o, ray_d, planes: Planes, reject_below=0.0):
    """Distances from rays [..., 3] to every one-sided plane: [..., M]."""
    denom = linalg.dot(ray_d[..., None, :], planes.normal)
    num = linalg.dot(planes.pos - ray_o[..., None, :], planes.normal)
    # Only exact zeros are displaced (their 0/0 would give NaN); grazing
    # rays still hit at huge distances, as in the reference.
    denom_safe = torch.where(denom == 0.0, PLANE_DENOM_EPS * 0.5, denom)
    dist = num / denom_safe
    miss = (denom > PLANE_DENOM_EPS) | (dist < reject_below)
    return torch.where(miss, INFINITE, dist)


def box_distances(ray_o, ray_d, boxes, reject_below=0.0):
    """Distances from rays [..., 3] to every axis-aligned box: [..., N]."""
    o = ray_o[..., None, :]
    d = ray_d[..., None, :]
    tiny = 1e-12
    d_safe = torch.where(
        d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d
    )
    inv = 1.0 / d_safe
    t1 = (boxes.lo - o) * inv  # [..., N, 3]
    t2 = (boxes.hi - o) * inv
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    miss = (t_near > t_far) | (t_near <= 0.0) | (t_near < reject_below)
    return torch.where(miss, INFINITE, t_near)


def box_normal(point, lo, hi):
    """Outward normal of the box face containing `point`: the dominant axis
    of the centered, half-size-normalized offset (x wins ties)."""
    center = (lo + hi) * 0.5
    half = torch.clamp((hi - lo) * 0.5, min=1e-12)
    q = (point - center) / half
    axis = q.abs().argmax(dim=-1, keepdim=True)
    onehot = torch.zeros_like(q).scatter_(-1, axis, 1.0)
    return onehot * torch.sign(torch.gather(q, -1, axis))


def triangle_distances(ray_o, ray_d, tris, reject_below=0.0):
    """Distances from rays [..., 3] to every triangle: [..., N]."""
    e1 = tris.v1 - tris.v0
    e2 = tris.v2 - tris.v0
    d = ray_d[..., None, :]
    pvec = linalg.cross(d, e2)
    det = linalg.dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
    tvec = ray_o[..., None, :] - tris.v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(d, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    # det scales with twice the triangle's area: compare the front-face
    # test against eps * |cross(e1, e2)|, the plane's dot(d, n) rule.
    n_norm = linalg.norm(linalg.cross(e1, e2))
    miss = (
        (det <= PLANE_DENOM_EPS * n_norm)
        | (u < 0.0)
        | (v < 0.0)
        | (u + v > 1.0)
        | (t < reject_below)
    )
    return torch.where(miss, INFINITE, t)


@dataclass(frozen=True)
class Hit:
    """Per-ray nearest-hit record; every field has the rays' leading shape."""

    t: torch.Tensor  # [...] f32, INFINITE on miss
    hit: torch.Tensor  # [...] bool
    prim: torch.Tensor  # [...] int64 index into spheres ++ planes ++ ...
    point: torch.Tensor  # [..., 3]
    normal: torch.Tensor  # [..., 3]
    color: torch.Tensor  # [..., 3]
    illuminance: torch.Tensor  # [...]
    brdf_kind: torch.Tensor  # [...] int32
    brdf_param: torch.Tensor  # [...]


def _payload_table(scene: Scene) -> torch.Tensor:
    """Per-primitive rows [P, 12]: aux(3) = sphere center | plane normal |
    box lo | triangle unit normal, aux2(3) = box hi (zeros otherwise),
    color(3), illuminance, brdf_param, brdf_kind."""

    def rows(aux, aux2, mat):
        return torch.cat(
            [
                aux,
                torch.zeros_like(aux) if aux2 is None else aux2,
                mat.color,
                mat.illuminance[:, None],
                mat.brdf_param[:, None],
                mat.brdf_kind.to(torch.float32)[:, None],
            ],
            dim=-1,
        )

    tr = scene.triangles
    tri_n = linalg.normalize_safe(linalg.cross(tr.v1 - tr.v0, tr.v2 - tr.v0))
    return torch.cat(
        [
            rows(scene.spheres.pos, None, scene.spheres.material),
            rows(scene.planes.normal, None, scene.planes.material),
            rows(scene.boxes.lo, scene.boxes.hi, scene.boxes.material),
            rows(tri_n, None, tr.material),
        ],
        dim=0,
    )


def _nearest_t_prim_small(ray_o, ray_d, scene: Scene, reject_below=0.0):
    """One [rays, P] distance plane, its min, and the first index at it."""
    all_t = torch.cat(
        [
            sphere_distances(ray_o, ray_d, scene.spheres, reject_below),
            plane_distances(ray_o, ray_d, scene.planes, reject_below),
            box_distances(ray_o, ray_d, scene.boxes, reject_below),
            triangle_distances(ray_o, ray_d, scene.triangles, reject_below),
        ],
        dim=-1,
    )
    num_prims = all_t.shape[-1]
    t = all_t.amin(dim=-1)
    iota = torch.arange(num_prims, device=all_t.device)
    prim = torch.where(all_t == t[..., None], iota, num_prims).amin(dim=-1)
    return t, torch.clamp(prim, max=num_prims - 1)


def _first_min(dists):
    """(min over the trailing axis, the first index at it)."""
    k = dists.shape[-1]
    kt = dists.amin(dim=-1)
    iota = torch.arange(k, device=dists.device)
    karg = torch.where(dists == kt[..., None], iota, k).amin(dim=-1)
    return kt, torch.clamp(karg, max=k - 1)


def _merge_non_sphere(ray_o, ray_d, scene: Scene, t, prim, reject_below=0.0):
    """Merge planes, boxes and triangles into a sphere-only (t, prim), in
    index order, so the first-primitive tie-break holds across kinds."""
    offset = scene.spheres.count
    for part, dist_fn in (
        (scene.planes, plane_distances),
        (scene.boxes, box_distances),
        (scene.triangles, triangle_distances),
    ):
        if part.count:
            kt, karg = _first_min(dist_fn(ray_o, ray_d, part, reject_below))
            better = kt < t
            t = torch.where(better, kt, t)
            prim = torch.where(better, offset + karg, prim)
        offset += part.count
    return t, prim


def _nearest_t_prim_chunked(ray_o, ray_d, scene: Scene, reject_below=0.0):
    """Large-scene nearest hit: the spheres in chunks of CHUNK_SIZE (the
    last chunk is shorter, so nothing is padded), a strict `<` between
    chunks, then the other kinds merged in index order."""
    shape = ray_o.shape[:-1]
    t = torch.full(shape, INFINITE, dtype=torch.float32, device=ray_o.device)
    prim = torch.zeros(shape, dtype=torch.int64, device=ray_o.device)
    sp = scene.spheres
    for lo in range(0, sp.count, CHUNK_SIZE):
        chunk = Spheres(
            pos=sp.pos[lo : lo + CHUNK_SIZE],
            radius=sp.radius[lo : lo + CHUNK_SIZE],
            material=None,
        )
        c_t, c_arg = _first_min(sphere_distances(ray_o, ray_d, chunk, reject_below))
        better = c_t < t
        t = torch.where(better, c_t, t)
        prim = torch.where(better, lo + c_arg, prim)
    return _merge_non_sphere(ray_o, ray_d, scene, t, prim, reject_below)


def nearest_t_prim(ray_o, ray_d, scene: Scene, reject_below=0.0):
    """Nearest (t, prim) only — the fold half of `nearest_hit`.  Misses
    give (INFINITE, 0)."""
    if scene.num_primitives > CHUNKED_THRESHOLD:
        return _nearest_t_prim_chunked(ray_o, ray_d, scene, reject_below)
    return _nearest_t_prim_small(ray_o, ray_d, scene, reject_below)


def nearest_hit(ray_o, ray_d, scene: Scene, reject_below=0.0) -> Hit:
    """Resolve the nearest intersection of each ray with the scene."""
    t, prim = nearest_t_prim(ray_o, ray_d, scene, reject_below)
    return hit_from_t_prim(ray_o, ray_d, t, prim, scene)


def hit_from_t_prim(ray_o, ray_d, t, prim, scene: Scene) -> Hit:
    """Assemble the full `Hit` payload from a resolved (t, prim) pair."""
    hit = t < INFINITE
    fields = _payload_table(scene)[prim]  # [..., 12]
    aux, aux2 = fields[..., 0:3], fields[..., 3:6]

    # A zeroed t on miss lanes keeps the point finite.
    t_safe = torch.where(hit, t, 0.0)
    point = ray_o + ray_d * t_safe[..., None]

    n_spheres = scene.spheres.count
    box_lo = n_spheres + scene.planes.count
    is_sphere = prim < n_spheres
    is_box = (prim >= box_lo) & (prim < box_lo + scene.boxes.count)
    normal = torch.where(
        is_sphere[..., None], linalg.normalize_safe(point - aux), aux
    )
    if scene.boxes.count:
        normal = torch.where(
            is_box[..., None], box_normal(point, aux, aux2), normal
        )
    return Hit(
        t=t,
        hit=hit,
        prim=prim,
        point=point,
        normal=normal,
        color=fields[..., 6:9],
        illuminance=fields[..., 9],
        brdf_kind=torch.round(fields[..., 11]).to(torch.int32),
        brdf_param=fields[..., 10],
    )


def sphere_occluded_any(point, l_dir, t_l, exclude_prim, spheres: Spheres):
    """Sqrt-free any-hit shadow test: True where some sphere other than
    `exclude_prim` (global index; spheres come first) meets the ray
    (point, l_dir) at t in [EPSILON, t_l).  With the distances fixed there
    is no need for the sqrt, h being r^2 - d^2:
        t >= eps  <=>  (tca - eps >= 0) & ((tca - eps)^2 >= h)
        t <  t_l  <=>  (tca - t_l < 0) | ((tca - t_l)^2 < h)
    The spheres go in chunks of CHUNK_SIZE, which bounds the [rays, chunk]
    intermediates and changes no decision."""
    occ = torch.zeros(point.shape[:-1], dtype=torch.bool, device=point.device)
    for lo in range(0, spheres.count, CHUNK_SIZE):
        pos = spheres.pos[lo : lo + CHUNK_SIZE]
        radius = spheres.radius[lo : lo + CHUNK_SIZE]
        l = pos - point[..., None, :]
        ll = linalg.quadrance(l)
        tca = linalg.dot(l, l_dir[..., None, :])
        r2 = radius * radius
        h = r2 - (ll - tca * tca)
        a1 = tca - EPSILON
        a2 = tca - t_l[..., None]
        iota = torch.arange(lo, lo + len(radius), device=point.device)
        hits = (
            (h >= 0.0)
            & (a1 >= 0.0)
            & (a1 * a1 >= h)
            & ((a2 < 0.0) | (a2 * a2 < h))
            & (iota != exclude_prim[..., None])
        )
        occ = occ | hits.any(dim=-1)
    return occ


def shadow_occluded(point, l_dir, t_l, exclude_prim, scene: Scene):
    """True where any primitive other than `exclude_prim` blocks the
    segment [EPSILON, t_l) from `point` along `l_dir`: spheres by the
    sqrt-free test, planes, boxes and triangles by their distances in the
    same window."""
    occ = sphere_occluded_any(point, l_dir, t_l, exclude_prim, scene.spheres)
    if scene.planes.count:
        pd = plane_distances(point, l_dir, scene.planes)
        occ = occ | ((pd >= EPSILON) & (pd < t_l[..., None])).any(dim=-1)
    if scene.boxes.count:
        bd = box_distances(point, l_dir, scene.boxes, EPSILON)
        occ = occ | (bd < t_l[..., None]).any(dim=-1)
    if scene.triangles.count:
        td = triangle_distances(point, l_dir, scene.triangles, EPSILON)
        base = scene.spheres.count + scene.planes.count + scene.boxes.count
        iota = torch.arange(base, base + scene.triangles.count, device=point.device)
        occ = occ | ((td < t_l[..., None]) & (iota != exclude_prim[..., None])).any(dim=-1)
    return occ
