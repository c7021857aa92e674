"""The physically based estimator with next-event estimation (NEE).

Counterpart of ``haskell_path_tracer_tpu/render/nee.py``.  Corrected
BRDFs: matte surfaces sample the cosine-weighted hemisphere (the
throughput modifier is exactly the albedo), glossy surfaces are perfect
mirrors tinted by the albedo, dielectrics take the Fresnel glass of
`ops/brdf.py`.  At every matte hit a shadow ray samples one emitter:
spheres by uniform cone (solid-angle) sampling, triangles by uniform area
sampling.  Emission reached by a BSDF ray counts only after a specular
bounce, or from planes and boxes, which NEE never samples, so nothing is
counted twice.

Shade-frame convention of the whole family: the next ray starts AT the hit
point and its queries accept t >= EPSILON (`reject_below`), where the
parity family shifts the origin instead.  The CUDA megakernel
(`ops/nee.py`) runs the same f32 sequence, which makes per-lane parity
structural rather than statistical.

Functions take Scene and Rays of this package; `kinds` is the static set
of BRDF kinds in the scene (`_present_kinds`, read once on the host) and
only elides branches that no hit can take, so it never changes a result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import linalg
from ..models.camera import primary_rays
from ..models.objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Accumulator,
    Camera,
    Rays,
    Scene,
)
from ..ops import brdf as brdf_ops
from ..ops import nee as nee_ops
from ..ops import rng as rng_ops
from ..ops import threefry
from ..utils.metrics import host_read, span
from ..ops.intersect import (
    CHUNKED_THRESHOLD,
    EPSILON,
    INFINITE,
    PLANE_DENOM_EPS,
    hit_from_t_prim,
    nearest_t_prim,
    plane_distances,
    shadow_occluded,
)

TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
# Squared distance below which a triangle-light sample is rejected: twice
# the self-intersection offset, squared, in f32.
MIN_D2 = float(np.float32((2.0 * np.float32(EPSILON)) ** 2))


def _div(x, c: float):
    """x / c as a true division on every device (on CUDA, dividing by a
    Python scalar multiplies by its reciprocal, which can differ by 1 ulp)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _orthonormal_basis(w):
    """Branchless ONB around unit vectors w (Duff et al. 2017): (b1, b2)
    with (b1, b2, w) right-handed orthonormal."""
    w0, w1 = w[..., 0], w[..., 1]
    sign = torch.where(w[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + w[..., 2])
    b = w0 * w1 * a
    b1 = torch.stack([1.0 + sign * (w0 * w0) * a, sign * b, -sign * w0], dim=-1)
    b2 = torch.stack([b, sign + (w1 * w1) * a, -w1], dim=-1)
    return b1, b2


def sample_cosine_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about `normal`; pdf = cos(theta)/pi."""
    r = linalg.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = linalg.sqrt(torch.clamp(1.0 - u1, min=1e-12))
    b1, b2 = _orthonormal_basis(normal)
    return b1 * x[..., None] + b2 * y[..., None] + normal * z[..., None]


def _present_kinds(scene: Scene) -> frozenset:
    """The BRDF kinds present in the scene, read on the host (one
    `host_read` per non-empty part, each waiting for a CUDA device: callers
    that step often read them once per scene)."""
    present = set()
    for part in (scene.spheres, scene.planes, scene.boxes, scene.triangles):
        if part.count:
            present.update(np.unique(host_read(part.material.brdf_kind)).tolist())
    return frozenset(present)


def _physical_bounce(hit, ray_d, u1, u2, u3, kinds=None):
    """Direction selection for the physical BRDFs from three uniforms in
    [0, 1): (origin, direction, throughput modifier, is_specular).  The
    origin is the hit point itself (shade frame).  `kinds` elides the
    branches of absent materials; None computes all."""
    has_glossy = kinds is None or BRDF_GLOSSY in kinds
    has_diel = kinds is None or BRDF_DIELECTRIC in kinds

    direction = sample_cosine_hemisphere(hit.normal, u1, u2)
    is_glossy = hit.brdf_kind == BRDF_GLOSSY
    is_diel = hit.brdf_kind == BRDF_DIELECTRIC
    if has_glossy:
        glossy_dir = linalg.reflect(ray_d, hit.normal)
        direction = torch.where(is_glossy[..., None], glossy_dir, direction)
    if has_diel:
        refl, refr, f_refl = brdf_ops.dielectric_split(ray_d, hit.normal, hit.brdf_param)
        diel_dir = torch.where((u3 < f_refl)[..., None], refl, refr)
        direction = torch.where(is_diel[..., None], diel_dir, direction)
    if has_glossy or has_diel:
        is_specular = is_glossy | is_diel
    else:
        is_specular = torch.zeros_like(is_glossy)
    return hit.point, direction, hit.color, is_specular


def sample_physical(hit, ray_d, rng_state, kinds=None):
    """Physically based bounce sampling, three SFC32 draws per lane:
    (origin, direction, throughput modifier, is_specular, new state)."""
    u, rng = rng_ops.gen_vec(rng_state)  # 3 draws in [-1, 1]
    us = (u + 1.0) * 0.5
    origin, direction, tmod, is_specular = _physical_bounce(
        hit, ray_d, us[..., 0], us[..., 1], us[..., 2], kinds=kinds
    )
    return origin, direction, tmod, is_specular, rng


def _light_fields(scene: Scene):
    """The NEE emitters over spheres ++ triangles (`sample_light`'s index
    space; planes and boxes are left to BSDF pickup): (mask [L], cdf [L],
    count) with count an f32 scalar tensor."""
    masks = [scene.spheres.material.illuminance > 0.0]
    if scene.triangles.count:
        masks.append(scene.triangles.material.illuminance > 0.0)
    mask = torch.cat(masks)
    m = mask.to(torch.float32)
    return mask, torch.cumsum(m, dim=0), m.sum()


def _select_light(scene: Scene, u_select, lights=None):
    """The index (in `_light_fields`' space) of a uniformly chosen emitter:
    the k-th set bit of the mask with k = clamp(floor(u * count), 0,
    count - 1) — the JAX package's rank rule on its cdf, without the
    [rays, L] comparison.  `lights` is the emitters' index list, if the
    caller has it.  Returns (index [...] int64, count f32 scalar tensor);
    with no emitter, index 0."""
    if lights is None:
        lights = torch.nonzero(_light_fields(scene)[0]).reshape(-1)
    count = torch.tensor(float(len(lights)), dtype=torch.float32, device=u_select.device)
    if not len(lights):
        return torch.zeros(u_select.shape, dtype=torch.int64, device=u_select.device), count
    k = torch.clamp(torch.floor(u_select * count), 0.0, float(len(lights) - 1)).long()
    return lights[k], count


def _cone_sample(center, radius, point, u1, u2):
    """Uniform direction in the cone that a sphere subtends from `point`:
    (direction, solid angle = 1/pdf).  The one-minus terms are computed
    directly, as every implementation of this estimator does,
        omc = 1 - cos_max = sin2_max / (1 + cos_max)
        st2 = 1 - cos_t^2 = (u1 * omc) * (1 + cos_t),
    because the naive 1 - cos_max cancels catastrophically for distant
    lights.  A point on or inside the sphere takes the whole hemisphere
    (omc = 1)."""
    to_c = center - point
    dc2 = linalg.quadrance(to_c)
    dc = linalg.sqrt(torch.clamp(dc2, min=1e-12))
    sin2_max = torch.clamp(radius * radius / torch.clamp(dc2, min=1e-12), 0.0, 1.0)
    on_sphere = sin2_max >= 1.0
    cos_max = torch.where(on_sphere, 0.0, linalg.sqrt(torch.where(on_sphere, 1.0, 1.0 - sin2_max)))
    omc = torch.where(on_sphere, 1.0, sin2_max / (1.0 + cos_max))

    x = u1 * omc
    cos_t = 1.0 - x
    st2 = x * (1.0 + cos_t)
    st_ok = st2 > 0.0
    sin_t = torch.where(st_ok, linalg.sqrt(torch.where(st_ok, st2, 1.0)), 0.0)
    phi = TWO_PI * u2
    w = to_c / dc[..., None]
    b1, b2 = _orthonormal_basis(w)
    direction = (
        b1 * (sin_t * torch.cos(phi))[..., None]
        + b2 * (sin_t * torch.sin(phi))[..., None]
        + w * cos_t[..., None]
    )
    return direction, TWO_PI * omc


def _tri_area_sample(tris, t_idx, point, u1, u2):
    """Uniform point on triangle `t_idx` as a solid-angle sample from
    `point`: (direction, inv_pdf = A cos_l / d^2).  Zero where the point
    sees the back face (triangles emit from the front only) or lies closer
    than 2 EPSILON to the sample (a shade point on the emitter itself; the
    rejected mass is a known, accepted bias of ~2e-4 scene units)."""
    v0 = tris.v0[t_idx]
    return _tri_area_sample_rows(v0, tris.v1[t_idx] - v0, tris.v2[t_idx] - v0, point, u1, u2)


def _tri_area_sample_rows(v0, e1, e2, point, u1, u2):
    """`_tri_area_sample` of the triangles (v0, e1, e2), one per lane."""
    n = linalg.cross(e1, e2)
    n_norm = linalg.sqrt(torch.clamp(linalg.quadrance(n), min=1e-20))
    n_unit = n / n_norm[..., None]
    area = 0.5 * n_norm

    r1s = linalg.sqrt(torch.clamp(u1, min=1e-12))
    bu = 1.0 - r1s
    bv = u2 * r1s
    q = v0 + e1 * bu[..., None] + e2 * bv[..., None]
    to_q = q - point
    d2 = torch.clamp(linalg.quadrance(to_q), min=1e-12)
    direction = to_q / linalg.sqrt(d2)[..., None]
    cos_l = -linalg.dot(direction, n_unit)
    inv_pdf = torch.where((cos_l > 1e-6) & (d2 >= MIN_D2), area * cos_l / d2, 0.0)
    return direction, inv_pdf


def _tri_t_single(tris, t_idx, point, l_dir, reject_below=EPSILON):
    """Möller–Trumbore distance from `point` to one triangle per lane, in
    `triangle_distances`' f32 sequence (so the shadow window sees the value
    a full fold would); INFINITE on a miss."""
    v0 = tris.v0[t_idx]
    return _tri_t_rows(v0, tris.v1[t_idx] - v0, tris.v2[t_idx] - v0, point, l_dir, reject_below)


def _tri_t_rows(v0, e1, e2, point, l_dir, reject_below=EPSILON):
    """`_tri_t_single` of the triangles (v0, e1, e2), one per lane."""
    pvec = linalg.cross(l_dir, e2)
    det = linalg.dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
    tvec = point - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(l_dir, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    n_norm = linalg.norm(linalg.cross(e1, e2))
    miss = (
        (det <= PLANE_DENOM_EPS * n_norm)
        | (u < 0.0)
        | (v < 0.0)
        | (u + v > 1.0)
        | (t < reject_below)
    )
    return torch.where(miss, INFINITE, t)


def _sphere_t_single(point, l_dir, center, radius, eps=EPSILON):
    """Distance from `point` to one sphere per lane along `l_dir`, accepting
    tca >= eps and t >= eps (shade frame); INFINITE on a miss."""
    l = center - point
    tca = linalg.dot(l, l_dir)
    d2 = linalg.quadrance(l) - tca * tca
    r2 = radius * radius
    outside = d2 > r2
    thc = torch.where(
        outside, 0.0, linalg.sqrt(torch.where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12)))
    )
    t = tca - thc
    miss = (tca < eps) | outside | (t < eps)
    return torch.where(miss, INFINITE, t)


def sample_light(scene: Scene, point, u_select, u1, u2, lights=None):
    """Pick an NEE emitter (sphere or triangle) uniformly, then a direction
    towards it: cone sampling for spheres, area sampling for triangles.

    Returns (dir [..., 3], inv_pdf [...], light_prim [...], t_l [...],
    l_emit [..., 3]): `light_prim` is the emitter's global primitive index,
    `inv_pdf` includes the 1/count selection (contribution = f cos L_e
    inv_pdf), `t_l` the shade-frame distance to the chosen emitter along
    `dir` (INFINITE when unreachable), `l_emit` its color * illuminance.
    Lanes without a valid sample get inv_pdf = 0.  `lights` is the
    emitters' index list (`_light_fields`' space), if the caller has it."""
    light_idx, count = _select_light(scene, u_select, lights)
    ns, nt = scene.spheres.count, scene.triangles.count
    sp, sp_mat = scene.spheres, scene.spheres.material
    if nt:
        is_tri = light_idx >= ns
        s_idx = torch.clamp(light_idx, 0, max(ns - 1, 0))
        t_idx = torch.clamp(light_idx - ns, 0, nt - 1)
        dir_s, sa_s = _cone_sample(sp.pos[s_idx], sp.radius[s_idx], point, u1, u2)
        dir_t, ip_t = _tri_area_sample(scene.triangles, t_idx, point, u1, u2)
        direction = torch.where(is_tri[..., None], dir_t, dir_s)
        inv_pdf_dir = torch.where(is_tri, ip_t, sa_s)
        tri_base = ns + scene.planes.count + scene.boxes.count
        light_prim = torch.where(is_tri, tri_base + t_idx, s_idx)
        t_l = torch.where(
            is_tri,
            _tri_t_single(scene.triangles, t_idx, point, direction),
            _sphere_t_single(point, direction, sp.pos[s_idx], sp.radius[s_idx]),
        )
        tr_mat = scene.triangles.material
        l_emit = torch.where(
            is_tri[..., None],
            tr_mat.color[t_idx] * tr_mat.illuminance[t_idx][..., None],
            sp_mat.color[s_idx] * sp_mat.illuminance[s_idx][..., None],
        )
    else:
        direction, inv_pdf_dir = _cone_sample(
            sp.pos[light_idx], sp.radius[light_idx], point, u1, u2
        )
        light_prim = light_idx
        t_l = _sphere_t_single(point, direction, sp.pos[light_idx], sp.radius[light_idx])
        l_emit = sp_mat.color[light_idx] * sp_mat.illuminance[light_idx][..., None]

    valid = (count > 0) & (inv_pdf_dir > 1e-9)
    inv_pdf = torch.where(valid, inv_pdf_dir * count, 0.0)
    return direction, inv_pdf, light_prim, t_l, l_emit


def sample_light_cone(scene: Scene, point, u_select, u1, u2):
    """Sphere-only light sampling (the original estimator, for tests of the
    cone math): (dir, inv_pdf, light index)."""
    light_idx, count = _select_light(scene, u_select)
    direction, solid_angle = _cone_sample(
        scene.spheres.pos[light_idx], scene.spheres.radius[light_idx], point, u1, u2
    )
    valid = (count > 0) & (solid_angle > 1e-9)
    return direction, torch.where(valid, solid_angle * count, 0.0), light_idx


def _trace(scene: Scene, rays: Rays, rng_state, num_bounces, nee, kinds, record=None):
    """The shade-frame loop of `trace_physical`; returns (radiance, rng,
    live bounces per lane [...] int32).  `record` (a list) receives each
    bounce's residual word per lane (`ops/nee.py`: PRIM_SHIFT and the
    occlusion, hit and live bits)."""
    if kinds is None:
        kinds = _present_kinds(scene)
    n_spheres = scene.spheres.count
    # Planes and boxes are never light-sampled: their emission always
    # arrives by BSDF pickup.  Spheres and triangles count only off
    # specular chains.
    bsdf_only_lo = n_spheres
    bsdf_only_hi = n_spheres + scene.planes.count + scene.boxes.count
    lights = torch.nonzero(_light_fields(scene)[0]).reshape(-1) if nee else None

    ray_o, ray_d = rays.origin, rays.direction
    t, prim = nearest_t_prim(ray_o, ray_d, scene)
    rng = rng_state
    result = torch.zeros_like(ray_o)
    throughput = torch.ones_like(ray_o)
    prev_spec = torch.ones(ray_o.shape[:-1], dtype=torch.bool, device=ray_o.device)
    live = torch.zeros(ray_o.shape[:-1], dtype=torch.int32, device=ray_o.device)
    for _ in range(num_bounces):
        # The carry holds this bounce's (t, prim), queried from the
        # unshifted previous hit point with reject_below = EPSILON.
        hit = hit_from_t_prim(ray_o, ray_d, t, prim, scene)
        dead = linalg.near_zero(throughput) | ~hit.hit
        live = live + (~dead).to(torch.int32)

        if nee:
            is_bsdf_only = (hit.prim >= bsdf_only_lo) & (hit.prim < bsdf_only_hi)
            take_emit = prev_spec | is_bsdf_only
        else:
            take_emit = torch.ones_like(prev_spec)
        emit = brdf_ops.emittance(hit) * throughput
        new_result = result + torch.where(take_emit[..., None], emit, 0.0)

        _, next_d, tmod, is_spec, rng2 = sample_physical(hit, ray_d, rng, kinds=kinds)

        if nee:
            un, rng2 = rng_ops.gen_vec(rng2)  # 3 draws in [-1, 1]
            us = (un + 1.0) * 0.5
            l_dir, inv_pdf, l_idx, t_l, l_emit = sample_light(
                scene, hit.point, us[..., 0], us[..., 1], us[..., 2], lights
            )
            occ = shadow_occluded(hit.point, l_dir, t_l, l_idx, scene)
            visible = ~occ & (t_l < INFINITE)
            cos_i = linalg.dot(l_dir, hit.normal)
            # Only matte surfaces have a non-delta BRDF to evaluate.
            w = visible & (hit.brdf_kind == BRDF_MATTE) & (cos_i > 0.0)
            contrib = throughput * _div(hit.color, PI) * l_emit * (cos_i * inv_pdf)[..., None]
            new_result = new_result + torch.where(w[..., None], contrib, 0.0)

        if record is not None:
            flags = ((~dead).to(torch.int32) * nee_ops.LIVE_BIT
                     + hit.hit.to(torch.int32) * nee_ops.HIT_BIT)
            if nee and len(lights):  # no emitter: no shadow ray to block
                flags = flags + (occ & ~dead).to(torch.int32) * nee_ops.OCC_BIT
            record.append((prim.to(torch.int32) << nee_ops.PRIM_SHIFT) | flags)

        new_throughput = throughput * tmod
        t2, prim2 = nearest_t_prim(hit.point, next_d, scene, EPSILON)

        d3 = dead[..., None]
        ray_o = torch.where(d3, ray_o, hit.point)
        ray_d = torch.where(d3, ray_d, next_d)
        t = torch.where(dead, t, t2)
        prim = torch.where(dead, prim, prim2)
        rng = torch.where(d3, rng, rng2)
        result = torch.where(d3, result, new_result)
        throughput = torch.where(d3, 0.0, new_throughput)
        prev_spec = torch.where(dead, prev_spec, is_spec)
    return result, rng, live


def _trace_physical_fused(scene: Scene, rays: Rays, rng_state, num_bounces: int = 8,
                          kinds=None):
    """The NEE trace with the dual query (`ops/sphere_fold.py`): one pass
    over the sphere table per bounce answers both the next BSDF ray's
    nearest sphere and the shadow ray's occlusion from the shared shade
    point, instead of `_trace`'s two folds; the planes are merged after it.
    Sampling decisions (draw order, light and cone sampling, emission
    bookkeeping) are `trace_physical(nee=True)`'s.  Spheres and planes only.

    The emitters come from a compact light table built once per trace:
    centers, radii, emission and global index, one row per emissive sphere,
    chosen by the rank rule clamp(floor(u * count), 0, count - 1) of
    `_select_light`.  The primary hit (eps = 0) is `nearest_t_prim`'s: on
    CUDA tensors above CHUNKED_THRESHOLD primitives the nearest-sphere
    kernel, the planes merged after it, as the JAX package's `nearest_hit`
    takes it.  Differentiable like `_trace`, with the
    sphere winners' distances through the two queries' backward."""
    from ..ops.sphere_fold import sphere_dual_query

    if scene.triangles.count or scene.boxes.count or not scene.spheres.count:
        raise ValueError("the fused NEE trace takes scenes of spheres and planes, with a sphere")
    if scene.spheres.count >= 1 << 24:
        raise ValueError("the light table carries sphere indices as f32: fewer than 2^24 spheres")
    n_spheres = scene.spheres.count
    shape = rays.origin.shape[:-1]
    pos, radius, mat = scene.spheres.pos, scene.spheres.radius, scene.spheres.material
    if kinds is None:
        kinds = _present_kinds(scene)

    l_mask, _, l_count = _light_fields(scene)
    lsel = torch.nonzero(l_mask).reshape(-1)
    lsel = torch.cat([lsel, lsel.new_zeros(n_spheres - len(lsel))])
    light_table = torch.cat([
        pos[lsel], radius[lsel][:, None], mat.color[lsel], mat.illuminance[lsel][:, None],
        lsel[:, None].to(torch.float32),
    ], dim=-1)  # [n_spheres, 9]

    def merge_planes(o, d, t, prim):
        """The planes after the spheres, in the shade frame (dist >= EPSILON)."""
        if not scene.planes.count:
            return t, prim
        pd = plane_distances(o, d, scene.planes)
        pd = torch.where(pd < EPSILON, INFINITE, pd)
        m = pd.shape[-1]
        kt = pd.amin(dim=-1)
        iota = torch.arange(m, device=pd.device)
        karg = torch.where(pd == kt[..., None], iota, m).amin(dim=-1)
        better = kt < t
        return (torch.where(better, kt, t),
                torch.where(better, n_spheres + torch.clamp(karg, max=m - 1), prim))

    ray_o, ray_d = rays.origin, rays.direction
    t, prim = nearest_t_prim(ray_o, ray_d, scene)
    rng = rng_state
    result = torch.zeros_like(ray_o)
    throughput = torch.ones_like(ray_o)
    prev_spec = torch.ones(shape, dtype=torch.bool, device=ray_o.device)
    for _ in range(num_bounces):
        hit = hit_from_t_prim(ray_o, ray_d, t, prim, scene)
        dead = linalg.near_zero(throughput) | ~hit.hit

        take_emit = prev_spec | (hit.prim >= n_spheres)
        emit = brdf_ops.emittance(hit) * throughput
        new_result = result + torch.where(take_emit[..., None], emit, 0.0)

        _, next_d, tmod, is_spec, rng2 = sample_physical(hit, ray_d, rng, kinds=kinds)

        un, rng2 = rng_ops.gen_vec(rng2)
        us = (un + 1.0) * 0.5
        k = torch.clamp(torch.floor(us[..., 0] * l_count), min=0.0)
        k = torch.minimum(k, torch.clamp(l_count - 1.0, min=0.0)).long()
        lrow = light_table[k]
        l_pos, l_rad = lrow[..., 0:3], lrow[..., 3]
        l_emit = lrow[..., 4:7] * lrow[..., 7:8]
        l_idx = torch.round(lrow[..., 8]).to(torch.int32)
        l_dir, solid_angle = _cone_sample(l_pos, l_rad, hit.point, us[..., 1], us[..., 2])
        inv_pdf = torch.where((l_count > 0) & (solid_angle > 1e-9), solid_angle * l_count, 0.0)
        t_light = _sphere_t_single(hit.point, l_dir, l_pos, l_rad)
        t2, prim2, occ = sphere_dual_query(
            hit.point.reshape(-1, 3), next_d.reshape(-1, 3), l_dir.reshape(-1, 3),
            t_light.reshape(-1), l_idx.reshape(-1), (~dead).reshape(-1).to(torch.int32),
            pos, radius,
        )
        t2, prim2, occ = t2.reshape(shape), prim2.reshape(shape).long(), occ.reshape(shape)
        t2, prim2 = merge_planes(hit.point, next_d, t2, prim2)
        if scene.planes.count:
            pds = plane_distances(hit.point, l_dir, scene.planes)
            occ = occ | ((pds >= EPSILON) & (pds < t_light[..., None])).any(dim=-1)

        visible = ~occ & (t_light < INFINITE)
        cos_i = linalg.dot(l_dir, hit.normal)
        w = visible & (hit.brdf_kind == BRDF_MATTE) & (cos_i > 0.0)
        contrib = throughput * _div(hit.color, PI) * l_emit * (cos_i * inv_pdf)[..., None]
        new_result = new_result + torch.where(w[..., None], contrib, 0.0)

        new_throughput = throughput * tmod
        d3 = dead[..., None]
        ray_o = torch.where(d3, ray_o, hit.point)
        ray_d = torch.where(d3, ray_d, next_d)
        t = torch.where(dead, t, t2)
        prim = torch.where(dead, prim, prim2)
        rng = torch.where(d3, rng, rng2)
        result = torch.where(d3, result, new_result)
        throughput = torch.where(d3, 0.0, new_throughput)
        prev_spec = torch.where(dead, prev_spec, is_spec)
    return result, rng


def _fused_eligible(scene: Scene) -> bool:
    """The JAX package's rule with "tpu" read as "cuda": a scene of more
    than CHUNKED_THRESHOLD spheres and no boxes or triangles, on CUDA."""
    return (
        scene.spheres.pos.is_cuda
        and scene.spheres.count > CHUNKED_THRESHOLD
        and not scene.boxes.count
        and not scene.triangles.count
    )


def trace_physical(
    scene: Scene,
    rays: Rays,
    rng_state: torch.Tensor,
    num_bounces: int = 8,
    nee: bool = True,
    fused: bool | None = None,
    kinds=None,
):
    """Physically based path trace of one sample per ray: (radiance
    [..., 3], new rng).  With `nee=False` it is brute-force BSDF sampling
    over the corrected BRDFs, the ground truth the NEE estimator is held to.

    `fused=True` runs the dual-query loop (`_trace_physical_fused`: the
    dual-fold and nearest-sphere kernels on CUDA tensors, their plain
    versions on the CPU; spheres and planes only); False the plain loop; None takes the dual query on
    CUDA scenes of more than CHUNKED_THRESHOLD spheres and no boxes or
    triangles (`_fused_eligible`)."""
    if fused is None:
        fused = nee and _fused_eligible(scene)
    if fused:
        if not nee:
            raise ValueError("the fused trace is the NEE estimator: it needs nee=True")
        return _trace_physical_fused(scene, rays, rng_state, num_bounces, kinds)
    radiance, rng, _ = _trace(scene, rays, rng_state, num_bounces, nee, kinds)
    return radiance, rng


def trace_physical_stateless(
    scene: Scene,
    rays: Rays,
    key: torch.Tensor,
    num_bounces: int = 8,
    spp: int = 1,
    nee: bool = True,
    kinds=None,
) -> torch.Tensor:
    """The physical trace on stateless threefry uniforms: the mean radiance
    of `spp` samples per ray.

    Sample `i`, bounce `b` draws its six uniforms as `uniform(fold_in(
    fold_in(key, i), b), (6, ...))` (`ops/threefry.py`, bit-equal with
    `jax.random`), so any sample replays from (key, index) with no state
    carried.  The shading is `_trace`'s, the uniforms in the same roles:
    the BSDF sample (0-2) and the emitter sample (3-5).  Plain tensor code
    on any device: the reference estimator that the stateless batch
    (`render_batch_physical_stateless`) is held to in expectation."""
    if kinds is None:
        kinds = _present_kinds(scene)
    n_spheres = scene.spheres.count
    bsdf_only_lo = n_spheres
    bsdf_only_hi = n_spheres + scene.planes.count + scene.boxes.count
    lights = torch.nonzero(_light_fields(scene)[0]).reshape(-1) if nee else None
    shape = rays.origin.shape[:-1]
    t0, prim0 = nearest_t_prim(rays.origin, rays.direction, scene)

    total = torch.zeros_like(rays.origin)
    for i in range(spp):
        sample_key = threefry.fold_in(key, i)
        ray_o, ray_d, t, prim = rays.origin, rays.direction, t0, prim0
        result = torch.zeros_like(ray_o)
        throughput = torch.ones_like(ray_o)
        prev_spec = torch.ones(shape, dtype=torch.bool, device=ray_o.device)
        for b in range(num_bounces):
            hit = hit_from_t_prim(ray_o, ray_d, t, prim, scene)
            dead = linalg.near_zero(throughput) | ~hit.hit
            if nee:
                is_bsdf_only = (hit.prim >= bsdf_only_lo) & (hit.prim < bsdf_only_hi)
                take_emit = prev_spec | is_bsdf_only
            else:
                take_emit = torch.ones_like(prev_spec)
            emit = brdf_ops.emittance(hit) * throughput
            new_result = result + torch.where(take_emit[..., None], emit, 0.0)

            u = threefry.uniform(threefry.fold_in(sample_key, b), (6, *shape))
            _, direction, tmod, is_spec = _physical_bounce(hit, ray_d, u[0], u[1], u[2],
                                                            kinds=kinds)
            if nee:
                l_dir, inv_pdf, l_idx, t_l, l_emit = sample_light(
                    scene, hit.point, u[3], u[4], u[5], lights
                )
                occ = shadow_occluded(hit.point, l_dir, t_l, l_idx, scene)
                cos_i = linalg.dot(l_dir, hit.normal)
                w = ~occ & (t_l < INFINITE) & (hit.brdf_kind == BRDF_MATTE) & (cos_i > 0.0)
                contrib = (throughput * _div(hit.color, PI) * l_emit
                           * (cos_i * inv_pdf)[..., None])
                new_result = new_result + torch.where(w[..., None], contrib, 0.0)

            new_throughput = throughput * tmod
            t2, prim2 = nearest_t_prim(hit.point, direction, scene, EPSILON)
            d3 = dead[..., None]
            ray_o = torch.where(d3, ray_o, hit.point)
            ray_d = torch.where(d3, ray_d, direction)
            t = torch.where(dead, t, t2)
            prim = torch.where(dead, prim, prim2)
            result = torch.where(d3, result, new_result)
            throughput = torch.where(d3, 0.0, new_throughput)
            prev_spec = torch.where(dead, prev_spec, is_spec)
        total = total + result
    return _div(total, float(spp))


def render_sample_physical(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = 8,
    nee: bool = True,
    row_offset: int = 0,
    full_height: int | None = None,
    kinds=None,
    fused: bool | None = None,
) -> Accumulator:
    """One progressive sample of the physical integrator, folded into the
    accumulator (`fused` as in `trace_physical`)."""
    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_physical(scene, rays, acc.rng, num_bounces, nee=nee, fused=fused,
                                       kinds=kinds)
    return Accumulator(color=acc.color + radiance, rng=rng_out, iterations=acc.iterations + 1)


def render_batch_physical(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 8,
    nee: bool = True,
    row_offset: int = 0,
    full_height: int | None = None,
    kinds=None,
    light_idx=None,
    kernel: str = "auto",
    presort: bool | None = None,
) -> Accumulator:
    """`spp` physical samples into the accumulator.

    With `nee=True` and kernel="auto", CUDA tensors of a scene with
    0 < spheres < 2^24 (`ops/nee.py:nee_eligible`) take the CUDA NEE
    megakernel: the whole spp x bounce loop in one launch
    (`trace_physical_nee`, `presort` as there).  Everything else runs
    `spp` steps of the plain loop, `render_sample_physical`, on the tensors'
    device — with `nee=False` on the card too, as the JAX package runs its
    XLA loop there.  kernel="torch" forces the plain loop (without the dual
    query: `fused=False`), kernel="cuda"
    the megakernel (it raises on CPU tensors, with `nee=False`, and on a
    scene it cannot take).  `kinds` and `light_idx` (the emitters' static
    index tuple, `ops/nee.py:scene_light_indices`) are read from the scene
    on the host when not given."""
    if kernel not in ("auto", "torch", "cuda"):
        raise ValueError(f"kernel must be 'auto', 'torch' or 'cuda', not {kernel!r}")
    if kernel == "cuda":
        if not acc.color.is_cuda:
            raise ValueError(
                f"kernel='cuda' needs CUDA tensors; the accumulator is on {acc.color.device}"
            )
        if not nee:
            raise ValueError("kernel='cuda' is the NEE megakernel: it needs nee=True")
        if not nee_ops.nee_eligible(scene):
            raise ValueError(
                f"the NEE megakernel takes 0 < spheres < 2^24; this scene has {scene.spheres.count}"
            )
    use_kernel = kernel == "cuda" or (
        kernel == "auto" and nee and acc.color.is_cuda and nee_ops.nee_eligible(scene)
    )
    if use_kernel:
        height, width = acc.color.shape[:2]
        rays = primary_rays(camera, width, height, row_offset, full_height)
        radiance, rng_out = nee_ops.trace_physical_nee(
            scene, rays, acc.rng, num_bounces, spp, light_idx=light_idx, kinds=kinds,
            presort=presort,
        )
        return Accumulator(color=acc.color + radiance, rng=rng_out, iterations=acc.iterations + spp)
    if kinds is None:
        kinds = _present_kinds(scene)
    for _ in range(spp):
        acc = render_sample_physical(
            scene, camera, acc, num_bounces, nee, row_offset, full_height, kinds=kinds,
            fused=False if kernel == "torch" else None,
        )
    return acc


def stateless_states(acc: Accumulator) -> torch.Tensor:
    """The per-lane SFC32 states of the accumulator's next stateless batch:
    threefry words `bits(fold_in(prng_key(seed), iterations), (H, W, 4))`
    after 12 warm-up rounds, `seed` being the accumulator's first rng word
    read as uint32.  Computed on the accumulator's device, in span
    "hpt.rng.seed"; a pure function of (seed word, iterations)."""
    height, width = acc.rng.shape[:2]
    with span("hpt.rng.seed"):
        key = threefry.fold_in(threefry.prng_key(acc.rng.reshape(-1)[0]), acc.iterations)
        states = threefry.bits(key, (height, width, 4))
        for _ in range(12):
            _, states = rng_ops.sfc32_next(states)
        return states


def render_batch_physical_stateless(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 8,
    nee: bool = True,
    row_offset: int = 0,
    full_height: int | None = None,
    kinds=None,
    light_idx=None,
    kernel: str = "auto",
    presort: bool | None = None,
) -> Accumulator:
    """`spp` physical samples with stateless replay (`RenderConfig.sampler =
    "threefry"`): the batch's per-lane SFC32 states are derived from the
    accumulator's seed word and iteration count (`stateless_states`), then
    `render_batch_physical` runs on them unchanged, with the same `kernel`,
    `presort`, `kinds` and `light_idx` (the NEE megakernel, and the probe
    when presorted, on CUDA tensors).  Any batch replays from (seed,
    iterations) alone and successive batches draw fresh streams; the
    accumulator's own rng, the SFC32 sampler's state, is returned
    untouched.  `trace_physical_stateless` is the pure-threefry estimator
    this path is held to in expectation."""
    out = render_batch_physical(
        scene, camera, Accumulator(color=acc.color, rng=stateless_states(acc),
                                   iterations=acc.iterations),
        spp, num_bounces, nee=nee, row_offset=row_offset, full_height=full_height,
        kinds=kinds, light_idx=light_idx, kernel=kernel, presort=presort,
    )
    return Accumulator(color=out.color, rng=acc.rng, iterations=out.iterations)
