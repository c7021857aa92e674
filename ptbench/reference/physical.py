"""The plain reference of the physical/NEE estimator: one sample per lane.

A frozen copy, from commit 46789026a883eb6678717df1b19ed41c83f8556b of
this repository, of haskell_path_tracer_torch/render/nee.py
(`_orthonormal_basis`, `sample_cosine_hemisphere`, `_physical_bounce`,
`_cone_sample`, `_sphere_t_single`, `_select_light`, `sample_light` for
sphere emitters, and `_trace` with NEE on) and of `dielectric_split` from
haskell_path_tracer_torch/ops/brdf.py, in the same float32 operation
order.  `trace` runs in one of two modes:

  * deciding: the folds choose each bounce's winner and the shadow test,
    on the lanes still alive, and the decisions are returned as words
    (winner << 3 | hit << 1 | occluded);
  * replaying: the words stand in for the folds and the winner's distance
    is recomputed from them (`core.winner_distance`), so the gradient runs
    through every continuous quantity and no fold.

Both give the same floats.  Imports torch, numpy and `core` only.
"""

from __future__ import annotations

import torch

from . import core as C
from .core import BRDF_DIELECTRIC, BRDF_GLOSSY, BRDF_MATTE, EPSILON, PI, TWO_PI

OCC_BIT, HIT_BIT, PRIM_SHIFT = 1, 2, 3


def div(x, c: float):
    """x / c as a true division (a CUDA tensor divided by a Python scalar is
    multiplied by its reciprocal)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def orthonormal_basis(w):
    w0, w1 = w[..., 0], w[..., 1]
    sign = torch.where(w[..., 2] >= 0.0, 1.0, -1.0).to(w.dtype)
    a = -1.0 / (sign + w[..., 2])
    b = w0 * w1 * a
    b1 = torch.stack([1.0 + sign * (w0 * w0) * a, sign * b, -sign * w0], dim=-1)
    b2 = torch.stack([b, sign + (w1 * w1) * a, -w1], dim=-1)
    return b1, b2


def sample_cosine_hemisphere(normal, u1, u2):
    r = C.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = C.sqrt(torch.clamp(1.0 - u1, min=1e-12))
    b1, b2 = orthonormal_basis(normal)
    return b1 * x[..., None] + b2 * y[..., None] + normal * z[..., None]


def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def dielectric_split(ray_d, normal, ior):
    cos_i = -C.dot(ray_d, normal)
    inside = cos_i < 0.0
    n = torch.where(inside[..., None], -normal, normal)
    cos_i = cos_i.abs()
    eta = torch.where(inside, ior, 1.0 / ior)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t_arg = torch.where(tir, 1.0, torch.clamp(1.0 - sin2_t, min=1e-12))
    cos_t = torch.where(tir, 0.0, C.sqrt(cos_t_arg))
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    fresnel = r0 + (1.0 - r0) * pow5(1.0 - cos_i)
    reflect_weight = torch.where(tir, 1.0, fresnel)
    refl = C.reflect(ray_d, n)
    refr = eta[..., None] * ray_d + (eta * cos_i - cos_t)[..., None] * n
    refr = refr / torch.clamp(C.sqrt(C.quadrance(refr)), min=1e-20)[..., None]
    return refl, refr, reflect_weight


def physical_bounce(hit, ray_d, u1, u2, u3, kinds):
    """(direction, throughput modifier, is_specular) of the corrected
    BRDFs; branches of kinds absent from the scene are left out."""
    direction = sample_cosine_hemisphere(hit.normal, u1, u2)
    is_glossy = hit.brdf_kind == BRDF_GLOSSY
    is_diel = hit.brdf_kind == BRDF_DIELECTRIC
    if BRDF_GLOSSY in kinds:
        direction = torch.where(is_glossy[..., None], C.reflect(ray_d, hit.normal), direction)
    if BRDF_DIELECTRIC in kinds:
        refl, refr, f_refl = dielectric_split(ray_d, hit.normal, hit.brdf_param)
        diel = torch.where((u3 < f_refl)[..., None], refl, refr)
        direction = torch.where(is_diel[..., None], diel, direction)
    if BRDF_GLOSSY in kinds or BRDF_DIELECTRIC in kinds:
        is_specular = is_glossy | is_diel
    else:
        is_specular = torch.zeros_like(is_glossy)
    return direction, hit.color, is_specular


def cone_sample(center, radius, point, u1, u2):
    """Uniform direction in the cone a sphere subtends from `point`, and
    its solid angle."""
    to_c = center - point
    dc2 = C.quadrance(to_c)
    dc = C.sqrt(torch.clamp(dc2, min=1e-12))
    sin2_max = torch.clamp(radius * radius / torch.clamp(dc2, min=1e-12), 0.0, 1.0)
    on_sphere = sin2_max >= 1.0
    cos_max = torch.where(on_sphere, 0.0,
                          C.sqrt(torch.where(on_sphere, 1.0, 1.0 - sin2_max)))
    omc = torch.where(on_sphere, 1.0, sin2_max / (1.0 + cos_max))
    x = u1 * omc
    cos_t = 1.0 - x
    st2 = x * (1.0 + cos_t)
    st_ok = st2 > 0.0
    sin_t = torch.where(st_ok, C.sqrt(torch.where(st_ok, st2, 1.0)), 0.0)
    phi = TWO_PI * u2
    w = to_c / dc[..., None]
    b1, b2 = orthonormal_basis(w)
    direction = (b1 * (sin_t * torch.cos(phi))[..., None]
                 + b2 * (sin_t * torch.sin(phi))[..., None]
                 + w * cos_t[..., None])
    return direction, TWO_PI * omc


def sphere_t_single(point, l_dir, center, radius, eps=EPSILON):
    l = center - point
    tca = C.dot(l, l_dir)
    d2 = C.quadrance(l) - tca * tca
    r2 = radius * radius
    outside = d2 > r2
    thc = torch.where(outside, 0.0,
                      C.sqrt(torch.where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12))))
    t = tca - thc
    miss = (tca < eps) | outside | (t < eps)
    return torch.where(miss, C.big(t), t)


def sample_light(scene, point, u_select, u1, u2, lights):
    """A uniformly chosen emissive sphere and a direction in its cone:
    (direction, inv_pdf, light index, distance, emission)."""
    count = torch.tensor(float(len(lights)), dtype=point.dtype, device=point.device)
    if len(lights):
        k = torch.clamp(torch.floor(u_select * count), 0.0, float(len(lights) - 1)).long()
        idx = lights[k]
    else:
        idx = torch.zeros(u_select.shape, dtype=torch.int64, device=point.device)
    pos, radius = C.rows(scene["sphere_pos"], idx), C.rows(scene["sphere_radius"], idx)
    direction, inv_pdf_dir = cone_sample(pos, radius, point, u1, u2)
    t_l = sphere_t_single(point, direction, pos, radius)
    l_emit = C.rows(scene["sphere_color"], idx) * C.rows(scene["sphere_illum"], idx)[..., None]
    valid = (count > 0) & (inv_pdf_dir > 1e-9)
    return direction, torch.where(valid, inv_pdf_dir * count, 0.0), idx, t_l, l_emit


def primary(scene, o, d):
    """What the deciding pass needs before the first sample: the rays'
    (t, prim) at eps 0."""
    return C.nearest(o, d, scene, 0.0)


def trace(scene, o, d, rng, num_bounces: int, kinds, first=None, words=None):
    """One NEE sample per lane (rays [N, 3], rng int32 [N, 4]).

    Deciding (`words` None): `first` = `primary(scene, o, d)`;
    returns (radiance [N, 3], rng, words int32 [num_bounces, N], live
    bounces [N]).  Replaying: `words` from the deciding run of the same
    sample; returns (radiance, rng)."""
    deciding = words is None
    n_spheres = scene["sphere_pos"].shape[0]
    n_planes = scene["plane_pos"].shape[0]
    table = C.payload(scene)
    lights = C.light_indices(scene)
    dtype = o.dtype
    ray_o, ray_d = o, d
    if deciding:
        t, prim = first
        out_words = []
    result = torch.zeros_like(o)
    throughput = torch.ones_like(o)
    prev_spec = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    live = torch.zeros(o.shape[:-1], dtype=torch.int32, device=o.device)
    for b in range(num_bounces):
        if not deciding:
            w_b = words[b]
            prim = (w_b >> PRIM_SHIFT).long()
            t = C.winner_distance(ray_o, ray_d, prim, (w_b & HIT_BIT) != 0, scene)
        hit = C.Hit(ray_o, ray_d, t, prim, scene, table)
        dead = C.near_zero(throughput) | ~hit.hit
        live = live + (~dead).to(torch.int32)

        is_bsdf_only = (hit.prim >= n_spheres) & (hit.prim < n_spheres + n_planes)
        take_emit = prev_spec | is_bsdf_only
        emit = hit.color * hit.illuminance[..., None] * throughput
        new_result = result + torch.where(take_emit[..., None], emit, 0.0)

        u, rng2 = C.gen_vec(rng, dtype)
        us = (u + 1.0) * 0.5
        next_d, tmod, is_spec = physical_bounce(hit, ray_d, us[..., 0], us[..., 1], us[..., 2],
                                                kinds)
        un, rng2 = C.gen_vec(rng2, dtype)
        us = (un + 1.0) * 0.5
        l_dir, inv_pdf, l_idx, t_l, l_emit = sample_light(scene, hit.point, us[..., 0],
                                                          us[..., 1], us[..., 2], lights)
        alive = torch.nonzero(~dead).reshape(-1) if deciding else None
        if deciding:
            occ = torch.zeros_like(dead)
            occ[alive] = C.shadow_occluded(hit.point[alive], l_dir[alive], t_l[alive],
                                           l_idx[alive], scene)
            out_words.append((hit.prim.to(torch.int32) << PRIM_SHIFT)
                             | (hit.hit.to(torch.int32) * HIT_BIT) | occ.to(torch.int32))
        else:
            occ = (w_b & OCC_BIT) != 0
        visible = ~occ & (t_l < C.big(t_l))
        cos_i = C.dot(l_dir, hit.normal)
        w = visible & (hit.brdf_kind == BRDF_MATTE) & (cos_i > 0.0)
        contrib = throughput * div(hit.color, PI) * l_emit * (cos_i * inv_pdf)[..., None]
        new_result = new_result + torch.where(w[..., None], contrib, 0.0)

        new_throughput = throughput * tmod
        d3 = dead[..., None]
        if deciding and b + 1 < num_bounces:
            t2, prim2 = t.clone(), prim.clone()
            t2[alive], prim2[alive] = C.nearest(hit.point[alive], next_d[alive], scene, EPSILON)
            t, prim = t2, prim2
        ray_o = torch.where(d3, ray_o, hit.point)
        ray_d = torch.where(d3, ray_d, next_d)
        rng = torch.where(d3, rng, rng2)
        result = torch.where(d3, result, new_result)
        throughput = torch.where(d3, 0.0, new_throughput)
        prev_spec = torch.where(dead, prev_spec, is_spec)
    if deciding:
        return result, rng, torch.stack(out_words), live
    return result, rng
