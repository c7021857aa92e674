"""The plain reference of the parity estimator (the reference program's inline
integrator): one sample per lane.

A frozen copy, from commit 46789026a883eb6678717df1b19ed41c83f8556b of
this repository, of haskell_path_tracer_torch/render/integrator.py
(`trace_inline` without Russian roulette) and haskell_path_tracer_torch/
ops/brdf.py (`_matte_sample`, `_glossy_sample`, `sample`, `emittance`), in
the same float32 operation order; branches of kinds absent from the scene
are left out, which changes no value.  Deciding and replaying as in
`physical.trace`: the words hold each bounce's winner and hit bit.  Imports
torch and `core` only.
"""

from __future__ import annotations

import math

import torch

from . import core as C
from .core import BRDF_DIELECTRIC, BRDF_GLOSSY, EPSILON, INV_TWO_PI
from .physical import HIT_BIT, PRIM_SHIFT, dielectric_split


def brdf_sample(hit, ray_d, rot_vec, kinds):
    """(next origin, next direction, throughput modifier) of the
    reference's BRDFs from three uniforms in [-1, 1]."""
    p = hit.brdf_param
    q = C.angles_to_quaternion(math.pi * rot_vec)
    direction = C.quat_rotate(q, hit.normal)
    b = p / math.pi * C.dot(direction, hit.normal)
    is_glossy = hit.brdf_kind == BRDF_GLOSSY
    is_diel = hit.brdf_kind == BRDF_DIELECTRIC
    if BRDF_GLOSSY in kinds:
        reflection = C.reflect(ray_d, hit.normal)
        qg = C.angles_to_quaternion((1.0 - p)[..., None] * rot_vec)
        glossy_dir = C.quat_rotate(qg, reflection)
        glossy_b = torch.clamp(C.dot(glossy_dir, reflection), min=0.0)
        direction = torch.where(is_glossy[..., None], glossy_dir, direction)
        b = torch.where(is_glossy, glossy_b, b)
    if BRDF_DIELECTRIC in kinds:
        diel_u = (rot_vec[..., 0] + 1.0) * 0.5
        refl, refr, reflect_prob = dielectric_split(ray_d, hit.normal, p)
        diel_dir = torch.where((diel_u < reflect_prob)[..., None], refl, refr)
        direction = torch.where(is_diel[..., None], diel_dir, direction)
        b = torch.where(is_diel, torch.ones_like(reflect_prob), b)
    origin = hit.point + direction * EPSILON
    scale = torch.where(is_diel, b, b * INV_TWO_PI)
    return origin, direction, hit.color * scale[..., None]


def primary(scene, o, d):
    """Nothing: each bounce's fold runs in `trace`."""
    return None


def trace(scene, o, d, rng, num_bounces: int, kinds, first=None, words=None):
    """One parity sample per lane (rays [N, 3], rng int32 [N, 4]); `first`
    is not read.

    Deciding (`words` None): returns (radiance [N, 3], rng, words int32
    [num_bounces, N], live bounces [N]).  Replaying: (radiance, rng)."""
    deciding = words is None
    table = C.payload(scene)
    ray_o, ray_d = o, d
    out_words = []
    result = torch.zeros_like(o)
    throughput = torch.ones_like(o)
    live = torch.zeros(o.shape[:-1], dtype=torch.int32, device=o.device)
    for b in range(num_bounces):
        if deciding:
            t, prim = C.nearest(ray_o, ray_d, scene)
            out_words.append((prim.to(torch.int32) << PRIM_SHIFT)
                             | ((t < C.big(t)).to(torch.int32) * HIT_BIT))
        else:
            prim = (words[b] >> PRIM_SHIFT).long()
            t = C.winner_distance(ray_o, ray_d, prim, (words[b] & HIT_BIT) != 0, scene)
        hit = C.Hit(ray_o, ray_d, t, prim, scene, table)
        dead = C.near_zero(throughput) | ~hit.hit
        live = live + (~dead).to(torch.int32)
        rot_vec, rng2 = C.gen_vec(rng, o.dtype)
        next_o, next_d, tmod = brdf_sample(hit, ray_d, rot_vec, kinds)
        new_result = result + hit.color * hit.illuminance[..., None] * throughput
        new_throughput = throughput * tmod
        d3 = dead[..., None]
        ray_o = torch.where(d3, ray_o, next_o)
        ray_d = torch.where(d3, ray_d, next_d)
        rng = torch.where(d3, rng, rng2)
        result = torch.where(d3, result, new_result)
        throughput = torch.where(d3, 0.0, new_throughput)
    if deciding:
        return result, rng, torch.stack(out_words), live
    return result, rng
