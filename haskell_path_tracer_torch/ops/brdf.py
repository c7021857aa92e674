"""BRDF importance sampling: next-ray direction and throughput modifier.

Counterpart of ``haskell_path_tracer_tpu/ops/brdf.py``, the reference's
`calcNextRay` formulas verbatim:

  * Matte p: rotate the normal by the quaternion of `pi * rot_vec`;
    weight `b = p/pi * dot(next, normal)`;
  * Glossy p: mirror-reflect, rotate by `(1-p) * rot_vec`;
    weight `b = max(0, dot(next, reflection))`;
  * Dielectric (the JAX package's extension): Snell refraction, total
    internal reflection and a Schlick-Fresnel choice driven by rot_vec.x,
    so every material draws exactly three uniforms per bounce;
  * the next ray starts `EPSILON` along the new direction; the throughput
    modifier is `color * b / (2 pi)` (dielectric: `color * b`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import linalg
from ..models.objects import BRDF_DIELECTRIC, BRDF_GLOSSY
from . import rng as rng_ops
from .intersect import EPSILON, Hit

INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))


def _matte_sample(normal, rot_vec, p):
    q = linalg.angles_to_quaternion(math.pi * rot_vec)
    nxt = linalg.quat_rotate(q, normal)
    b = p / math.pi * linalg.dot(nxt, normal)
    return nxt, b


def _glossy_sample(ray_d, normal, rot_vec, p):
    reflection = linalg.reflect(ray_d, normal)
    q = linalg.angles_to_quaternion((1.0 - p)[..., None] * rot_vec)
    nxt = linalg.quat_rotate(q, reflection)
    b = torch.clamp(linalg.dot(nxt, reflection), min=0.0)
    return nxt, b


def _pow5(x):
    """x**5 in the multiplication order of JAX's integer_pow: x * (x^2)^2."""
    x2 = x * x
    return x * (x2 * x2)


def dielectric_split(ray_d, normal, ior):
    """Glass: (refl_dir, refr_dir, reflect_weight).  `reflect_weight` is the
    Schlick-Fresnel reflectance, 1 under total internal reflection (where
    `refr_dir` is a zero-weight placeholder)."""
    cos_i = -linalg.dot(ray_d, normal)
    inside = cos_i < 0.0
    n = torch.where(inside[..., None], -normal, normal)
    cos_i = cos_i.abs()
    eta = torch.where(inside, ior, 1.0 / ior)  # n1/n2

    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t_arg = torch.where(tir, 1.0, torch.clamp(1.0 - sin2_t, min=1e-12))
    cos_t = torch.where(tir, 0.0, linalg.sqrt(cos_t_arg))

    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    fresnel = r0 + (1.0 - r0) * _pow5(1.0 - cos_i)
    reflect_weight = torch.where(tir, 1.0, fresnel)

    refl = linalg.reflect(ray_d, n)
    refr = eta[..., None] * ray_d + (eta * cos_i - cos_t)[..., None] * n
    # normalize_safe with the correctly rounded square root (linalg.sqrt).
    refr = refr / torch.clamp(linalg.sqrt(linalg.quadrance(refr)), min=1e-20)[..., None]
    return refl, refr, reflect_weight


def sample(hit: Hit, ray_d: torch.Tensor, rng_state: torch.Tensor):
    """Sample the next bounce for a batch of hits.

    Returns (next_origin, next_direction, throughput_mod [..., 3],
    new_state).  Draws exactly three uniforms per lane (`genVec`)."""
    rot_vec, new_state = rng_ops.gen_vec(rng_state)
    p = hit.brdf_param

    matte_dir, matte_b = _matte_sample(hit.normal, rot_vec, p)
    glossy_dir, glossy_b = _glossy_sample(ray_d, hit.normal, rot_vec, p)
    # rot_vec.x mapped to [0, 1) is the Fresnel uniform.
    diel_u = (rot_vec[..., 0] + 1.0) * 0.5
    refl, refr, reflect_prob = dielectric_split(ray_d, hit.normal, p)
    diel_dir = torch.where((diel_u < reflect_prob)[..., None], refl, refr)
    diel_b = torch.ones_like(reflect_prob)

    is_glossy = hit.brdf_kind == BRDF_GLOSSY
    is_diel = hit.brdf_kind == BRDF_DIELECTRIC
    direction = torch.where(
        is_diel[..., None],
        diel_dir,
        torch.where(is_glossy[..., None], glossy_dir, matte_dir),
    )
    b = torch.where(is_diel, diel_b, torch.where(is_glossy, glossy_b, matte_b))

    origin = hit.point + direction * EPSILON
    scale = torch.where(is_diel, b, b * INV_TWO_PI)
    throughput_mod = hit.color * scale[..., None]
    return origin, direction, throughput_mod, new_state


def emittance(hit: Hit) -> torch.Tensor:
    """emittance = color * illuminance."""
    return hit.color * hit.illuminance[..., None]
