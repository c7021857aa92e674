"""The plain reference's shared parts: float math, SFC32, primary rays, the
scene's tensors and the ray-primitive tests of spheres and planes.

Frozen copies, from commit 46789026a883eb6678717df1b19ed41c83f8556b of this
repository, of
  * haskell_path_tracer_torch/core/linalg.py (dot, quadrance, sqrt, cross,
    normalize_safe, near_zero, angles_to_quaternion, quat_rotate, reflect);
  * haskell_path_tracer_torch/ops/rng.py (sfc32_next, sfc32_float, gen_vec,
    np_gen_seeds, np_sfc32_next);
  * haskell_path_tracer_torch/models/camera.py (camera_basis, primary_rays);
  * haskell_path_tracer_torch/ops/intersect.py (sphere_distances,
    plane_distances, _first_min, the nearest fold of spheres then planes,
    hit_from_t_prim, sphere_occluded_any and shadow_occluded);
  * haskell_path_tracer_torch/diff/grad.py (params_to_scene's plane normal).
Each expression keeps the copied code's float32 operation order, so the
reference takes the decisions the program's plain path takes.  Only spheres
and planes: the configurations have no boxes or triangles.

A scene here is a dict of tensors (`FIELDS`), which every function reads;
`dtype` below float32 gives the control (`cast_scene`).  This package
imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INFINITE = float(np.finfo(np.float32).max)
EPSILON = float(np.float32(0.002))
PLANE_DENOM_EPS = float(np.float32(1e-6))
NEAR_ZERO_EPS = 1e-6
INV_2_24 = float(np.float32(1.0 / (1 << 24)))
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))
BRDF_MATTE, BRDF_GLOSSY, BRDF_DIELECTRIC = 0, 1, 2

# The differentiable leaves of a sphere-and-plane scene, in the program's
# SceneParams order, and the integer kinds beside them.
FIELDS = ("sphere_pos", "sphere_radius", "sphere_color", "sphere_illum", "sphere_param",
          "plane_pos", "plane_normal", "plane_color", "plane_illum", "plane_param")
KINDS = ("sphere_kind", "plane_kind")


def big(x):
    """INFINITE, the miss distance, in `x`'s precision (float32's largest
    value, or the control's)."""
    return torch.finfo(x.dtype).max


def rows(table, idx):
    """`table[idx]` as `index_select`, whose backward (an index_add) PyTorch
    runs far faster on CUDA than advanced indexing's when many lanes read
    one row."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


# Float math (core/linalg.py) ------------------------------------------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def quadrance(v):
    return dot(v, v)


def sqrt(x):
    """The correctly rounded square root: through float64 off the GPU."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def normalize_safe(v, eps: float = 1e-20):
    n = torch.clamp(torch.sqrt(quadrance(v)), min=eps)
    return v / n[..., None]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def near_zero(v):
    return quadrance(v) <= NEAR_ZERO_EPS


def angles_to_quaternion(angles):
    roll, pitch, yaw = angles[..., 0], angles[..., 1], angles[..., 2]
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    y = sy * cp * sr + cy * sp * cr
    z = sy * cp * cr - cy * sp * sr
    return torch.stack([w, x, y, z], dim=-1)


def quat_rotate(q, v):
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = cross(u, v) * 2.0
    return v + w * t + cross(u, t)


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


# SFC32 (ops/rng.py), words held as int32 --------------------------------------


def srl(x, k: int):
    return (x >> k) & ((1 << (32 - k)) - 1)


def sfc32_next(state):
    a, b, c, counter = state.unbind(-1)
    t = a + b + counter
    counter = counter + 1
    a = b ^ srl(b, 9)
    b = c + (c << 3)
    c = ((c << 21) | srl(c, 11)) + t
    return t, torch.stack([a, b, c, counter], dim=-1)


def gen_vec(state, dtype=torch.float32):
    """Three uniforms in [-1, 1]^3 (x, y, z order), then the new state."""
    out = []
    for _ in range(3):
        bits, state = sfc32_next(state)
        out.append(srl(bits, 8).to(torch.float32) * INV_2_24)
    return (torch.stack(out, dim=-1) * 2.0 - 1.0).to(dtype), state


def np_sfc32_next(state):
    a, b, c, counter = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    with np.errstate(over="ignore"):
        t = a + b + counter
        counter = counter + np.uint32(1)
        a = b ^ (b >> np.uint32(9))
        b = c + (c << np.uint32(3))
        c = ((c << np.uint32(21)) | (c >> np.uint32(11))) + t
    return t, np.stack([a, b, c, counter], axis=-1)


def seed_states(shape, seed: int, pixels=None) -> np.ndarray:
    """The per-pixel SFC32 states that a progressive render seeded with
    `seed` starts from: numpy PCG64 words, then 12 warm-up rounds; int32
    [*shape, 4], or [len(pixels), 4] for the flat pixel indices `pixels`
    (the words are drawn for the whole image, the rounds run on those)."""
    words = np.random.default_rng(seed).integers(0, 2**32, size=(*tuple(shape), 4),
                                                 dtype=np.uint32)
    if pixels is not None:
        words = words.reshape(-1, 4)[np.asarray(pixels)]
    for _ in range(12):
        _, words = np_sfc32_next(words)
    return np.ascontiguousarray(words).view(np.int32)


# Camera (models/camera.py) ------------------------------------------------------


def primary_rays(position, rotation, fov, width: int, height: int):
    """(origin, direction) [height, width, 3] of the pinhole camera: float32
    tensors `position` [3], `rotation` [3] (roll, pitch, yaw), `fov` []."""
    device = position.device
    f32 = dict(dtype=torch.float32, device=device)
    screen_angle = (fov.to(torch.float32) * math.pi / 180.0) / 2.0
    screen_distance = 1.0 / torch.tan(screen_angle)
    screen_half_width = torch.tan(screen_angle) * screen_distance
    forward = torch.tensor((0.0, 0.0, -1.0), **f32)
    c_dir = quat_rotate(angles_to_quaternion(rotation), forward)
    center = position + c_dir * screen_distance
    up = torch.tensor((0.0, 1.0, 0.0), **f32)
    right_offset = normalize_safe(cross(center - position, up)) / screen_half_width
    aspect = torch.tensor(float(width), **f32) / torch.tensor(float(height), **f32)
    top_offset = cross(c_dir, right_offset) / aspect
    xs = torch.arange(width, **f32).expand(height, width)
    ys = torch.arange(height, **f32)[:, None].expand(height, width)
    ys = ys + torch.tensor(0.0, **f32)
    screen_x = xs / float(width) * 2.0 - 1.0
    screen_y = ys / float(-height) * 2.0 + 1.0
    virtual_point = center + right_offset * screen_x[..., None] + top_offset * screen_y[..., None]
    direction = normalize_safe(virtual_point - position)
    return position.expand_as(direction).contiguous(), direction.contiguous()


# Scenes ----------------------------------------------------------------------------


def scene_from_arrays(arrays: dict, device) -> dict:
    """The reference's scene from the benchmark's numpy arrays
    (`ptbench/scenes.py:build`): float32 leaves `FIELDS`, int32 kinds."""
    out = {}
    for key in FIELDS:
        out[key] = torch.as_tensor(np.asarray(arrays[key], np.float32), device=device)
    for key in KINDS:
        out[key] = torch.as_tensor(np.asarray(arrays[key], np.int32), device=device)
    return out


def scene_of_params(leaves: dict, kinds: dict) -> dict:
    """A scene from SceneParams-like leaves: the plane normal renormalised
    as the program's `params_to_scene` does."""
    norm = torch.sqrt(torch.clamp((leaves["plane_normal"] ** 2).sum(dim=-1, keepdim=True),
                                  min=1e-12))
    return {**leaves, "plane_normal": leaves["plane_normal"] / norm, **kinds}


def cast_scene(scene: dict, dtype) -> dict:
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in scene.items()}


def light_indices(scene: dict) -> torch.Tensor:
    """The NEE emitters: the scene's frozen set "lights" where it has one (a
    training run fixes the emitters of its first state, as the program's
    `light_idx` does), else the emissive spheres' indices."""
    if "lights" in scene:
        return scene["lights"]
    return torch.nonzero(scene["sphere_illum"] > 0.0).reshape(-1)


def payload(scene: dict):
    """Per-primitive rows [S+M, 12]: aux (sphere center | plane normal),
    aux2 (zeros), color, illuminance, brdf_param, brdf_kind."""
    def rows(aux, color, illum, param, kind):
        return torch.cat([aux, torch.zeros_like(aux), color, illum[:, None], param[:, None],
                          kind.to(aux.dtype)[:, None]], dim=-1)
    return torch.cat([
        rows(scene["sphere_pos"], scene["sphere_color"], scene["sphere_illum"],
             scene["sphere_param"], scene["sphere_kind"]),
        rows(scene["plane_normal"], scene["plane_color"], scene["plane_illum"],
             scene["plane_param"], scene["plane_kind"]),
    ], dim=0)


# Ray-primitive tests (ops/intersect.py) ------------------------------------------------


def sphere_distances(o, d, pos, radius, reject_below=0.0):
    """[..., N] distances to every sphere, INFINITE on a miss."""
    l = pos - o[..., None, :]
    tca = dot(l, d[..., None, :])
    d2 = quadrance(l) - tca * tca
    r2 = radius * radius
    outside = d2 > r2
    thc_arg = torch.where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12))
    thc = torch.where(outside, 0.0, sqrt(thc_arg))
    t = tca - thc
    miss = (tca < reject_below) | outside | (t < reject_below)
    return torch.where(miss, big(t), t)


def plane_distances(o, d, pos, normal, reject_below=0.0):
    """[..., M] distances to every one-sided plane."""
    denom = dot(d[..., None, :], normal)
    num = dot(pos - o[..., None, :], normal)
    denom_safe = torch.where(denom == 0.0, PLANE_DENOM_EPS * 0.5, denom)
    dist = num / denom_safe
    miss = (denom > PLANE_DENOM_EPS) | (dist < reject_below)
    return torch.where(miss, big(dist), dist)


def first_min(dists):
    k = dists.shape[-1]
    kt = dists.amin(dim=-1)
    iota = torch.arange(k, device=dists.device)
    karg = torch.where(dists == kt[..., None], iota, k).amin(dim=-1)
    return kt, torch.clamp(karg, max=k - 1)


def lane_chunk(scene: dict) -> int:
    """Rays per block of the folds, so a [rays, spheres, 3] block stays
    near 2^24 elements."""
    return max(1024, (1 << 24) // max(1, scene["sphere_pos"].shape[0]))


def nearest(o, d, scene: dict, reject_below=0.0):
    """The nearest (t, prim) of rays [N, 3], (INFINITE, 0) on a miss: the
    first-index minimum over the spheres, then the planes merged with a
    strict `<`, in blocks of rays.  No gradient."""
    n_spheres = scene["sphere_pos"].shape[0]
    step = lane_chunk(scene)
    ts = [torch.empty(0, dtype=o.dtype, device=o.device)]
    prims = [torch.empty(0, dtype=torch.int64, device=o.device)]
    with torch.no_grad():
        for lo in range(0, o.shape[0], step):
            oc, dc = o[lo:lo + step], d[lo:lo + step]
            t, prim = first_min(sphere_distances(oc, dc, scene["sphere_pos"],
                                                 scene["sphere_radius"], reject_below))
            if scene["plane_pos"].shape[0]:
                kt, karg = first_min(plane_distances(oc, dc, scene["plane_pos"],
                                                     scene["plane_normal"], reject_below))
                better = kt < t
                t = torch.where(better, kt, t)
                prim = torch.where(better, n_spheres + karg, prim)
            ts.append(t)
            prims.append(prim)
    return torch.cat(ts), torch.cat(prims)


def winner_distance(o, d, prim, hit, scene: dict):
    """The distance to each ray's recorded winner, recomputed as the fold
    computed it (so its value is the fold's and its gradient reaches the
    winner's leaves); INFINITE where the ray missed."""
    n_spheres = scene["sphere_pos"].shape[0]
    is_sphere = prim < n_spheres
    si = torch.clamp(prim, max=n_spheres - 1)
    t = sphere_distance_rows(o, d, rows(scene["sphere_pos"], si), rows(scene["sphere_radius"], si))
    if scene["plane_pos"].shape[0]:
        pi = torch.clamp(prim - n_spheres, min=0, max=scene["plane_pos"].shape[0] - 1)
        t_plane = plane_distance_rows(o, d, rows(scene["plane_pos"], pi),
                                      rows(scene["plane_normal"], pi))
        t = torch.where(is_sphere, t, t_plane)
    return torch.where(hit, t, big(t))


def sphere_distance_rows(o, d, pos, radius):
    """`sphere_distances`' value for one sphere per ray (no miss test)."""
    l = pos - o
    tca = dot(l, d)
    d2 = quadrance(l) - tca * tca
    r2 = radius * radius
    outside = d2 > r2
    thc = torch.where(outside, 0.0,
                      sqrt(torch.where(outside, 1.0, torch.clamp(r2 - d2, min=1e-12))))
    return tca - thc


def plane_distance_rows(o, d, pos, normal):
    """`plane_distances`' value for one plane per ray (no miss test)."""
    denom = dot(d, normal)
    num = dot(pos - o, normal)
    return num / torch.where(denom == 0.0, PLANE_DENOM_EPS * 0.5, denom)


class Hit:
    """The winner's payload (hit_from_t_prim)."""

    def __init__(self, o, d, t, prim, scene: dict, table):
        self.t, self.prim = t, prim
        self.hit = t < big(t)
        fields = rows(table, prim)
        aux = fields[..., 0:3]
        t_safe = torch.where(self.hit, t, 0.0)
        self.point = o + d * t_safe[..., None]
        is_sphere = prim < scene["sphere_pos"].shape[0]
        self.normal = torch.where(is_sphere[..., None], normalize_safe(self.point - aux), aux)
        self.color = fields[..., 6:9]
        self.illuminance = fields[..., 9]
        self.brdf_kind = torch.round(fields[..., 11]).to(torch.int32)
        self.brdf_param = fields[..., 10]


def shadow_occluded(point, l_dir, t_l, exclude_prim, scene: dict):
    """True where a sphere other than `exclude_prim`, or a plane, meets the
    segment [EPSILON, t_l) from `point` along `l_dir` (the sqrt-free sphere
    test), in blocks of rays.  No gradient."""
    step = lane_chunk(scene)
    pos, radius = scene["sphere_pos"], scene["sphere_radius"]
    iota = torch.arange(pos.shape[0], device=point.device)
    r2 = radius * radius
    out = [torch.empty(0, dtype=torch.bool, device=point.device)]
    with torch.no_grad():
        for lo in range(0, point.shape[0], step):
            p, ld, tl = point[lo:lo + step], l_dir[lo:lo + step], t_l[lo:lo + step]
            l = pos - p[..., None, :]
            ll = quadrance(l)
            tca = dot(l, ld[..., None, :])
            h = r2 - (ll - tca * tca)
            a1 = tca - EPSILON
            a2 = tca - tl[..., None]
            hits = ((h >= 0.0) & (a1 >= 0.0) & (a1 * a1 >= h) & ((a2 < 0.0) | (a2 * a2 < h))
                    & (iota != exclude_prim[lo:lo + step][..., None]))
            occ = hits.any(dim=-1)
            if scene["plane_pos"].shape[0]:
                pd = plane_distances(p, ld, scene["plane_pos"], scene["plane_normal"])
                occ = occ | ((pd >= EPSILON) & (pd < tl[..., None])).any(dim=-1)
            out.append(occ)
    return torch.cat(out)


def device_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def present_kinds(scene) -> frozenset:
    """The BRDF kinds of the scene's surfaces."""
    return frozenset(torch.cat([scene["sphere_kind"], scene["plane_kind"]]).unique().tolist())
