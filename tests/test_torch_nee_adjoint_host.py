"""The NEE backward kernel's hand-written adjoint, checked on the host.

``csrc/nee_vjp.cuh`` compiles under a plain C++ compiler as well as under
nvcc, so ``tests/nee_adjoint_host.cpp`` builds it with g++ (FMA contraction
off, as nvcc's ``-fmad=false``) and these tests hold it against
torch.autograd of the plain versions:

  * `bounce_vjp`, one live bounce at a few hundred random states per scene,
    with random cotangents of all its outputs: sphere, plane and triangle
    winners, emission pickup, the cosine-hemisphere sample, glossy
    reflection, the dielectric's reflection, refraction and total internal
    reflection (a glass of ior < 1), the sphere-cone and triangle-area light samples, shadowed
    and unshadowed, and the scene without emitters, against autograd of
    `ops/nee_vjp.py:bounce_reference` (one bounce at the table level);
  * `pixel_backward`, the kernel's whole per-pixel replay and reverse sweep,
    on small images at 3 and 15 bounces, in raster order: its table
    cotangents mapped back through `nee_scene_tables`
    (`table_grads_to_leaves`) against `backward_reference`, autograd of the
    plain trace, per `SceneParams` field;
  * `pixel_backward_chunked`, the replay-mode kernel's per-pixel work (the
    forward's flat loop records a chunk of samples' words, the fold-free
    reverse sweeps them, chunk after chunk), at chunks of one sample, of
    all samples and of a size that does not divide spp, at 3 and 15
    bounces, in raster order and in the sorted frame (lane i on pixel
    order[i], with the probe's primary hits): against `backward_reference`
    as above, and against the residual mode's backward over the host
    recording forward's words, whose ray cotangents it must give bit for
    bit (and, in raster order, its table cotangents too: the same sums in
    the same order; in the sorted frame within 1e-4); a pixel whose primary
    ray misses, so that every path dies at bounce 0, gets exactly zero.

Tolerance: a scale-normalised error max|a - b| / (max|b| + 1e-6) below
1e-4 per state for the state cotangents and the pixels' ray cotangents;
for one bounce's table cotangents, per column of each kind's rows, a column
held at least to a hundredth of its block's scale (`_col_err`), below 1e-4;
for the pixels' leaf gradients, per field, 1e-3.  The two sides do the same
float32 work in another order, and the host's sinf/cosf differ from
PyTorch's in the last bit.  This is the only check of the kernel's
arithmetic short of the card.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from haskell_path_tracer_torch.core import linalg
from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops import nee_vjp as NV
from haskell_path_tracer_torch.ops.intersect import INFINITE, nearest_t_prim
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render.nee import _present_kinds

torch.set_num_threads(2)
TOL = 1e-4
# The pixel backward's leaf gradients are sums over many lanes whose terms
# nearly cancel in a plane normal's components: 1e-3 per field.
LEAF_TOL = 1e-3
N_STATES = 400
HARNESS = __file__.replace("test_torch_nee_adjoint_host.py", "nee_adjoint_host.cpp")
ORIGIN = ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])


def _low_ior_glass(device):
    """The glass scene with its first sphere at ior 0.75: the estimator's
    rays meet every surface from its front (a sphere by its near root,
    planes and triangles one-sided), so only a glass of ior < 1 reflects
    totally."""
    scene = S.glassy_scene(device)
    m = scene.spheres.material
    param = m.brdf_param.clone()
    param[0] = 0.75
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, material=dataclasses.replace(m, brdf_param=param)))


SCENES = {
    "cornell": (S.cornell_scene, None),
    "glassy": (S.glassy_scene, ORIGIN),
    "glass_ior075": (_low_ior_glass, ORIGIN),
    "tri_emitters": (S.tri_emitter_scene, None),
    "zero_light": (S.zero_light_scene, None),
    "big300": (lambda d: S.big_scene(d, 300), ([0.0, 2.0, 0.0], [0.2, 0.0, 0.0])),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host harness")
    out = str(tmp_path_factory.mktemp("nee_adjoint") / "libnee_adjoint_host.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", MK.CSRC, "-o", out, HARNESS],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hpt_nee_bounce_vjp_host.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i,
                                            vp, vp, vp, vp, vp, vp, vp]
    lib.hpt_nee_bounce_vjp_host.restype = None
    lib.hpt_nee_backward_host.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i,
                                          vp, vp, vp, vp, i, i, vp, vp, vp, vp, vp]
    lib.hpt_nee_backward_host.restype = i
    lib.hpt_nee_backward_chunked_host.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i,
                                                  vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                                  vp, vp, vp, vp, vp]
    lib.hpt_nee_backward_chunked_host.restype = i
    lib.hpt_nee_backward_residual_host.argtypes = lib.hpt_nee_backward_host.argtypes
    lib.hpt_nee_backward_residual_host.restype = i
    return lib


def _p(t):
    assert t.is_contiguous()
    return t.data_ptr()


def _norm_err(a, b, dim=None):
    if dim is None:
        return ((a - b).abs().max() / (b.abs().max() + 1e-6)).item()
    return (a - b).abs().amax(dim) / (b.abs().amax(dim) + 1e-6)


def _tables(name):
    scene = SCENES[name][0]("cpu")
    kinds = _present_kinds(scene)
    return scene, NE.nee_scene_tables(scene), 1 in kinds, 2 in kinds


def _col_err(a, b):
    """Per column max|a - b| over max(max|b| of the column, 1e-2 max|b| of
    the block, 1e-6): a column whose terms cancel (a plane normal's
    component across the normal, summed over many rays) is held to a
    hundredth of its block's scale."""
    col = b.abs().amax(0)
    return (a - b).abs().amax(0) / torch.clamp(torch.maximum(col, 1e-2 * col.max()), min=1e-6)


def _table_errors(tables, got, want) -> dict:
    """Errors of the three cotangent tables, per column of each kind's rows
    (`_col_err`)."""
    ns, npl, nb, nt = tables.counts
    fold_kinds = [(0, 4 * ns, 4, "sphere"), (4 * ns, 4 * ns + 8 * npl, 8, "plane"),
                  (4 * ns + 8 * (npl + nb), tables.fold.numel(), 12, "triangle")]
    errs = {}
    for lo, hi, w, kind in fold_kinds:
        if hi > lo:
            errs[f"fold_{kind}"] = _col_err(got[0][lo:hi].reshape(-1, w),
                                            want[0][lo:hi].reshape(-1, w)).max().item()
    bounds = np.cumsum([0, *tables.counts])
    for k, kind in enumerate(("sphere", "plane", "box", "triangle")):
        if bounds[k + 1] > bounds[k]:
            rows = slice(bounds[k], bounds[k + 1])
            errs[f"payload_{kind}"] = _col_err(got[1][rows], want[1][rows]).max().item()
    errs["lights"] = _col_err(got[2], want[2]).max().item()
    return errs


def _random_states(scene, n, seed):
    """Live bounces at random rays: origins in the scene's box, half of
    them inside a sphere (the glass's inside hits and total internal
    reflection), winners from the plain fold, random decisions."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-6.0, -2.5, -14.0], [6.0, 8.0, -2.0], size=(2 * n, 3))
    pos = scene.spheres.pos.numpy()
    rad = scene.spheres.radius.numpy()
    k = rs.integers(0, len(rad), size=n)
    inside = rs.normal(size=(n, 3))
    inside *= (0.7 * rad[k] * rs.uniform(0.0, 1.0, size=n) / np.linalg.norm(inside, axis=1))[:, None]
    o[:n] = pos[k] + inside
    d = rs.normal(size=(2 * n, 3))
    tris = scene.triangles
    if tris.count:
        # A quarter of the rays aim at a point of a random triangle.
        j = rs.integers(0, tris.count, size=n // 2)
        a, b = rs.uniform(0.05, 0.5, size=(2, n // 2, 1))
        v0, v1, v2 = (x.numpy()[j] for x in (tris.v0, tris.v1, tris.v2))
        d[n:n + n // 2] = v0 + a * (v1 - v0) + b * (v2 - v0) - o[n:n + n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)
    t, prim = nearest_t_prim(o, d, scene, 0.0)
    hit = torch.nonzero(t < INFINITE).reshape(-1)
    m = len(hit)
    grid = lambda: torch.tensor(rs.integers(0, 2**24, size=(m, 3)) * 2.0**-24, dtype=torch.float32)
    state = torch.cat([o[hit], d[hit], torch.tensor(rs.uniform(0.05, 1.0, size=(m, 3)),
                                                    dtype=torch.float32), grid(), grid()], dim=1)
    state[: m // 4, 11] = 0.0  # u3 = 0: a glass reflects wherever Fresnel > 0
    decisions = torch.stack([prim[hit], torch.tensor(rs.random(m) < 0.5),
                             torch.tensor(rs.random(m) < 0.25)], dim=1).to(torch.int32)
    cot = torch.tensor(rs.normal(size=(m, 12)), dtype=torch.float32)
    return state.contiguous(), decisions.contiguous(), cot, t[hit]


@pytest.mark.parametrize("name", list(SCENES))
def test_bounce_adjoint_matches_autograd(lib, name):
    scene, tables, has_glossy, has_diel = _tables(name)
    state, decisions, cot, t_det = _random_states(scene, N_STATES, seed=len(name))
    n = state.shape[0]
    g_state = torch.zeros(n, 9)
    got = [torch.zeros_like(tables.fold), torch.zeros_like(tables.payload),
           torch.zeros_like(tables.lights)]
    lib.hpt_nee_bounce_vjp_host(
        _p(tables.fold), _p(tables.payload), _p(tables.lights), *tables.counts,
        tables.num_lights, int(has_glossy), int(has_diel), n, _p(state), _p(decisions),
        _p(cot), _p(g_state), *(_p(x) for x in got))

    leaves = [x.clone().requires_grad_() for x in (tables.fold, tables.payload, tables.lights)]
    o, d, th = (state[:, k:k + 3].clone().requires_grad_() for k in (0, 3, 6))
    h, nd, nth, emission, nee, _ = NV.bounce_reference(
        *leaves, tables.counts, tables.num_lights, o, d, th, t_det, decisions[:, 0],
        decisions[:, 1] != 0, state[:, 9:12], state[:, 12:15], decisions[:, 2] != 0,
        has_glossy, has_diel)
    loss = ((h * cot[:, 0:3]).sum() + (nd * cot[:, 3:6]).sum() + (nth * cot[:, 6:9]).sum()
            + ((emission + nee) * cot[:, 9:12]).sum())
    want = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(loss, [*leaves, o, d, th], allow_unused=True), [*leaves, o, d, th])]

    # Every branch was taken.
    prim = decisions[:, 0].long()
    ns, npl, _, nt = tables.counts
    kind = tables.payload[prim, 11]
    assert (prim < ns).sum() > 20 and (npl == 0 or ((prim >= ns) & (prim < ns + npl)).sum() > 20)
    assert nt == 0 or (prim >= ns + npl).sum() > 10
    assert not has_glossy or (kind == 1.0).sum() > 4
    assert not has_diel or (kind == 2.0).sum() > 20
    if tables.num_lights:
        assert (nee.abs().sum(-1) > 0).sum() > 20
    want_state = torch.cat(want[3:], dim=1)
    lane_err = _norm_err(g_state, want_state, dim=1)
    assert lane_err.max() < TOL, (lane_err.max().item(), int(lane_err.argmax()))
    errs = _table_errors(tables, got, want[:3])
    assert max(errs.values()) < TOL, errs


def test_dielectric_branches_are_all_taken():
    """The glass states above cover the reflection, the refraction and
    total internal reflection (classified as the kernel classifies them)."""
    scene, tables, _, _ = _tables("glass_ior075")
    state, decisions, _, t = _random_states(scene, N_STATES, seed=len("glass_ior075"))
    prim = decisions[:, 0].long()
    glass = tables.payload[prim, 11] == 2.0
    o, d = state[:, 0:3], state[:, 3:6]
    h = o + d * t[:, None]
    n = linalg.normalize_safe(h - tables.payload[prim, 0:3])
    cos_i = -linalg.dot(d, n)
    ior = tables.payload[prim, 10]
    eta = torch.where(cos_i < 0.0, ior, 1.0 / ior)
    sin2 = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = glass & (prim < tables.counts[0]) & (sin2 > 1.0)
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fres = r0 + (1.0 - r0) * (1.0 - cos_i.abs()) ** 5
    refl = glass & ~tir & (state[:, 11] < fres)
    refr = glass & ~tir & ~refl
    assert tir.sum() >= 3 and refl.sum() >= 3 and refr.sum() >= 10


def _inputs(name, H, W):
    scene, tables, has_glossy, has_diel = _tables(name)
    pose = SCENES[name][1]
    cam = world.initial_camera("cpu") if pose is None else Camera.create(*pose, 90.0, "cpu")
    rays = primary_rays(cam, W, H)
    rng = gen_seeds((H, W), 9, "cpu")
    g_rad = torch.tensor(np.random.default_rng(4).normal(size=(H, W, 3)), dtype=torch.float32)
    return scene, tables, has_glossy, has_diel, rays, rng, g_rad


def _host_backward(fn, tables, has_glossy, has_diel, rays, rng, g_rad, *args):
    """Runs a host backward entry point; returns its (d_fold, d_payload,
    d_lights, d_origin, d_direction)."""
    H, W = rng.shape[:2]
    got = [torch.zeros_like(tables.fold), torch.zeros_like(tables.payload),
           torch.zeros_like(tables.lights), torch.zeros(H, W, 3), torch.zeros(H, W, 3)]
    assert fn(_p(tables.fold), _p(tables.payload), _p(tables.lights), *tables.counts,
              tables.num_lights, int(has_glossy), int(has_diel), H * W, _p(rays.origin),
              _p(rays.direction), _p(rng), _p(g_rad), *args, *(_p(x) for x in got)) == 0
    return got


def _pixel_backward(lib, name, H, W, bounces, spp):
    scene, tables, has_glossy, has_diel, rays, rng, g_rad = _inputs(name, H, W)
    want, w_o, w_d = NV.backward_reference(scene, rays, rng, g_rad, bounces, spp)
    got = _host_backward(lib.hpt_nee_backward_host, tables, has_glossy, has_diel, rays, rng, g_rad,
                         spp, bounces)
    return _leaf_errors(scene, tables, got, want, w_o, w_d)


def _leaf_errors(scene, tables, got, want, w_o, w_d):
    leaf = NV.table_grads_to_leaves(scene, None, *got[:3])
    # Without emitters no term of the radiance depends on the geometry.
    nonzero = [f for f, w in want.items() if w.numel() and w.abs().max() > 0]
    assert len(nonzero) >= (3 if not tables.num_lights else 8), nonzero
    errs = {f: _norm_err(leaf[f], w) for f, w in want.items() if w.numel()}
    errs["d_origin"] = _norm_err(got[3], w_o)
    errs["d_direction"] = _norm_err(got[4], w_d)
    return errs


@pytest.mark.parametrize("name", list(SCENES))
def test_pixel_backward_matches_plain_backward(lib, name):
    """3 bounces, 2 samples."""
    errs = _pixel_backward(lib, name, 12, 20, 3, 2)
    assert max(errs.values()) < LEAF_TOL and max(errs["d_origin"], errs["d_direction"]) < TOL, errs


@pytest.mark.parametrize("name", ["cornell", "glassy"])
def test_pixel_backward_at_fifteen_bounces(lib, name):
    """15 bounces, 1 sample: the residual slots the kernel keeps up to its
    limit of 16, and the long reverse sweep of the glass's specular chains."""
    errs = _pixel_backward(lib, name, 8, 12, 15, 1)
    assert max(errs.values()) < LEAF_TOL and max(errs["d_origin"], errs["d_direction"]) < TOL, errs


# (scene, bounces, spp, chunk, sorted frame): chunks of one sample, of all
# samples and of a size that does not divide spp; 3 and 15 bounces; the
# raster and the sorted frame.  glassy and big300 have sky pixels, whose
# paths all die at bounce 0.
CHUNKED = [
    ("cornell", 3, 5, 1, False),
    ("cornell", 3, 5, 5, True),
    ("glassy", 3, 5, 2, False),
    ("big300", 3, 3, 2, True),
    ("glassy", 15, 2, 1, True),
    ("tri_emitters", 15, 3, 2, False),
]


@pytest.mark.parametrize("name,bounces,spp,chunk,sort", CHUNKED)
def test_chunked_replay_matches_plain_and_residual_backward(lib, name, bounces, spp, chunk, sort):
    """The replay mode's chunked per-pixel backward against the plain
    backward (per field 1e-3, rays 1e-4) and against the residual mode's
    over the host forward's words: ray cotangents bit for bit, table
    cotangents bit for bit in raster order and within 1e-4 in the sorted
    frame (the same sums in another pixel order, with cancellation)."""
    H, W = (12, 20) if bounces < 10 else (8, 12)
    scene, tables, has_glossy, has_diel, rays, rng, g_rad = _inputs(name, H, W)
    order = t0 = prim0 = None
    if sort:
        t0, prim0 = nearest_t_prim(rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3), scene, 0.0)
        t0, prim0 = t0.contiguous(), prim0.to(torch.int32).contiguous()
        order = NE._presort_order(t0.reshape(H, W)).contiguous()
    ptr = lambda t: None if t is None else _p(t)  # noqa: E731
    got = _host_backward(lib.hpt_nee_backward_chunked_host, tables, has_glossy, has_diel, rays, rng,
                         g_rad, ptr(order), ptr(t0), ptr(prim0), spp, bounces, chunk)
    resid = _host_backward(lib.hpt_nee_backward_residual_host, tables, has_glossy, has_diel, rays, rng,
                           g_rad, spp, bounces)
    assert torch.equal(got[3], resid[3]) and torch.equal(got[4], resid[4])
    for a, b in zip(got[:3], resid[:3]):
        if sort:
            assert _norm_err(a, b) < TOL
        else:
            assert torch.equal(a, b)
    want, w_o, w_d = NV.backward_reference(scene, rays, rng, g_rad, bounces, spp)
    errs = _leaf_errors(scene, tables, got, want, w_o, w_d)
    assert max(errs.values()) < LEAF_TOL and max(errs["d_origin"], errs["d_direction"]) < TOL, errs
    if name in ("glassy", "big300"):
        t, _ = nearest_t_prim(rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3), scene, 0.0)
        sky = (t >= INFINITE).reshape(H, W)
        assert sky.any()
        assert not got[3][sky].any() and not got[4][sky].any()
