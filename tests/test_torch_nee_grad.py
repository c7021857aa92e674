"""The physical/NEE gradient of the PyTorch port against the JAX package, on
the CPU, at 32x16, 2 spp and 3 bounces.

  * the plain route, `loss_and_grad(estimator="physical",
    backend="torch")`, and its ray cotangents against `jax.vjp` of the JAX
    package's XLA estimator (`trace_physical(fused=False)` in a scan), on
    cornell8, tri, glassy, zero_light and big200 (past the chunked fold);
  * the dual-query loop, `trace_physical(fused=True)` (with 200 spheres its
    primary hit through `sphere_nearest`), against the JAX package's in
    interpret mode and against the plain loop, and its gradient against the
    plain loop's; the plain dual query and nearest-sphere fold and their
    backwards against `jax.vjp` of `sphere_dual_query` and
    `sphere_nearest_pallas` in interpret mode;
  * the kernel route's CPU version (`trace_physical_nee_diff` on CPU
    tensors, the plain trace) against the golden gradients and a central
    finite difference;
  * the routes of `render_radiance`, that nothing launches on the CPU, and
    that the launchers refuse CPU tensors.

The kernel's own arithmetic, its table cotangents mapped back through
`nee_scene_tables` against `backward_reference`, is held on the host in
tests/test_torch_nee_adjoint_host.py.

The JAX gradients come from one jitted pullback per case, shared through a
module-scoped fixture; no test compiles the JAX package's interpret-mode
NEE backward kernel.

Tolerance (tests/test_pallas_nee_vjp.py): loss rtol 1e-5; per
`SceneParams` field a normalised error max|a - b| / max|b| below 5e-3,
with at least 8 fields nonzero (3 without emitters).  The dual-query
route's gradient against the plain loop's: rtol 5e-4, atol 5e-6
(tests/test_grad.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays
from haskell_path_tracer_tpu.ops.pallas_intersect import sphere_dual_query as jax_dual_query
from haskell_path_tracer_tpu.ops.pallas_intersect import sphere_nearest_pallas as jax_nearest
from haskell_path_tracer_tpu.render import nee as jnee

from haskell_path_tracer_torch.diff import grad as G
from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.objects import Rays
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops import nee_vjp as NV
from haskell_path_tracer_torch.ops import sphere_fold as SF
from haskell_path_tracer_torch.ops.intersect import EPSILON, INFINITE
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render import nee as tnee

from test_pallas_nee import assert_lane_parity
from torch_port_fixtures import (
    NEE_GRAD_BOUNCES,
    NEE_GRAD_CASES,
    NEE_GRAD_GOLDEN_CASES,
    NEE_GRAD_GOLDEN_PATH,
    NEE_GRAD_SPP,
    NEE_GRAD_TARGET,
    jax_nee_grad_trace,
    jax_nee_scene,
    nee_grad_golden_arrays,
    torch_camera,
    torch_rays,
    torch_scene,
)

torch.set_num_threads(2)
B, SPP = NEE_GRAD_BOUNCES, NEE_GRAD_SPP
TOL = 5e-3
LANE_MAX_OFF = 0.005  # assert_lane_parity's share of lanes
FIELDS = G.SceneParams._fields


@pytest.fixture(scope="module")
def jax_grads():
    """case -> jax_nee_grad_trace(case), each computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = jax_nee_grad_trace(case)
        return cache[case]

    return get


def _inputs(t):
    """(scene, rays, rng, wts) of a case's arrays, on the CPU."""
    return (C.scene_from_numpy(t["scene"], "cpu"), torch_rays(t),
            C.rng_from_numpy(t["rng_in"], "cpu"), torch.as_tensor(t["wts"]))


def _golden(case):
    with np.load(NEE_GRAD_GOLDEN_PATH) as z:
        arrays = {k[len(case) + 2:]: z[k] for k in z.files if k.startswith(f"{case}__")}
    arrays["scene"] = {k[len("scene__"):]: v for k, v in arrays.items() if k.startswith("scene__")}
    return arrays


def _norm_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _assert_fields(got, want, tol, min_nonzero):
    """got: {field: tensor}; want: {field: array}."""
    nonzero, errs = 0, {}
    for field in FIELDS:
        b = np.asarray(want[field])
        if b.size == 0:
            continue
        a = got[field].detach().numpy()
        assert np.isfinite(a).all(), field
        errs[field] = _norm_err(a, b)
        nonzero += int(np.abs(b).max() > 0)
    assert max(errs.values()) < tol, errs
    assert nonzero >= min_nonzero, nonzero


def _min_nonzero(case):
    # Without emitters only the plane emission reaches the film.
    return 3 if case == "zero_light" else 8


@pytest.mark.parametrize("case", list(NEE_GRAD_CASES))
def test_plain_gradient_matches_jax(jax_grads, case):
    """loss_and_grad(backend="torch") against the XLA estimator's MSE
    gradient."""
    t = jax_grads(case)
    scene, rays, rng, _ = _inputs(t)
    cam = torch_camera(jax_nee_scene(case)[1])
    assert torch.equal(primary_rays(cam, 32, 16).origin, rays.origin)
    target = torch.full((16, 32, 3), NEE_GRAD_TARGET)
    loss, grads = G.loss_and_grad(G.scene_to_params(scene), scene, cam, target, rng,
                                  num_bounces=B, spp=SPP, estimator="physical", backend="torch")
    np.testing.assert_allclose(float(loss), float(t["mse_loss"]), rtol=1e-5)
    _assert_fields(grads._asdict(), {f: t[f"mse_d_{f}"] for f in FIELDS}, TOL, _min_nonzero(case))


@pytest.mark.parametrize("case", list(NEE_GRAD_CASES))
def test_plain_ray_cotangents_match_jax(jax_grads, case):
    """The primary rays' cotangents of sum(image * wts) through the plain
    route against the XLA estimator's."""
    t = jax_grads(case)
    scene, rays, rng, wts = _inputs(t)
    o, d = rays.origin.requires_grad_(), rays.direction.requires_grad_()
    img = G._physical_radiance(scene, Rays(origin=o, direction=d), rng, B, SPP, "torch", None, None)
    g_o, g_d = torch.autograd.grad((img * wts).sum(), [o, d])
    for got, want in ((g_o, t["d_origin"]), (g_d, t["d_direction"])):
        # Without emitters nothing depends on where a ray lands.
        assert (np.abs(want).max() > 0) == (case != "zero_light")
        # Per lane, as assert_lane_parity counts lanes: a lane may part
        # on a last-bit difference of sin/cos.
        lane = np.abs(got.numpy() - want).max(-1) / max(np.abs(want).max(), 1e-6)
        assert (lane >= TOL).mean() <= LANE_MAX_OFF, np.sort(lane.ravel())[-3:]


@pytest.mark.parametrize("case", ["cornell8", "glassy", "big200"])
def test_fused_trace_matches_jax_fused_and_plain(case):
    """trace_physical(fused=True) on the CPU (the dual query's plain version,
    and on big200 the nearest-sphere fold's for the primary hit) against
    the JAX package's fused trace in interpret mode, lane parity, and
    against the port's plain loop, bit for bit."""
    jscene, jcam = jax_nee_scene(case)
    jr = jax_primary_rays(jcam, 32, 16)
    rays = torch_rays({"origin": np.asarray(jr.origin), "direction": np.asarray(jr.direction)})
    rng = gen_seeds((16, 32), 7, "cpu")
    scene = torch_scene(jscene)
    got = tnee.trace_physical(scene, rays, rng, B, fused=True)
    plain = tnee.trace_physical(scene, rays, rng, B, fused=False)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    want = jnee.trace_physical(jscene, jr, jnp.asarray(rng.numpy().view(np.uint32)), B, nee=True,
                               fused=True, interpret=True)
    assert_lane_parity(np.asarray(want[1]), C.rng_to_numpy(got[1]), np.asarray(want[0]),
                       got[0].numpy())
    assert got[0].abs().max() > 0


def _dual_inputs(n_spheres, rays, seed):
    rs = np.random.default_rng(seed)
    scene = S.big_scene("cpu", n_spheres)
    f = lambda a: np.asarray(a, np.float32)
    o = f(rs.uniform([-20, 0, -40], [20, 5, -5], size=(rays, 3)))
    # BSDF rays: half towards a random sphere's center, half anywhere.
    d = scene.spheres.pos.numpy()[rs.integers(0, n_spheres, size=rays)] - o
    d[rays // 2:] = rs.normal(size=(rays - rays // 2, 3))
    d = f(d / np.linalg.norm(d, axis=1, keepdims=True))
    # Shadow rays towards a random sphere's center, ending at its surface.
    k = rs.integers(0, n_spheres, size=rays)
    to_c = scene.spheres.pos.numpy()[k] - o
    dist = np.linalg.norm(to_c, axis=1)
    b = f(to_c / dist[:, None])
    tl = f(np.maximum(dist - scene.spheres.radius.numpy()[k], 0.01))
    alive = (rs.random(rays) < 0.8).astype(np.int32)
    return scene, o, d, b, tl, k.astype(np.int32), alive


def test_dual_query_and_backward_match_jax():
    """The plain dual query and its Function's backward against the JAX
    package's `sphere_dual_query` in interpret mode (lanes with alive = 1;
    the port returns a miss on the others), 200 spheres, 512 rays; the
    cotangent of t on the lanes whose winner agrees."""
    scene, o, d, b, tl, li, alive = _dual_inputs(200, 512, 3)
    pos, rad = scene.spheres.pos, scene.spheres.radius
    T = torch.as_tensor
    leaves = [T(o).requires_grad_(), T(d).requires_grad_(), pos.clone().requires_grad_(),
              rad.clone().requires_grad_()]
    t, prim, occ = SF.sphere_dual_query(leaves[0], leaves[1], T(b), T(tl), T(li), T(alive),
                                        leaves[2], leaves[3])
    want, vjp = jax.vjp(
        lambda o_, d_, p_, r_: jax_dual_query(o_, d_, b, tl, li, alive, p_, r_, EPSILON, 32, 8, True)[0],
        o, d, pos.numpy(), rad.numpy())
    _, j_prim, j_occ = jax_dual_query(o, d, b, tl, li, alive, pos.numpy(), rad.numpy(), EPSILON, 32, 8,
                                      True)
    live = alive != 0
    t_np, j_t = t.detach().numpy(), np.asarray(want)
    same = live & (prim.numpy() == np.asarray(j_prim))
    hit = same & (j_t < INFINITE)
    # XLA's CPU code may contract a*b+c, which moves the far spheres'
    # cancelling r^2 - (|l|^2 - tca^2): t within 1e-4 relative, and a
    # winner or shadow decision may part on 0.5% of the lanes.
    assert same.sum() >= (1 - LANE_MAX_OFF) * live.sum() and hit.sum() > 50
    assert (occ.numpy() == np.asarray(j_occ))[live].mean() >= 1 - LANE_MAX_OFF
    assert np.asarray(j_occ)[live].sum() > 20
    np.testing.assert_allclose(t_np[hit], j_t[hit], rtol=1e-4)
    assert (t_np[~live] == INFINITE).all() and not occ.numpy()[~live].any()
    g_t = np.where(hit, np.random.default_rng(4).normal(size=len(o)), 0.0).astype(np.float32)
    got = torch.autograd.grad(t, leaves, torch.as_tensor(g_t))
    for a, w in zip(got, vjp(jnp.asarray(g_t))):
        assert _norm_err(a.numpy(), w) < 1e-4


def test_sphere_nearest_and_backward_match_jax():
    """The plain nearest-sphere fold and its Function's backward against the
    JAX package's `sphere_nearest_pallas` in interpret mode, 200 spheres,
    512 rays, at eps 0 (the primary hit) and EPSILON; the cotangent of t on
    the lanes whose winner agrees."""
    scene, o, d, *_ = _dual_inputs(200, 512, 5)
    pos, rad = scene.spheres.pos, scene.spheres.radius
    for eps in (0.0, EPSILON):
        leaves = [torch.as_tensor(o).requires_grad_(), torch.as_tensor(d).requires_grad_(),
                  pos.clone().requires_grad_(), rad.clone().requires_grad_()]
        t, prim = SF.sphere_nearest(*leaves, eps)
        assert prim.dtype == torch.int32
        want, vjp = jax.vjp(lambda o_, d_, p_, r_: jax_nearest(o_, d_, p_, r_, eps, 8, True)[0],
                            o, d, pos.numpy(), rad.numpy())
        j_prim = np.asarray(jax_nearest(o, d, pos.numpy(), rad.numpy(), eps, 8, True)[1])
        t_np, j_t = t.detach().numpy(), np.asarray(want)
        same = prim.numpy() == j_prim
        hit = same & (j_t < INFINITE)
        # As for the dual query: XLA's CPU code may contract a*b+c.
        assert same.mean() >= 1 - LANE_MAX_OFF and hit.sum() > 200
        np.testing.assert_allclose(t_np[hit], j_t[hit], rtol=1e-4)
        g_t = np.where(hit, np.random.default_rng(6).normal(size=len(o)), 0.0).astype(np.float32)
        got = torch.autograd.grad(t, leaves, torch.as_tensor(g_t))
        for a, w in zip(got, vjp(jnp.asarray(g_t))):
            assert _norm_err(a.numpy(), w) < 1e-4


@pytest.mark.parametrize("case", ["cornell8", "big200"])
def test_fused_route_gradient_matches_plain(case):
    """The dual-query route (`loss_and_grad(light_idx=None)`'s CUDA route,
    here on its plain versions: `trace_physical(fused=True)` under
    autograd) against the plain loop's gradient, with the primary rays'."""
    jscene, jcam = jax_nee_scene(case)
    scene, cam = torch_scene(jscene), torch_camera(jcam)
    rng = gen_seeds((16, 32), 8, "cpu")
    wts = torch.as_tensor(np.random.default_rng(8).normal(size=(16, 32, 3)).astype(np.float32))
    grads = []
    for fused in (True, False):
        leaves = [p.detach().requires_grad_() for p in G.scene_to_params(scene)]
        rays = primary_rays(cam, 32, 16)
        o, d = rays.origin.requires_grad_(), rays.direction.requires_grad_()
        s = G.params_to_scene(G.SceneParams(*leaves), scene)
        rad, r = tnee.trace_physical(s, Rays(origin=o, direction=d), rng, B, fused=fused)
        rad2, _ = tnee.trace_physical(s, Rays(origin=o, direction=d), r, B, fused=fused)
        grads.append(torch.autograd.grad(((rad + rad2) * wts).sum(), [*leaves, o, d],
                                         allow_unused=True))
    nonzero = 0
    for a, b in zip(*grads):
        if b is None or not b.numel():
            continue
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-6)
        nonzero += int(b.abs().max() > 0)
    assert nonzero >= 8


def test_launchers_refuse_cpu_tensors():
    """The kernels' launchers take CUDA tensors only; nothing is counted."""
    g = _golden("cornell8")
    scene, rays, rng, wts = _inputs(g)
    tables = NE.nee_scene_tables(scene)
    table = SF.sphere_table(scene.spheres.pos, scene.spheres.radius)
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    n = o.shape[0]
    NV.LAUNCHES = 0
    SF.LAUNCHES.update(nearest_fold=0, dual_fold=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        NV.launch_nee_backward(tables, rays, rng, wts, B, SPP)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SF.launch_nearest_fold(table, o, d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SF.launch_dual_fold(table, o, d, d, torch.ones(n), torch.zeros(n, dtype=torch.int32),
                            torch.ones(n, dtype=torch.int32))
    assert NV.LAUNCHES == 0 and SF.LAUNCHES == {"nearest_fold": 0, "dual_fold": 0}


@pytest.mark.parametrize("case", NEE_GRAD_GOLDEN_CASES)
def test_function_gradient_matches_golden(case):
    """The kernel route's CPU version (`trace_physical_nee_diff` on CPU
    tensors, the plain trace under autograd, through `params_to_scene`)
    against the golden gradients of the XLA estimator: the check phase 17
    of chip_smoke.py makes on the card."""
    g = _golden(case)
    template, rays, rng, wts = _inputs(g)
    leaves = [p.detach().requires_grad_() for p in G.scene_to_params(template)]
    o, d = rays.origin.requires_grad_(), rays.direction.requires_grad_()
    scene = G.params_to_scene(G.SceneParams(*leaves), template)
    rad, _ = NV.trace_physical_nee_diff(scene, Rays(origin=o, direction=d), rng, B, SPP,
                                        light_idx=tuple(g["light_idx"].tolist()))
    grads = torch.autograd.grad((rad / SPP * wts).sum(), [*leaves, o, d], allow_unused=True)
    got = {f: torch.zeros_like(x) if gr is None else gr for f, gr, x in zip(FIELDS, grads, leaves)}
    _assert_fields(got, {f: g[f"d_{f}"] for f in FIELDS}, TOL, 8)
    assert _norm_err(grads[-2].numpy(), g["d_origin"]) < TOL
    assert _norm_err(grads[-1].numpy(), g["d_direction"]) < TOL


def test_emission_finite_difference():
    """A central difference on the brightest emitter's illuminance, through
    the kernel route's CPU version: the objective is linear in it."""
    g = _golden("tri")
    template, rays, rng, wts = _inputs(g)
    light_idx = tuple(g["light_idx"].tolist())
    params = G.scene_to_params(template)

    def loss(p):
        rad, _ = NV.trace_physical_nee_diff(G.params_to_scene(p, template), rays, rng, B, SPP,
                                            light_idx=light_idx)
        return (rad * wts).sum()

    light = int(torch.argmax(params.sphere_illum))
    illum = params.sphere_illum.detach().requires_grad_()
    ad = torch.autograd.grad(loss(params._replace(sphere_illum=illum)), illum)[0][light].item()
    step = torch.zeros_like(illum)
    step[light] = 0.5
    with torch.no_grad():
        fd = (loss(params._replace(sphere_illum=illum + step))
              - loss(params._replace(sphere_illum=illum - step))).item() / (2 * 0.5)
    assert ad != 0.0
    np.testing.assert_allclose(ad, fd, rtol=2e-2)


def test_box_scene_routes():
    """A box scene: backend="cuda" refuses it, naming backend='torch';
    backend="auto" on the CPU runs the plain route."""
    scene = S.box_tri_scene("cpu")
    cam = world.initial_camera("cpu")
    rng = gen_seeds((8, 16), 2, "cpu")
    li = NE.scene_light_indices(scene)
    with pytest.raises(ValueError, match="backend='torch'"):
        G.render_radiance(scene, cam, rng, 16, 8, 2, 1, backend="cuda", estimator="physical",
                          light_idx=li)
    auto = G.render_radiance(scene, cam, rng, 16, 8, 2, 1, backend="auto", estimator="physical",
                             light_idx=li)
    plain = G.render_radiance(scene, cam, rng, 16, 8, 2, 1, backend="torch", estimator="physical")
    assert torch.equal(auto, plain) and auto.abs().max() > 0


def test_cpu_routes_never_launch():
    """Every CPU route runs plain versions: no kernel launch is counted, and
    backend="cuda" refuses CPU tensors."""
    g = _golden("cornell8")
    scene, rays, rng, wts = _inputs(g)
    cam = world.initial_camera("cpu")
    li = tuple(g["light_idx"].tolist())
    MK.LAUNCHES = NV.LAUNCHES = 0
    SF.LAUNCHES.update(nearest_fold=0, dual_fold=0)
    NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
    tnee.trace_physical(scene, rays, rng, B, fused=True)
    o = rays.origin.detach().requires_grad_()
    rad, _ = NV.trace_physical_nee_diff(scene, Rays(origin=o, direction=rays.direction), rng, B,
                                        SPP, li)
    assert torch.autograd.grad((rad * wts).sum(), o)[0].abs().max() > 0
    for li_ in (li, None):
        G.loss_and_grad(G.scene_to_params(scene), scene, cam, torch.zeros(16, 32, 3), rng,
                        num_bounces=B, spp=1, estimator="physical", light_idx=li_)
    with pytest.raises(ValueError, match="CUDA tensors"):
        G.render_radiance(scene, cam, rng, 32, 16, B, 1, backend="cuda", estimator="physical",
                          light_idx=li)
    assert MK.LAUNCHES == NV.LAUNCHES == 0
    assert SF.LAUNCHES == {"nearest_fold": 0, "dual_fold": 0}
    assert NE.LAUNCHES == {"nee_megakernel": 0, "primary_probe": 0}


def test_nee_grad_golden_file_is_current(jax_grads):
    """Recomputed from the JAX package's XLA estimator, the NEE gradient
    golden file is unchanged."""
    want = nee_grad_golden_arrays({c: jax_grads(c) for c in NEE_GRAD_GOLDEN_CASES})
    with np.load(NEE_GRAD_GOLDEN_PATH) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
