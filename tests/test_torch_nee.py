"""The physical/NEE estimator of the PyTorch port against the JAX package:
sampling, occlusion, the chunked fold and the whole estimator, at small
sizes on the CPU.

Tolerances.  Functions without a transcendental (the triangle-area sample,
the shadow tests, the fold) are bit-equal: both sides round the same f32
operations in the same order, and the port's CPU square root is the
correctly rounded one (`core/linalg.py:sqrt`).  Functions that take a
sin/cos of the same angle (the cosine hemisphere, the cone) differ where
PyTorch's and XLA's sin/cos differ in the last bit: directions within 4 ulp
of 1 (4.8e-7) absolute.  The estimator is held to `assert_lane_parity`
(tests/test_pallas_nee.py: at most 0.5% of lanes with a differing rng,
radiance within 1e-4 + 1e-3 |ref| on the rest), with bit-equal rng on the
scenes where that file asserts it.
"""

import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.models.camera import primary_rays as jrays
from haskell_path_tracer_tpu.models.objects import Camera as JaxCamera, Scene as JaxScene
from haskell_path_tracer_tpu.ops import intersect as jint
from haskell_path_tracer_tpu.ops.pallas_nee import trace_physical_nee_pallas
from haskell_path_tracer_tpu.parity import oracle_nee_np
from haskell_path_tracer_tpu.render import nee as jnee

from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy
from haskell_path_tracer_torch.ops import intersect as tint
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops.intersect import Hit
from haskell_path_tracer_torch.render import nee as tnee

from test_pallas_nee import assert_lane_parity, big, box_tri_scene, tri_scene
from torch_port_fixtures import jax_nee_scene, torch_camera, torch_rays, torch_scene

torch.set_num_threads(2)
H, W = 16, 64
DIR_ATOL = 4 * 2.0**-23
SCENES = ("cornell8", "glassy", "big200", "zero_light", "tri", "box_tri")
# tests/test_pallas_nee.py asserts bit-equal rng on these.
RNG_EXACT = ("cornell8", "glassy", "zero_light")


def _jax_rays(rays):
    return torch_rays({"origin": np.asarray(rays.origin), "direction": np.asarray(rays.direction)})


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _uniforms(n, k, seed):
    """k columns of f32 uniforms in [0, 1) on the 2^-24 grid of SFC32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 24, size=(k, n)) * 2.0**-24).astype(np.float32)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _shade_points(name, n=2048, seed=0):
    """n points: hit points of the scene's camera rays (up to half), the
    rest random around it.  One n for every test keeps the JAX package's
    eager per-op compilations cached between them."""
    jscene, jcam = jax_nee_scene(name)
    rays = primary_rays(torch_camera(jcam), W, H)
    hit = tint.nearest_hit(rays.origin, rays.direction, torch_scene(jscene))
    pts = hit.point[hit.hit].numpy()[: n // 2]
    rnd = np.random.default_rng(seed).uniform([-4, -3, -9], [4, 6, -2], (n - len(pts), 3))
    return jscene, np.concatenate([pts, rnd]).astype(np.float32)


def test_cosine_hemisphere_matches_jax():
    n = _unit(2048, 1)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    u1, u2 = _uniforms(2048, 2, 2)
    want = np.asarray(jnee.sample_cosine_hemisphere(n, u1, u2))
    got = tnee.sample_cosine_hemisphere(_t(n), _t(u1), _t(u2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DIR_ATOL)


@pytest.mark.parametrize("dist", ["near", "far", "on_sphere"])
def test_cone_sample_matches_jax(dist):
    n = 2048
    rng = np.random.default_rng(3)
    center = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    radius = rng.uniform(0.2, 2.0, n).astype(np.float32)
    away = _unit(n, 4) * {"near": 3.0, "far": 3000.0, "on_sphere": 1.0}[dist]
    point = (center + away * radius[:, None]).astype(np.float32)
    u1, u2 = _uniforms(n, 2, 5)
    want = [np.asarray(x) for x in jnee._cone_sample(center, radius, point, u1, u2)]
    got = tnee._cone_sample(_t(center), _t(radius), _t(point), _t(u1), _t(u2))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=DIR_ATOL)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    if dist == "on_sphere":
        assert (want[1] == np.float32(2 * np.pi)).mean() > 0.1  # omc = 1 lanes


def test_tri_area_sample_matches_jax():
    jscene = jax_nee_scene("tri")[0]
    _, pts = _shade_points("tri")
    n = len(pts)
    t_idx = np.random.default_rng(6).integers(0, 2, n).astype(np.int32)
    u1, u2 = _uniforms(n, 2, 7)
    want = jnee._tri_area_sample(jscene.triangles, t_idx, pts, u1, u2)
    got = tnee._tri_area_sample(
        torch_scene(jscene).triangles, _t(t_idx, torch.int64), _t(pts), _t(u1), _t(u2)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[1]) > 0).mean() > 0.3


def _light_scene(name):
    if name == "tri_only":  # tri_scene with its sphere emitter turned off
        s = tri_scene()
        m = s.spheres.material
        mat = J.make_materials(
            [(np.asarray(m.color[i]), 0.0, int(m.brdf_kind[i]), float(m.brdf_param[i]))
             for i in range(m.count)]
        )
        return JaxScene(
            spheres=J.make_spheres(s.spheres.pos, s.spheres.radius, mat),
            planes=s.planes, triangles=s.triangles,
        )
    return jax_nee_scene(name)[0]


@pytest.mark.parametrize("name", ["cornell8", "tri_only", "box_tri", "zero_light"])
def test_sample_light_matches_jax(name):
    """Sphere lights, triangle lights, both (with boxes), and none."""
    jscene = _light_scene(name)
    pts = _shade_points("tri" if name == "tri_only" else name)[1]
    us = _uniforms(len(pts), 3, 8)
    want = [np.asarray(x) for x in jnee.sample_light(jscene, pts, *us)]
    got = [x.numpy() for x in tnee.sample_light(torch_scene(jscene), _t(pts), *map(_t, us))]
    d, inv_pdf, prim, t_l, emit = got
    np.testing.assert_allclose(d, want[0], rtol=0, atol=DIR_ATOL)
    np.testing.assert_array_equal(prim, want[2])
    np.testing.assert_array_equal(emit, want[4])
    np.testing.assert_allclose(inv_pdf, want[1], rtol=1e-6, atol=0)
    # t_l follows the direction: equal where it is; elsewhere a ray that
    # grazes the light amplifies the direction's last bit through
    # d^2 = |l|^2 - tca^2.
    np.testing.assert_allclose(t_l, want[3], rtol=1e-4, atol=0)
    same = (d == want[0]).all(-1)
    np.testing.assert_array_equal(t_l[same], want[3][same])
    if name == "zero_light":
        assert not inv_pdf.any()
    else:
        assert (inv_pdf > 0).mean() > 0.3
    if name == "cornell8":  # sphere lights only: the cone sampler alone agrees too
        cone = [x.numpy() for x in tnee.sample_light_cone(torch_scene(jscene), _t(pts), *map(_t, us))]
        want = [np.asarray(x) for x in jnee.sample_light_cone(jscene, pts, *us)]
        np.testing.assert_allclose(cone[0], want[0], rtol=0, atol=DIR_ATOL)
        np.testing.assert_array_equal(cone[1], want[1])
        np.testing.assert_array_equal(cone[2], want[2])


def test_sample_physical_matches_jax():
    """Matte, glossy and dielectric hits, from one rng."""
    n = 2048
    rng = np.random.default_rng(9)
    normal = _unit(n, 10)
    ray_d = _unit(n, 11)
    fields = dict(
        t=rng.uniform(0.1, 5, n).astype(np.float32),
        hit=np.ones(n, bool),
        prim=np.zeros(n, np.int32),
        point=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
        normal=normal,
        color=rng.uniform(0.1, 1, (n, 3)).astype(np.float32),
        illuminance=np.zeros(n, np.float32),
        brdf_kind=np.arange(n, dtype=np.int32) % 3,
        brdf_param=rng.uniform(1.1, 1.8, n).astype(np.float32),
    )
    seeds = J.make_accumulator(n, 1, seed=12).rng[0]
    want = [np.asarray(x) for x in jnee.sample_physical(jint.Hit(**fields), ray_d, seeds)]
    thit = Hit(**{k: torch.as_tensor(v) for k, v in fields.items()})
    got = tnee.sample_physical(thit, _t(ray_d), rng_from_numpy(np.asarray(seeds), "cpu"))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=DIR_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(rng_to_numpy(got[4]), want[4])
    np.testing.assert_array_equal(want[3], fields["brdf_kind"] > 0)


@pytest.mark.parametrize("name", ["box_tri", "big200"])
def test_shadow_tests_match_jax(name):
    jscene, pts = _shade_points(name)
    n = len(pts)
    rng = np.random.default_rng(13)
    l_dir = _unit(n, 14)
    t_l = rng.uniform(0.5, 30, n).astype(np.float32)
    t_l[::7] = np.finfo(np.float32).max
    exclude = rng.integers(0, jscene.num_primitives, n).astype(np.int32)
    ts = torch_scene(jscene)
    args = (_t(pts), _t(l_dir), _t(t_l), _t(exclude, torch.int64))
    want_s = np.asarray(jint.sphere_occluded_any(pts, l_dir, t_l, exclude, jscene.spheres))
    want = np.asarray(jint.shadow_occluded(pts, l_dir, t_l, exclude, jscene))
    np.testing.assert_array_equal(tint.sphere_occluded_any(*args, ts.spheres).numpy(), want_s)
    np.testing.assert_array_equal(tint.shadow_occluded(*args, ts).numpy(), want)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.parametrize("reject_below", [0.0, float(jint.EPSILON)])
def test_chunked_fold_matches_jax(reject_below):
    """200 spheres with planes, boxes and triangles: above the 128-primitive
    threshold the port folds the spheres in chunks and merges the other
    kinds in index order.  The winners equal the JAX package's chunked fold
    (its XLA scan on the CPU), and t equals the JAX package's fold run op
    by op bit for bit; the compiled scan contracts a*b + c into FMAs, so
    against it t agrees to 1e-4 relative (grazing rays amplify the last
    bit through d^2 = |l|^2 - tca^2)."""
    b, bt = big(200), box_tri_scene()
    jscene = JaxScene(spheres=b.spheres, planes=b.planes, boxes=bt.boxes, triangles=bt.triangles)
    assert jscene.num_primitives > jint.CHUNKED_THRESHOLD
    rays = jrays(JaxCamera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0), W, H)
    o = np.concatenate([np.asarray(rays.origin).reshape(-1, 3),
                        np.random.default_rng(15).uniform(-10, 10, (1024, 3))]).astype(np.float32)
    o[-1024:, 2] -= 20.0
    d = np.concatenate([np.asarray(rays.direction).reshape(-1, 3), _unit(1024, 16)])
    jt, jp = (np.asarray(x) for x in jint.nearest_t_prim(o, d, jscene, reject_below))
    et, ep = (np.asarray(x) for x in jint._nearest_t_prim_small(o, d, jscene, reject_below))
    ts = torch_scene(jscene)
    t, p = tint.nearest_t_prim(_t(o), _t(d), ts, reject_below)
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(p.numpy(), ep)
    np.testing.assert_array_equal(t.numpy(), et)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-4, atol=0)
    kinds = np.searchsorted(np.cumsum([200, 1, 2, 1]), jp[jt < jint.INFINITE], side="right")
    assert set(kinds.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("nee", [True, False], ids=["nee", "bsdf"])
@pytest.mark.parametrize("name", SCENES)
def test_trace_physical_matches_jax(name, nee):
    jscene, jcam = jax_nee_scene(name)
    rays = jrays(jcam, W, H)
    rng = np.asarray(J.make_accumulator(W, H, seed=3).rng)
    rad_ref, rng_ref = (np.asarray(x) for x in jnee.trace_physical(
        jscene, rays, rng, num_bounces=3, nee=nee, fused=False))
    rad, rng_out = tnee.trace_physical(
        torch_scene(jscene), _jax_rays(rays),
        rng_from_numpy(rng, "cpu"), 3, nee=nee,
    )
    assert rad.shape == (H, W, 3) and np.isfinite(rad.numpy()).all()
    assert np.abs(rad_ref).max() > 0
    if name in RNG_EXACT:
        np.testing.assert_array_equal(rng_to_numpy(rng_out), rng_ref)
    assert_lane_parity(rng_ref, rng_to_numpy(rng_out), rad_ref, rad.numpy())


def test_fused_trace_raises_naming_the_roadmap():
    jscene, jcam = jax_nee_scene("cornell8")
    with pytest.raises(NotImplementedError, match="Queue B #6"):
        tnee.trace_physical(torch_scene(jscene), torch_rays(
            {"origin": np.zeros((1, 1, 3), np.float32), "direction": np.ones((1, 1, 3), np.float32)}),
            torch.zeros((1, 1, 4), dtype=torch.int32), fused=True)


def test_matches_pallas_kernel_in_interpret_mode():
    """The plain version of the NEE kernel against the JAX package's Pallas
    NEE kernel itself, interpret mode, cornell8 at 64x8, 2 bounces, 2 spp."""
    jscene, jcam = jax_nee_scene("cornell8")
    h = 8
    rays = jrays(jcam, W, h)
    rng = np.asarray(J.make_accumulator(W, h, seed=17).rng)
    rad_ref, rng_ref = (np.asarray(x) for x in trace_physical_nee_pallas(
        jscene, rays, rng, num_bounces=2, spp=2, interpret=True))
    rad, rng_out = NE.trace_physical_nee(
        torch_scene(jscene), _jax_rays(rays),
        rng_from_numpy(rng, "cpu"), num_bounces=2, spp=2)
    np.testing.assert_array_equal(rng_to_numpy(rng_out), rng_ref)
    assert_lane_parity(rng_ref, rng_to_numpy(rng_out), rad_ref, rad.numpy())


def test_matches_numpy_oracle():
    """A third witness: the numpy oracle of the estimator, on the scene with
    sphere and triangle emitters and a shadow-casting triangle."""
    jscene, jcam = jax_nee_scene("tri")
    rays = primary_rays(torch_camera(jcam), W, H)
    rng = np.asarray(J.make_accumulator(W, H, seed=18).rng)
    rad_n, rng_n = oracle_nee_np.trace_physical_np(
        jscene, rays.origin.numpy(), rays.direction.numpy(), rng.copy(), num_bounces=3)
    rad, rng_out = tnee.trace_physical(torch_scene(jscene), rays, rng_from_numpy(rng, "cpu"), 3)
    assert np.abs(rad_n).max() > 0
    assert_lane_parity(rng_n, rng_to_numpy(rng_out), rad_n, rad.numpy())
