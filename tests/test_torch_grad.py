"""The PyTorch port's gradient path against the JAX package.

Inputs are tests/test_pallas_vjp.py's fixtures (8x16, a camera pitched at
the floor, the all-emissive scene and its mixed-kinds extension), carried
across as numpy arrays, with the radiance cotangent `wts` from a numpy
seed; the JAX side is computed once per module.

  * the port's plain gradients (`trace_inline_fused_diff` on CPU tensors,
    autograd through `trace_tables_reference`) of every leaf class against
    `jax.grad` of `trace_inline_pallas_diff(interpret=True)`;
  * `trace_inline(differentiable=True)` against its JAX twin;
  * an emission gradient against central finite differences;
  * `loss_and_grad` against the JAX `loss_and_grad(backend="xla")` on
    every one of the 21 SceneParams fields;
  * `backward_reference` against the JAX golden gradients that
    `chip_smoke.py` also holds the CUDA kernel against.

Tolerance (tests/test_pallas_vjp.py): the scale-normalised error
max|a - b| / (max|b| + 1e-6) below 1e-2, and below 2e-2 for the box and
triangle leaves.  Decisions are detached on both sides, so the two agree
to float rounding except where a last-bit difference in a transcendental
flips a decision, or a grazing lane amplifies it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.diff import grad as JG
from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays
from haskell_path_tracer_tpu.models.objects import Camera as JaxCamera
from haskell_path_tracer_tpu.models.objects import Rays as JaxRays
from haskell_path_tracer_tpu.ops import rng as jax_rng
from haskell_path_tracer_tpu.ops.pallas_megakernel_vjp import trace_inline_pallas_diff
from haskell_path_tracer_tpu.render.integrator import trace_inline as jax_trace_inline

from haskell_path_tracer_torch.diff import grad as G
from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models.objects import Rays
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import megakernel_vjp as V
from haskell_path_tracer_torch.render.integrator import trace_inline

from test_pallas_vjp import B, H, PITCH, W, _mixed_scene, _small_scene
from torch_port_fixtures import GOLDEN_PATH, GRAD_CASES, GRAD_OUTPUTS, has_dielectric

torch.set_num_threads(2)

# Scene leaves by their path in the Scene, as SceneParams names them.
PATHS = {
    "sphere_pos": ("spheres", "pos"),
    "sphere_radius": ("spheres", "radius"),
    "sphere_color": ("spheres", "material", "color"),
    "sphere_illum": ("spheres", "material", "illuminance"),
    "plane_pos": ("planes", "pos"),
    "box_lo": ("boxes", "lo"),
    "box_hi": ("boxes", "hi"),
    "tri_v0": ("triangles", "v0"),
    "tri_v1": ("triangles", "v1"),
    "tri_v2": ("triangles", "v2"),
    "tri_illum": ("triangles", "material", "illuminance"),
}
LEAVES = ("sphere_pos", "sphere_radius", "sphere_color", "sphere_illum",
          "plane_pos", "ray_origin", "ray_direction")
MIXED_LEAVES = ("box_lo", "box_hi", "tri_v0", "tri_v1", "tri_v2", "tri_illum")
# The mixed scene runs 2 bounces where tests/test_pallas_vjp.py runs 4: the
# JAX package's interpret-mode backward compiles in time that doubles with
# each bounce (about 30 s at 2 bounces, 120 s at 4 for this scene).
MIXED_B = 2
SPP = 2  # samples of the loss_and_grad comparison


def _norm_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _bound(name):
    return 2e-2 if name.startswith(("box", "tri")) else 1e-2


def _replace(obj, path, value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    return dataclasses.replace(
        obj, **{path[0]: _replace(getattr(obj, path[0]), path[1:], value)}
    )


def _get(obj, path):
    for p in path:
        obj = getattr(obj, p)
    return obj


def _leaves(scene, rays, names):
    return tuple(
        {"ray_origin": rays.origin, "ray_direction": rays.direction}[n]
        if n.startswith("ray") else _get(scene, PATHS[n])
        for n in names
    )


def _with_leaves(scene, rays, names, values, rays_cls):
    origin, direction = rays.origin, rays.direction
    for n, v in zip(names, values):
        if n == "ray_origin":
            origin = v
        elif n == "ray_direction":
            direction = v
        else:
            scene = _replace(scene, PATHS[n], v)
    return scene, rays_cls(origin=origin, direction=direction)


def _jax_inputs(jscene):
    camera = JaxCamera.create([0.0, 0.0, 0.0], [PITCH, 0.0, 0.0], 90.0)
    rays = jax_primary_rays(camera, W, H)
    rng = jax_rng.gen_seeds((H, W), seed=0)
    wts = np.random.default_rng(1).normal(size=(H, W, 3)).astype(np.float32)
    return camera, rays, rng, wts


def _jax_grads(jscene, names, bounces, trace):
    _, rays, rng, wts = _jax_inputs(jscene)

    def loss(args):
        sc, rs = _with_leaves(jscene, rays, names, args, JaxRays)
        return jnp.sum(trace(sc, rs, rng, bounces) * wts)

    grads = jax.grad(loss)(_leaves(jscene, rays, names))
    return {n: np.asarray(g) for n, g in zip(names, grads)}


def _pallas(sc, rs, rng, bounces):
    return trace_inline_pallas_diff(sc, rs, rng, num_bounces=bounces, spp=1, interpret=True)[0]


def _xla(sc, rs, rng, bounces):
    return jax_trace_inline(sc, rs, rng, bounces, differentiable=True)[0]


def _torch_inputs(jscene):
    camera, rays, rng, wts = _jax_inputs(jscene)
    return (
        C.scene_from_numpy(C.scene_to_numpy(jscene), "cpu"),
        C.camera_from_numpy(C.camera_to_numpy(camera), "cpu"),
        Rays(origin=torch.tensor(np.asarray(rays.origin)),
             direction=torch.tensor(np.asarray(rays.direction))),
        C.rng_from_numpy(np.asarray(rng), "cpu"),
        torch.tensor(wts),
    )


def _torch_grads(jscene, names, bounces, trace):
    scene, _, rays, rng, wts = _torch_inputs(jscene)
    leaves = [t.clone().requires_grad_() for t in _leaves(scene, rays, names)]
    sc, rs = _with_leaves(scene, rays, names, leaves, Rays)
    radiance = trace(sc, rs, rng, bounces)
    grads = torch.autograd.grad((radiance * wts).sum(), leaves)
    return {n: g.numpy() for n, g in zip(names, grads)}


def _fused_diff(sc, rs, rng, bounces):
    return V.trace_inline_fused_diff(sc, rs, rng, num_bounces=bounces, spp=1)[0]


def _plain_inline(sc, rs, rng, bounces):
    return trace_inline(sc, rs, rng, bounces, differentiable=True)[0]


def _target(h, w):
    return np.random.default_rng(5).uniform(0.0, 2.0, size=(h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX-side gradient of this module, computed once."""
    small, mixed = _small_scene(), _mixed_scene()
    camera, _, rng, _ = _jax_inputs(mixed)
    params = JG.scene_to_params(mixed)
    loss, grads = JG.loss_and_grad(
        params, mixed, camera, jnp.asarray(_target(H, W)), rng,
        num_bounces=B, spp=SPP, backend="xla",
    )
    return {
        "pallas": {**_jax_grads(small, LEAVES, B, _pallas),
                   **_jax_grads(mixed, MIXED_LEAVES, MIXED_B, _pallas)},
        "xla": _jax_grads(small, LEAVES, B, _xla),
        "params": C.params_to_numpy(params),
        "loss": float(loss),
        "param_grads": C.params_to_numpy(grads),
    }


@pytest.fixture(scope="module")
def plain_side():
    """The port's plain gradients, as the JAX side's."""
    small, mixed = _small_scene(), _mixed_scene()
    return {
        "fused": {**_torch_grads(small, LEAVES, B, _fused_diff),
                  **_torch_grads(mixed, MIXED_LEAVES, MIXED_B, _fused_diff)},
        "inline": _torch_grads(small, LEAVES, B, _plain_inline),
    }


@pytest.fixture(scope="module")
def port_loss_and_grad(jax_side):
    mixed = _mixed_scene()
    scene, camera, _, rng, _ = _torch_inputs(mixed)
    params = C.params_from_numpy(jax_side["params"], "cpu")
    return G.loss_and_grad(
        params, scene, camera, torch.tensor(_target(H, W)), rng,
        num_bounces=B, spp=SPP,
    )


@pytest.mark.parametrize("name", LEAVES + MIXED_LEAVES)
def test_plain_grads_match_jax_pallas(jax_side, plain_side, name):
    got, want = plain_side["fused"][name], jax_side["pallas"][name]
    if not name.startswith("box"):
        # Box face normals are sign(), so box corners get only the
        # distance's gradient, often none at this size (as in
        # tests/test_pallas_vjp.py).
        assert np.abs(want).max() > 0, name
    assert _norm_err(got, want) < _bound(name), (name, _norm_err(got, want))


@pytest.mark.parametrize("name", LEAVES)
def test_trace_inline_grads_match_jax_twin(jax_side, plain_side, name):
    got, want = plain_side["inline"][name], jax_side["xla"][name]
    assert np.abs(want).max() > 0, name
    assert _norm_err(got, want) < _bound(name), (name, _norm_err(got, want))


def test_emission_grad_matches_finite_differences():
    scene, _, rays, rng, _ = _torch_inputs(_small_scene())
    illum0 = scene.spheres.material.illuminance

    def loss(illum):
        sc = _replace(scene, PATHS["sphere_illum"], illum)
        return V.trace_inline_fused_diff(sc, rays, rng, num_bounces=B)[0].mean()

    leaf = illum0.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(leaf), [leaf])
    # Radiance is linear in each emission scalar along detached paths, so
    # central differences at any step are exact up to float rounding.
    eps = 0.5
    i = int(g.abs().argmax())
    e = torch.zeros_like(illum0)
    e[i] = eps
    with torch.no_grad():
        fd = (loss(illum0 + e) - loss(illum0 - e)) / (2 * eps)
    assert abs(float(g[i])) > 0
    np.testing.assert_allclose(float(fd), float(g[i]), rtol=2e-3)


def test_loss_matches_jax(jax_side, port_loss_and_grad):
    loss, _ = port_loss_and_grad
    np.testing.assert_allclose(float(loss), jax_side["loss"], rtol=1e-5)


@pytest.mark.parametrize("field", G.SceneParams._fields)
def test_loss_and_grad_matches_jax(jax_side, port_loss_and_grad, field):
    got = getattr(port_loss_and_grad[1], field).numpy()
    want = jax_side["param_grads"][field]
    assert got.shape == want.shape
    if field in ("sphere_illum", "sphere_color", "tri_illum"):
        assert np.abs(want).max() > 0, field
    assert _norm_err(got, want) < _bound(field), (field, _norm_err(got, want))


def test_all_gradients_are_finite(plain_side, port_loss_and_grad):
    for grads in (plain_side["fused"], plain_side["inline"]):
        for name, g in grads.items():
            assert np.isfinite(g).all(), name
    for field, g in port_loss_and_grad[1]._asdict().items():
        assert torch.isfinite(g).all(), field


def test_loss_and_grad_backends_agree_on_cpu(port_loss_and_grad):
    """`auto` on CPU tensors is the checkpointed plain integrator;
    `torch` names it."""
    scene, camera, _, rng, _ = _torch_inputs(_mixed_scene())
    loss, grads = G.loss_and_grad(
        G.scene_to_params(scene), scene, camera, torch.tensor(_target(H, W)), rng,
        num_bounces=B, spp=SPP, backend="torch",
    )
    assert torch.equal(loss, port_loss_and_grad[0])
    for a, b in zip(grads, port_loss_and_grad[1]):
        assert torch.equal(a, b)


def test_params_to_scene_renormalises_the_plane_normal():
    scene, *_ = _torch_inputs(_mixed_scene())
    params = G.scene_to_params(scene)._replace(
        plane_normal=torch.tensor([[0.0, 3.0, 4.0]])
    )
    rebuilt = G.params_to_scene(params, scene)
    torch.testing.assert_close(rebuilt.planes.normal, torch.tensor([[0.0, 0.6, 0.8]]))
    assert torch.equal(rebuilt.triangles.material.brdf_kind, scene.triangles.material.brdf_kind)


def test_params_round_trip_through_numpy():
    jparams = JG.scene_to_params(_mixed_scene())
    arrays = C.params_to_numpy(jparams)
    assert list(arrays) == list(G.SceneParams._fields) == list(JG.SceneParams._fields)
    params = C.params_from_numpy(jparams, "cpu")
    back = C.params_to_numpy(params)
    for f in G.SceneParams._fields:
        np.testing.assert_array_equal(back[f], arrays[f])
        assert getattr(params, f).dtype == torch.float32
    jback = JG.SceneParams(**back)
    np.testing.assert_array_equal(np.asarray(jback.tri_v2), np.asarray(jparams.tri_v2))


def test_cuda_backend_on_cpu_raises():
    scene, camera, _, rng, _ = _torch_inputs(_small_scene())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        G.render_radiance(scene, camera, rng, W, H, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        G.render_radiance(scene, camera, rng, W, H, backend="pallas")


def test_fused_diff_on_cpu_is_the_plain_trace_and_never_launches():
    scene, _, rays, rng, _ = _torch_inputs(_mixed_scene())
    MK.LAUNCHES = V.LAUNCHES = 0
    got = V.trace_inline_fused_diff(scene, rays, rng, num_bounces=B, spp=2)
    want = MK.trace_inline_fused_reference(scene, rays, rng, B, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert MK.LAUNCHES == V.LAUNCHES == 0


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    scene, _, rays, rng, wts = _torch_inputs(_small_scene())
    geom, mat = MK.scene_tables(scene)
    counts = MK.primitive_counts(scene)
    with pytest.raises(ValueError, match="g_rad"):
        V.launch_backward(geom, mat, counts, rays, rng, wts[:, :2].contiguous(), 4, 1, False)
    with pytest.raises(ValueError, match="Russian roulette"):
        V.TraceInlineFusedDiff.apply(geom, mat, rays.origin, rays.direction, rng,
                                     counts, 4, 1, False, True)
    assert V.LAUNCHES == 0


def _golden_case(case):
    with np.load(GOLDEN_PATH) as z:
        prefix = f"grad_{case}__"
        inp = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    scene_arrays = {k.split("__", 1)[1]: v for k, v in inp.items() if k.startswith("scene__")}
    return scene_arrays, inp


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_backward_reference_matches_golden_gradients(case):
    scene_arrays, inp = _golden_case(case)
    scene = C.scene_from_numpy(scene_arrays, "cpu")
    spp, bounces = inp["config"].tolist()
    rays = Rays(origin=torch.tensor(inp["origin"]), direction=torch.tensor(inp["direction"]))
    got = V.backward_reference(
        *MK.scene_tables(scene), MK.primitive_counts(scene), rays,
        C.rng_from_numpy(inp["rng_in"], "cpu"), torch.tensor(inp["wts"]),
        bounces, spp, has_dielectric(scene_arrays),
    )
    ns, npl = scene.spheres.count, scene.planes.count
    for name, g in zip(GRAD_OUTPUTS, got):
        want = inp[name]
        assert g.shape == want.shape and np.isfinite(g.numpy()).all()
        if name in ("d_geom", "d_mat"):
            assert np.abs(want).max() > 0, name
            # Sphere and plane rows at 1e-2, box and triangle rows at 2e-2.
            assert _norm_err(g[: ns + npl], want[: ns + npl]) < 1e-2, name
            if len(want) > ns + npl:
                assert _norm_err(g[ns + npl:], want[ns + npl:]) < 2e-2, name
        else:
            assert _norm_err(g, want) < 1e-2, name


def test_backward_kernel_source_and_build_flags():
    """The backward kernel builds for sm_90a like the forward one, from
    its own source and the shared bounce header, under its own name."""
    flags = " ".join(MK.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags
    src = open(V.SOURCE).read()
    assert 'extern "C" int hpt_megakernel_vjp_launch' in src
    assert '#include "bounce.cuh"' in src and "pallas_megakernel_vjp.py:_bwd_kernel" in src
    assert "kMaxBounces = 16;" in src and "num_bounces > kMaxBounces" in src
    assert '#include "bounce.cuh"' in open(MK.SOURCE).read()
    assert V.library_path().startswith(MK.BUILD_DIR)
    assert V.library_path() != MK.library_path()
