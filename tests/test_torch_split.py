"""The PyTorch port's deterministic splitting against the JAX package's: the
splitting integrator on the glass scene, the plain version of the
splitting kernel against the Pallas kernel in interpret mode and against
the golden file the card is held to, split-free scenes, a full stack,
the backends' routing and the kernel's build flags.

Tolerances: tests/test_pallas_split.py's contract, >= 99% of lanes with
equal rng words and >= 99% of radiance values isclose at rtol = atol =
1e-4, where the JAX side runs compiled (XLA contracts a*b + c into FMAs in
its loops); rng equal and radiance within 1e-6 against the JAX package's
splitting integrator run eagerly, and between the port's own functions."""

import os

import jax
import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays
from haskell_path_tracer_tpu.ops.pallas_split import trace_split_pallas
from haskell_path_tracer_tpu.render import wavefront as jwf

from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import split as SP
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render import integrator
from haskell_path_tracer_torch.render import wavefront as twf

from test_pallas_split import glass_scene as jax_glass_scene
from torch_port_fixtures import (
    SPLIT_CASES,
    SPLIT_GOLDEN_PATH,
    jax_split_trace,
    lane_agreement,
    split_golden_arrays,
    torch_camera,
    torch_rays,
    torch_scene,
)

torch.set_num_threads(2)
W, H = 128, 8


def _origin_camera(device="cpu"):
    return Camera.create([0.0] * 3, [0.0] * 3, 90.0, device)


def _assert_contract(rng_a, rng_b, color_a, color_b):
    rng_match, close, _ = lane_agreement(rng_a, rng_b, color_a, color_b)
    assert rng_match >= 0.99 and close >= 0.99, (rng_match, close)


def test_card_scene_is_the_suite_glass_scene():
    got = C.scene_to_numpy(S.suite_glass_scene("cpu"))
    for k, v in C.scene_to_numpy(jax_glass_scene()).items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("queue_factor", [1.0, 2.0, 4.0])
def test_integrator_matches_jax(queue_factor):
    jscene = jax_glass_scene()
    jcam = J.Camera.create([0.0] * 3, [0.0] * 3, 90.0)
    jacc = J.make_accumulator(W, H, seed=12)
    jout = jwf.render_sample_wavefront_split(jscene, jcam, jacc, num_bounces=6,
                                             queue_factor=queue_factor)
    acc = integrator.make_accumulator(W, H, 12, "cpu")
    out = twf.render_sample_wavefront_split(torch_scene(jscene), torch_camera(jcam), acc,
                                            num_bounces=6, queue_factor=queue_factor)
    assert out.iterations == 1
    np.testing.assert_array_equal(rng_to_numpy(out.rng), np.asarray(jout.rng))
    np.testing.assert_allclose(out.color.numpy(), np.asarray(jout.color), rtol=1e-4, atol=1e-4)
    if queue_factor == 2.0:
        # Op by op, the JAX function gives the port's numbers.
        with jax.disable_jit():
            eager = jwf.render_sample_wavefront_split(jscene, jcam, jacc, num_bounces=6,
                                                      queue_factor=queue_factor)
        np.testing.assert_array_equal(rng_to_numpy(out.rng), np.asarray(eager.rng))
        np.testing.assert_allclose(out.color.numpy(), np.asarray(eager.color), rtol=1e-6, atol=1e-6)


def test_reference_matches_pallas_kernel_in_interpret_mode():
    jscene = jax_glass_scene()
    rays = jax_primary_rays(J.Camera.create([0.0] * 3, [0.0] * 3, 90.0), W, H)
    rng = J.make_accumulator(W, H, seed=6).rng
    want = trace_split_pallas(jscene, rays, rng, num_bounces=4, spp=2, stack_depth=2, interpret=True)
    got = SP.trace_split_reference(
        torch_scene(jscene), torch_rays({"origin": np.asarray(rays.origin),
                                         "direction": np.asarray(rays.direction)}),
        rng_from_numpy(np.asarray(rng), "cpu"), 4, 2, 2)
    _assert_contract(rng_to_numpy(got[1]), np.asarray(want[1]), got[0].numpy(), np.asarray(want[0]))
    assert np.abs(np.asarray(want[0])).max() > 0


def test_split_golden_file_is_current():
    """Recomputed from the JAX package's Pallas kernel, the split golden
    file is unchanged (`python tests/torch_port_fixtures.py split`)."""
    want = split_golden_arrays({case: jax_split_trace(case) for case in SPLIT_CASES})
    with np.load(SPLIT_GOLDEN_PATH) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_reference_matches_split_golden_file(case):
    with np.load(SPLIT_GOLDEN_PATH) as z:
        g = {k[len(case) + 2:]: z[k] for k in z.files if k.startswith(f"{case}__")}
    scene = C.scene_from_numpy({k[len("scene__"):]: v for k, v in g.items()
                                if k.startswith("scene__")}, "cpu")
    spp, bounces, stack_depth = g["config"].tolist()
    rad, rng = SP.trace_split_fused(scene, torch_rays(g), rng_from_numpy(g["rng_in"], "cpu"),
                                    bounces, spp, stack_depth)
    _assert_contract(rng_to_numpy(rng), g["rng_out"], rad.numpy(), g["radiance"])
    assert np.abs(g["radiance"]).max() > 0


def test_split_free_scene_equals_wavefront_and_inline():
    """Without glass no child is pushed: the splitting kernel's plain
    version is the inline megakernel's (has_dielectric off), and the
    splitting integrator the wavefront, rng and radiance."""
    scene, cam = world.main_scene("cpu"), world.initial_camera("cpu")
    rays, rng = primary_rays(cam, 48, 16), integrator.make_accumulator(48, 16, 7, "cpu").rng
    split = SP.trace_split_reference(scene, rays, rng, 6, 2, 2)
    inline = MK.trace_inline_fused_reference(scene, rays, rng, 6, 2, has_dielectric=False)
    assert torch.equal(split[1], inline[1])
    torch.testing.assert_close(split[0], inline[0], rtol=1e-6, atol=1e-6)
    acc = integrator.make_accumulator(48, 16, 7, "cpu")
    a = twf.render_batch_split_auto(scene, cam, acc, 2, num_bounces=6, queue_factor=1.5)
    b = twf.render_batch_wavefront(scene, cam, acc, 2, num_bounces=6)
    assert torch.equal(a.rng, b.rng) and a.iterations == b.iterations == 2
    torch.testing.assert_close(a.color, b.color, rtol=1e-6, atol=1e-6)


def test_queue_overflow_is_finite_and_only_removes_energy():
    scene, cam = S.suite_glass_scene("cpu"), _origin_camera()
    acc = integrator.make_accumulator(32, 16, 3, "cpu")
    tight = twf.render_sample_wavefront_split(scene, cam, acc, num_bounces=5, queue_factor=1.0)
    roomy = twf.render_sample_wavefront_split(scene, cam, acc, num_bounces=5, queue_factor=4.0)
    assert torch.isfinite(tight.color).all()
    assert tight.color.mean() <= roomy.color.mean() + 1e-6
    rays = primary_rays(cam, 32, 16)
    k_tight = SP.trace_split_fused(scene, rays, acc.rng, 5, 1, 1)
    k_roomy = SP.trace_split_fused(scene, rays, acc.rng, 5, 1, 4)
    assert torch.isfinite(k_tight[0]).all() and k_tight[0].mean() <= k_roomy[0].mean() + 1e-6


def test_stack_depth_clamp():
    # pallas_split.py:311: max(1, min(num_bounces - 1, stack_depth)).
    assert [SP.clamp_stack_depth(b, s) for b, s in [(15, 2), (15, 20), (3, 2), (1, 4), (8, 0)]] == [
        2, 14, 2, 1, 1]
    scene, cam = S.suite_glass_scene("cpu"), _origin_camera()
    rays, rng = primary_rays(cam, 16, 8), integrator.make_accumulator(16, 8, 2, "cpu").rng
    a = SP.trace_split_fused(scene, rays, rng, 3, 1, 9)
    b = SP.trace_split_reference(scene, rays, rng, 3, 1, 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_routes_and_launchers_refuse_cpu_tensors():
    scene, cam = S.suite_glass_scene("cpu"), _origin_camera()
    acc = integrator.make_accumulator(16, 8, 1, "cpu")
    with pytest.raises(ValueError, match="cuda"):
        twf.render_batch_split_auto(scene, cam, acc, 1, num_bounces=3, kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be"):
        twf.render_batch_split_auto(scene, cam, acc, 1, num_bounces=3, kernel="pallas")
    rays = primary_rays(cam, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SP.launch_split(*MK.scene_tables(scene), MK.primitive_counts(scene), rays, acc.rng, 3, 1, 2)
    auto = twf.render_batch_split_auto(scene, cam, acc, 2, num_bounces=3, kernel="auto")
    torch_ = twf.render_batch_split_auto(scene, cam, acc, 2, num_bounces=3, kernel="torch")
    assert torch.equal(auto.color, torch_.color) and auto.iterations == 2
    assert SP.LAUNCHES["split_kernel"] == 0


def test_kernel_source_and_build_flags():
    """The splitting kernel is built as the others: sm_90a, FMA contraction
    off, no fast math; its library hashes split.cu and both headers."""
    flags = " ".join(MK.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags
    src = open(SP.SOURCE).read()
    assert 'extern "C" int hpt_split_launch' in src and '#include "split.cuh"' in src
    assert "pallas_split.py:_split_kernel_body" in src
    assert [os.path.basename(h) for h in SP.HEADERS] == ["split.cuh", "bounce.cuh"]
    assert SP.library_path().startswith(MK.BUILD_DIR)
    header = open(SP.HEADERS[0]).read()
    assert f"kMaxStack = {SP.MAX_STACK};" in header
    # The Fresnel split of the kernel is not the stochastic glass sample.
    bounce = open(SP.HEADERS[1]).read()
    assert "HPT_HD void dielectric_split(" in bounce and "t[i] = t[i] / tn;" in bounce


def test_large_tables_take_the_plain_version_on_the_cpu():
    """The 1000-sphere scene's tables (64 KB at 8 geometry columns) are
    above the 48 KB a block has without opting in.  On CPU tensors the
    forward, the gradient and the splitting trace run their plain versions
    as on any scene."""
    scene = S.big_scene("cpu", 1000)
    cam = Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0, "cpu")
    geom, mat = MK.scene_tables(scene)
    assert 4 * (geom.numel() + mat.numel()) > 48 * 1024
    rays, rng = primary_rays(cam, 16, 4), gen_seeds((4, 16), 3, "cpu")
    fused = MK.trace_inline_fused(scene, rays, rng, 2, 1)
    plain = MK.trace_inline_fused_reference(scene, rays, rng, 2, 1)
    assert all(torch.equal(a, b) for a, b in zip(fused, plain))
    assert (fused[1][..., 3] != rng[..., 3]).any()
    from haskell_path_tracer_torch.ops import megakernel_vjp as V

    geom.requires_grad_()
    rad, _ = MK.trace_tables_reference(geom, mat, MK.primitive_counts(scene), rays, rng, 2, 1,
                                       False, 3, False)
    d_geom = V.backward_reference(geom.detach(), mat, MK.primitive_counts(scene), rays, rng,
                                  torch.ones_like(rad), 2, 1, False)[0]
    (want,) = torch.autograd.grad(rad.sum(), geom)
    torch.testing.assert_close(d_geom, want)
    split = SP.trace_split_fused(scene, rays, rng, 2, 1, 2)
    assert torch.equal(split[1], fused[1]) and torch.equal(split[0], fused[0])
    assert MK.LAUNCHES == 0 and SP.LAUNCHES["split_kernel"] == 0


def test_launchers_take_tables_of_any_size():
    """No launcher refuses a scene for its size: the kernels keep tables in
    shared memory up to the card's opt-in limit (asked of the device and
    raised with cudaFuncSetAttribute) and read larger ones from device
    memory; the backward's cotangent tables fall back to global atomics."""
    import inspect

    from haskell_path_tracer_torch.ops import megakernel_vjp as V

    for fn in (MK.launch_kernel, V._check_inputs, V.launch_backward, SP.launch_split):
        src = inspect.getsource(fn)
        assert "primitives exceed" not in src and "SMEM" not in src, fn.__name__
    bounce = open(MK.HEADERS[0]).read()
    assert "cudaDevAttrMaxSharedMemoryPerBlockOptin" in bounce
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in bounce
    for path in (MK.SOURCE, V.SOURCE, SP.SOURCE):
        src = open(path).read()
        assert "smem_optin_bytes()" in src and "allow_smem(" in src and "stage_tables<" in src, path
    assert "acc_in_smem" in open(V.SOURCE).read()
