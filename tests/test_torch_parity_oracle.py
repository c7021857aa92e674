"""The port's plain inline trace against the numpy oracle of the parity
family (haskell_path_tracer_tpu/parity/oracle_np.py, which imports no JAX)
at matched SFC32 states: the contract of tests/test_parity.py, which holds
the JAX package to the same oracle.  Float32 trig and normalisation differ
by ulps between PyTorch and numpy, and a ray that grazes a silhouette can
diverge discretely, so: >= 99% of pixels allclose at rtol = atol = 1e-3
and of rng states equal (98% on the reference scene at 5 bounces), and the
mean image within 1e-3."""

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.parity import oracle_np
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.objects import (
    BRDF_MATTE,
    Camera,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.render.integrator import make_accumulator, render_sample_inline

torch.set_num_threads(2)


def config1_scene():
    """tests/test_parity.py's BASELINE config #1: one diffuse sphere and a
    ground plane."""
    s = make_spheres([[0.0, 0.0, -6.0]], [2.0],
                     make_materials([([0.8, 0.4, 0.4], 2.0, BRDF_MATTE, 0.8)], "cpu"), "cpu")
    p = make_planes([[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
                    make_materials([([0.43, 0.95, 0.5], 0.1, BRDF_MATTE, 1.5)], "cpu"), "cpu")
    return Scene(spheres=s, planes=p)


def _oracle(scene, cam, rng0, w, h, spp, bounces):
    ncolor, nrng = np.zeros((h, w, 3), np.float32), rng0.copy()
    for _ in range(spp):
        ncolor, nrng = oracle_np.render_sample_np(scene, cam, ncolor, nrng, num_bounces=bounces)
    return ncolor, nrng


def _port(route, scene, cam, w, h, spp, bounces, seed):
    acc = make_accumulator(w, h, seed, "cpu")
    if route == "integrator":
        for _ in range(spp):
            acc = render_sample_inline(scene, cam, acc, num_bounces=bounces)
        return acc.color.numpy(), acc.rng.numpy().view(np.uint32)
    # The forward kernel's plain version, all samples in one call.
    color, rng = MK.trace_inline_fused_reference(scene, primary_rays(cam, w, h), acc.rng,
                                                 bounces, spp)
    return color.numpy(), rng.numpy().view(np.uint32)


def test_primary_rays_match_the_oracle():
    cam = world.initial_camera("cpu")
    rays = primary_rays(cam, 64, 48)
    o, d = oracle_np.primary_rays_np(cam, 64, 48)
    np.testing.assert_allclose(rays.origin.numpy(), o, atol=1e-6)
    np.testing.assert_allclose(rays.direction.numpy(), d, atol=1e-5)


@pytest.mark.parametrize("route", ["integrator", "fused_reference"])
@pytest.mark.parametrize("case", ["config1", "main"])
def test_plain_inline_trace_matches_the_oracle(case, route):
    if case == "config1":
        scene, cam = config1_scene(), Camera.create([0.0] * 3, [0.0] * 3, 90.0, "cpu")
        w, h, spp, bounces, seed, share = 64, 48, 4, 2, 11, 0.99
    else:
        scene, cam = world.main_scene("cpu"), world.initial_camera("cpu")
        w, h, spp, bounces, seed, share = 48, 32, 2, 5, 3, 0.98
    rng0 = make_accumulator(w, h, seed, "cpu").rng.numpy().view(np.uint32).copy()
    ncolor, nrng = _oracle(scene, cam, rng0, w, h, spp, bounces)
    color, rng = _port(route, scene, cam, w, h, spp, bounces, seed)
    frac = np.isclose(color, ncolor, rtol=1e-3, atol=1e-3).all(axis=-1).mean()
    rng_match = (rng == nrng).all(axis=-1).mean()
    assert frac >= share, f"only {frac:.4f} of pixels match"
    assert rng_match >= share, f"only {rng_match:.4f} of rng states match"
    np.testing.assert_allclose(color.mean(), ncolor.mean(), rtol=1e-3)
    # The traces did work: some pixels are lit, and the rng advanced.
    assert (np.abs(ncolor).sum(-1) > 0).any() and (nrng != rng0).any()
