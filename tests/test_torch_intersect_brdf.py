"""Nearest hit and BRDF sampling in the PyTorch port against the JAX package,
on camera rays plus random rays, for the reference, mixed-kinds and glass
scenes."""

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.models.camera import primary_rays as jrays
from haskell_path_tracer_tpu.ops import brdf as jbrdf
from haskell_path_tracer_tpu.ops.intersect import nearest_hit as jnearest

from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy
from haskell_path_tracer_torch.ops import brdf as tbrdf
from haskell_path_tracer_torch.ops import intersect as tint

from torch_port_fixtures import jax_scene, torch_scene

torch.set_num_threads(2)


def _rays(name):
    """Camera rays of the scene plus 4096 random rays (origins in a box
    around the scene, unit directions), as numpy [N, 3]."""
    _, jcam = jax_scene(name)
    cam = jrays(jcam, 64, 16)
    rng = np.random.default_rng(7)
    o = rng.uniform(-6.0, 6.0, size=(4096, 3)).astype(np.float32)
    o[:, 2] -= 6.0
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origin = np.concatenate([np.asarray(cam.origin).reshape(-1, 3), o])
    direction = np.concatenate([np.asarray(cam.direction).reshape(-1, 3), d])
    return origin, direction


def _hits(name):
    jscene, _ = jax_scene(name)
    o, d = _rays(name)
    # Eager, op by op: under jit XLA fuses and reorders the float ops, and
    # t would agree only to ~1e-5 instead of 1e-6.
    jh = jnearest(o, d, jscene)
    th = tint.nearest_hit(torch.as_tensor(o), torch.as_tensor(d), torch_scene(jscene))
    return jscene, o, d, jh, th


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_nearest_hit_matches_jax(name):
    _, _, _, jh, th = _hits(name)
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6, atol=0)
    hit = np.asarray(jh.hit)
    for f in ("point", "normal", "color"):
        np.testing.assert_allclose(
            getattr(th, f).numpy()[hit], np.asarray(getattr(jh, f))[hit],
            rtol=1e-5, atol=1e-5, err_msg=f,
        )
    np.testing.assert_array_equal(th.brdf_kind.numpy(), np.asarray(jh.brdf_kind))
    np.testing.assert_array_equal(th.brdf_param.numpy(), np.asarray(jh.brdf_param))
    np.testing.assert_array_equal(th.illuminance.numpy(), np.asarray(jh.illuminance))
    assert hit.mean() > 0.3  # the rays see the scene
    assert np.isfinite(th.normal.numpy()).all() and np.isfinite(th.point.numpy()).all()


def test_mixed_scene_hits_every_kind():
    jscene, _, _, _, th = _hits("mixed")
    prims = set(np.unique(th.prim.numpy()[th.hit.numpy()]).tolist())
    # spheres are prims 0-1, plane 2, box 3, triangle 4
    assert {0, 2, 3, 4} <= prims, prims


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_brdf_sample_matches_jax(name):
    _, o, d, jh, th = _hits(name)
    state = np.random.default_rng(3).integers(0, 2**32, size=(o.shape[0], 4), dtype=np.uint32)
    jo, jd, jt, js = jbrdf.sample(jh, d, state)
    to, td, tt, ts = tbrdf.sample(th, torch.as_tensor(d), rng_from_numpy(state, "cpu"))
    np.testing.assert_array_equal(rng_to_numpy(ts), np.asarray(js))
    hit = np.asarray(jh.hit)
    for got, want in ((to, jo), (td, jd), (tt, jt)):
        np.testing.assert_allclose(got.numpy()[hit], np.asarray(want)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tbrdf.emittance(th).numpy(), np.asarray(jbrdf.emittance(jh)), rtol=0, atol=0
    )
    if name == "glass":
        assert (th.brdf_kind.numpy()[hit] == 2).any()


def test_dielectric_split_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (2048, 1))
    ior = rng.uniform(1.0, 2.4, size=2048).astype(np.float32)
    want = jbrdf.dielectric_split(d, n, ior)
    got = tbrdf.dielectric_split(*map(torch.as_tensor, (d, n, ior)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert (np.asarray(want[2]) == 1.0).any()  # some total internal reflection


def test_nearest_hit_above_threshold_raises():
    """Above CHUNKED_THRESHOLD primitives `nearest_hit` no longer raises:
    the chunked fold answers, with the one-plane fold's winners and t."""
    from haskell_path_tracer_torch.models.objects import (
        Scene, make_materials, make_planes, make_spheres,
    )

    n = tint.CHUNKED_THRESHOLD + 1
    rng = np.random.default_rng(3)
    pos = rng.uniform(-5.0, 5.0, size=(n, 3))
    pos[:, 2] -= 12.0
    spheres = make_spheres(
        pos, rng.uniform(0.2, 1.0, n), make_materials([([1, 1, 1], 0, 0, 1)] * n, "cpu"), "cpu"
    )
    planes = make_planes([[0, -1, 0]], [[0, 1, 0]], make_materials([([1, 1, 1], 0, 0, 1)], "cpu"), "cpu")
    scene = Scene(spheres=spheres, planes=planes)
    d = torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    d[:, 2] = -d[:, 2].abs()
    o = torch.zeros_like(d)
    hit = tint.nearest_hit(o, d, scene)
    t, prim = tint._nearest_t_prim_small(o, d, scene)
    assert torch.equal(hit.t, t) and torch.equal(hit.prim, prim)
    assert (hit.prim[hit.hit] < n).any() and (hit.prim[hit.hit] == n).any()
