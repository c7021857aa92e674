"""The NEE gradient's residual mode, checked on the host.

``csrc/nee.cuh`` and ``csrc/nee_vjp.cuh`` compile under a plain C++
compiler as well as under nvcc, so ``tests/nee_residual_host.cpp`` builds
them with g++ (FMA contraction off, as nvcc's ``-fmad=false``; its build
counts every call of ``fold``) and these tests check, on every lane of
several scenes:

  * `nee_pixel` with RECORD writes the plain version's residual words
    (`ops/nee.py:trace_physical_nee_reference(residuals=True)`) on every
    word the kernel writes, under the lane-parity contract of
    `tests/test_pallas_nee.py:assert_lane_parity` (at most 0.5% of lanes
    may part from the plain version at a knife edge: the host's sinf/cosf
    differ from PyTorch's in the last bit), leaves the words past a path's
    end unwritten, and gives the production instance's radiance and rng bit
    for bit (`tests/nee_host.cpp`);
  * the fold-free replay (`pixel_backward` with RESID) stores the folded
    replay's rays, throughputs and winners, bounce by bounce, bit for bit,
    and runs no fold (the harness's fold count stays 0);
  * the fold-free `pixel_backward` gives the folded one's table and ray
    cotangents within 1e-6 normalised (the two take the same decisions on
    the same residuals, summed in the same order).
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render.nee import _present_kinds

from test_pallas_nee import assert_lane_parity

torch.set_num_threads(2)
HERE = __file__.replace("test_torch_nee_residual_host.py", "")
H, W = 24, 48
TOL = 1e-6
MAX_DIVERGED = 0.005
UNWRITTEN = 0x5A5A5A58  # no live bit: a word the kernel must not touch
ORIGIN = ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])


def _low_ior_glass(device):
    """The glass scene with its first sphere at ior 0.75, so that the
    dielectric reflects totally too."""
    scene = S.glassy_scene(device)
    m = scene.spheres.material
    param = m.brdf_param.clone()
    param[0] = 0.75
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, material=dataclasses.replace(m, brdf_param=param)))


# name -> (scene function, camera pose, bounces, spp)
CASES = {
    "cornell": (S.cornell_scene, None, 4, 2),
    "glassy": (S.glassy_scene, ORIGIN, 4, 2),
    "glass_ior075_b15": (_low_ior_glass, ORIGIN, 15, 1),
    "tri_emitters": (S.tri_emitter_scene, None, 3, 2),
    "zero_light": (S.zero_light_scene, None, 4, 2),
    "big300": (lambda d: S.big_scene(d, 300), ([0.0, 2.0, 0.0], [0.2, 0.0, 0.0]), 4, 2),
}


def _build(tmp_path_factory, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host harness")
    out = str(tmp_path_factory.mktemp(name) / f"lib{name}.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", MK.CSRC, "-o", out, HERE + f"{name}.cpp"],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "nee_residual_host")
    vp, i = ctypes.c_void_p, ctypes.c_int
    scene_args = [vp, vp, vp, i, i, i, i, i, i, i, i, vp, vp, vp]
    lib.hpt_take_fold_count.argtypes = []
    lib.hpt_take_fold_count.restype = ctypes.c_long
    lib.hpt_nee_record_host.argtypes = scene_args + [vp, vp, vp, i, i]
    lib.hpt_nee_record_host.restype = None
    lib.hpt_nee_replay_host.argtypes = scene_args + [vp, i, i, i, vp, vp, vp]
    lib.hpt_nee_replay_host.restype = i
    lib.hpt_nee_backward_host.argtypes = scene_args + [vp, i, vp, i, i, vp, vp, vp, vp, vp]
    lib.hpt_nee_backward_host.restype = i
    return lib


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    lib = _build(tmp_path_factory, "nee_host")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hpt_nee_host.argtypes = [vp, vp, vp, i, i, i, i, i, vp, vp, vp, vp, vp, vp,
                                 vp, vp, vp, i, i, i, i, i]
    lib.hpt_nee_host.restype = None
    return lib


def _p(t):
    if t is None:
        return None
    assert t.is_contiguous()
    return t.data_ptr()


def _case(name):
    build, pose, bounces, spp = CASES[name]
    scene = build("cpu")
    cam = world.initial_camera("cpu") if pose is None else Camera.create(*pose, 90.0, "cpu")
    kinds = _present_kinds(scene)
    return (scene, NE.nee_scene_tables(scene), primary_rays(cam, W, H),
            gen_seeds((H, W), 53, "cpu"), bounces, spp, 1 in kinds, 2 in kinds)


def _scene_args(tables, glossy, diel, rays, rng):
    return (_p(tables.fold), _p(tables.payload), _p(tables.lights), *tables.counts,
            tables.num_lights, int(glossy), int(diel), H * W, _p(rays.origin),
            _p(rays.direction), _p(rng))


def _record(lib, case):
    scene, tables, rays, rng, bounces, spp, glossy, diel = case
    rad = torch.empty(H, W, 3)
    rng_out = torch.empty(H, W, 4, dtype=torch.int32)
    words = torch.full((spp * bounces, H * W), UNWRITTEN, dtype=torch.int32)
    lib.hpt_nee_record_host(*_scene_args(tables, glossy, diel, rays, rng), _p(rad),
                            _p(rng_out), _p(words), spp, bounces)
    return rad, rng_out, words


@pytest.mark.parametrize("name", list(CASES))
def test_record_writes_plain_words(lib, production, name):
    """The recording instance's words against the plain version's on
    every word it writes, its radiance and rng against the production
    instance's, bit for bit."""
    case = _case(name)
    scene, tables, rays, rng, bounces, spp, glossy, diel = case
    rad, rng_out, words = _record(lib, case)

    prod_rad, prod_rng = torch.empty(H, W, 3), torch.empty(H, W, 4, dtype=torch.int32)
    production.hpt_nee_host(
        _p(tables.fold), _p(tables.payload), _p(tables.lights), *tables.counts,
        tables.num_lights, _p(rays.origin), _p(rays.direction), _p(rng), None, None, None,
        _p(prod_rad), _p(prod_rng), None, H * W, spp, bounces, int(glossy), int(diel))
    assert torch.equal(rad, prod_rad) and torch.equal(rng_out, prod_rng)

    want_rad, want_rng, want = NE.trace_physical_nee_reference(
        scene, rays, rng, bounces, spp, _present_kinds(scene), residuals=True)
    assert_lane_parity(want_rng.numpy(), rng_out.numpy(), want_rad.numpy(), rad.numpy())
    written = NE.written_words(want, spp, bounces)
    rng_off = ~(want_rng == rng_out).all(-1).reshape(-1)
    word_off = ((words != want) & written).any(0)
    assert (rng_off | word_off).double().mean() <= MAX_DIVERGED
    # Past a path's end nothing is written; the live words carry the hit bit.
    assert (words[~written] == UNWRITTEN).all()
    assert ((want[written] & NE.LIVE_BIT == 0) | (want[written] & NE.HIT_BIT != 0)).all()
    assert (want & NE.LIVE_BIT != 0).sum() > 0


@pytest.mark.parametrize("name", list(CASES))
def test_fold_free_replay_stores_folded_residuals(lib, name):
    """Per (pixel, sample, bounce) the fold-free replay's stored ray,
    throughput and winner equal the folded replay's bit for bit, with no
    fold run."""
    case = _case(name)
    _, tables, rays, rng, bounces, spp, glossy, diel = case
    _, _, words = _record(lib, case)
    out = {}
    for resid in (0, 1):
        states = torch.zeros(H * W, spp, bounces, 9)
        prims = torch.zeros(H * W, spp, bounces, dtype=torch.int32)
        live = torch.zeros(H * W, spp, dtype=torch.int32)
        lib.hpt_take_fold_count()
        assert lib.hpt_nee_replay_host(*_scene_args(tables, glossy, diel, rays, rng), _p(words),
                                       resid, spp, bounces, _p(states), _p(prims), _p(live)) == 0
        out[resid] = (states, prims, live, lib.hpt_take_fold_count())
    (s0, p0, l0, folds0), (s1, p1, l1, folds1) = out[0], out[1]
    assert folds1 == 0 and folds0 > 0
    assert torch.equal(l0, l1) and l0.sum() > 0
    off = (s0.view(torch.int32) != s1.view(torch.int32)).any(-1) | (p0 != p1)
    assert not off.any(), f"bounces that differ at (pixel, sample, bounce) {off.nonzero()[:8].tolist()}"


@pytest.mark.parametrize("name", list(CASES))
def test_fold_free_backward_matches_folded(lib, name):
    """The fold-free `pixel_backward` against the folded one: table and ray
    cotangents within 1e-6 normalised, no fold run."""
    case = _case(name)
    _, tables, rays, rng, bounces, spp, glossy, diel = case
    _, _, words = _record(lib, case)
    g_rad = torch.as_tensor(np.random.default_rng(7).normal(size=(H, W, 3)).astype(np.float32))
    got = {}
    for resid in (0, 1):
        outs = [torch.zeros_like(tables.fold), torch.zeros_like(tables.payload),
                torch.zeros_like(tables.lights), torch.empty(H, W, 3), torch.empty(H, W, 3)]
        lib.hpt_take_fold_count()
        assert lib.hpt_nee_backward_host(*_scene_args(tables, glossy, diel, rays, rng), _p(words),
                                         resid, _p(g_rad), spp, bounces, *map(_p, outs)) == 0
        got[resid] = (outs, lib.hpt_take_fold_count())
    assert got[1][1] == 0
    for a, b in zip(got[1][0], got[0][0]):
        assert torch.isfinite(a).all()
        assert ((a - b).abs().max() / (b.abs().max() + 1e-6)).item() <= TOL
    assert max(x.abs().max() for x in got[0][0]) > 0
