"""The NEE megakernel's per-pixel code, checked on the host.

``csrc/nee.cuh`` compiles under a plain C++ compiler as well as under
nvcc, so ``tests/nee_host.cpp`` builds it with g++ (FMA contraction off, as
nvcc's ``-fmad=false``) and runs `nee_pixel` and `primary_hit` — the NEE
kernel's and the probe's whole work for one pixel, on the tables of
`ops/nee.py:nee_scene_tables` — pixel by pixel.  These tests hold them
against the plain PyTorch versions on every kind of scene: the live-bounce
telemetry equal, the lanes under `assert_lane_parity`, the probe's winners
equal and its t within 1e-6 relative (the host's sinf/cosf differ from
PyTorch's in the last bit; nothing else differs), and the presort order
bit-identical to raster order.  On the card, `chip_smoke.py` runs the same
checks against the CUDA build.
"""

import ctypes
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
from haskell_path_tracer_torch.ops.intersect import INFINITE
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render.nee import _present_kinds

from test_pallas_nee import assert_lane_parity

torch.set_num_threads(2)
HARNESS = __file__.replace("test_torch_nee_host.py", "nee_host.cpp")
H, W = 24, 48


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host harness")
    out = str(tmp_path_factory.mktemp("nee") / "libnee_host.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", MK.CSRC, "-o", out, HARNESS],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hpt_nee_host.argtypes = [vp, vp, vp, i, i, i, i, i, vp, vp, vp, vp, vp, vp,
                                 vp, vp, vp, i, i, i, i, i]
    lib.hpt_nee_host.restype = None
    lib.hpt_probe_host.argtypes = [vp, i, i, i, i, vp, vp, vp, vp, i]
    lib.hpt_probe_host.restype = None
    return lib


def _p(t):
    return None if t is None else t.data_ptr()


ORIGIN = ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
SCENES = {
    "cornell": (S.cornell_scene, None),
    "glassy": (S.glassy_scene, ORIGIN),
    "tri_emitters": (S.tri_emitter_scene, None),
    "box_tri": (S.box_tri_scene, ORIGIN),
    "zero_light": (S.zero_light_scene, None),
    "big300": (lambda d: S.big_scene(d, 300), ([0.0, 2.0, 0.0], [0.2, 0.0, 0.0])),
}


def _case(name):
    build, pose = SCENES[name]
    scene = build("cpu")
    cam = world.initial_camera("cpu") if pose is None else Camera.create(*pose, 90.0, "cpu")
    return scene, primary_rays(cam, W, H), gen_seeds((H, W), 41, "cpu")


def _host_nee(lib, tables, rays, rng, bounces, spp, kinds, primary=None, order=None):
    rad = torch.empty(H, W, 3)
    rng_out = torch.empty(H, W, 4, dtype=torch.int32)
    steps = torch.empty(H, W, dtype=torch.int32)
    t0, prim0 = primary if primary is not None else (None, None)
    lib.hpt_nee_host(
        _p(tables.fold), _p(tables.payload), _p(tables.lights), *tables.counts, tables.num_lights,
        _p(rays.origin), _p(rays.direction), _p(rng), _p(t0), _p(prim0), _p(order),
        _p(rad), _p(rng_out), _p(steps), H * W, spp, bounces, int(1 in kinds), int(2 in kinds),
    )
    return rad, rng_out, steps


@pytest.mark.parametrize("name", list(SCENES))
def test_pixel_code_matches_plain_version(lib, name):
    scene, rays, rng = _case(name)
    kinds = _present_kinds(scene)
    tables = NE.nee_scene_tables(scene)
    rad, rng_out, steps = _host_nee(lib, tables, rays, rng, 4, 2, kinds)
    ref = NE.trace_physical_nee_reference(scene, rays, rng, 4, 2, kinds, telemetry=True)
    assert torch.equal(steps, ref[2]) and steps.sum() > 0
    assert_lane_parity(ref[1].numpy(), rng_out.numpy(), ref[0].numpy(), rad.numpy())
    assert np.isfinite(rad.numpy()).all() and ref[0].abs().max() > 0


@pytest.mark.parametrize("name", ["cornell", "box_tri", "big300"])
def test_probe_and_presort(lib, name):
    scene, rays, rng = _case(name)
    tables = NE.nee_scene_tables(scene)
    t0 = torch.empty(H, W)
    prim0 = torch.empty(H, W, dtype=torch.int32)
    lib.hpt_probe_host(_p(tables.fold), *tables.counts, _p(rays.origin), _p(rays.direction),
                       _p(t0), _p(prim0), H * W)
    want_t, want_prim = NE.primary_probe(tables, rays)
    assert torch.equal(prim0, want_prim)
    hit = want_t < INFINITE
    assert torch.equal(t0[~hit], want_t[~hit])
    torch.testing.assert_close(t0[hit], want_t[hit], rtol=1e-6, atol=0)
    # The probe's output fed back in, in depth order, changes no bit.
    kinds = _present_kinds(scene)
    raster = _host_nee(lib, tables, rays, rng, 3, 2, kinds)
    order = NE._presort_order(t0)
    assert sorted(order.tolist()) == list(range(H * W))
    presorted = _host_nee(lib, tables, rays, rng, 3, 2, kinds, primary=(t0, prim0), order=order)
    for a, b in zip(raster, presorted):
        assert torch.equal(a, b)
