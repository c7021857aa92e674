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

The kernel's flat sample loop (`nee.cuh:lane_step`, one live bounce per
step, a path that ends restarting the next sample from the primary hit)
runs here in lockstep over 32-lane groups, so that the lanes of a group sit
at different samples as a warp's do, and is held bit for bit against the
nested sample x bounce loop it replaced (kept in the harness as the
oracle): radiance, rng, live bounces and every residual word of the
recording instance, over spp 1-8 and bounces 1-6, with sky lanes, paths
that use their whole bounce budget and paths whose throughput falls to
near zero.

The probe kernel's fold (`csrc/probe.cuh`: R rays per group over the
sphere rows in tiles, then the planes, boxes and triangles) runs here with
tiles of 7 rows, so that one table spans many tiles, and is held bit for
bit against `primary_hit`.
"""

import ctypes
import dataclasses
import importlib.util
import os
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

from fold_cases import edge_rays
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
    lib.hpt_probe_tiled_host.argtypes = [i, i, vp, i, i, i, i, vp, vp, vp, vp, i]
    lib.hpt_probe_tiled_host.restype = None
    lib.hpt_nee_loop_host.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp, vp, vp, vp, vp, vp,
                                      i, i, i, i, i]
    lib.hpt_nee_loop_host.restype = ctypes.c_long
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


def _tie_table():
    """Unit spheres at (k, -2, 0), k = -3..3, then their copies, then the
    plane y = -1 twice; rays straight down from (k, 0, 0), which meet a
    sphere, its copy and both planes at t = 1 exactly, and 200 rays aimed
    near the spheres (`fold_cases.py`): 207 in all."""
    ks = np.arange(-3, 4, dtype=np.float32)
    centers = np.stack([ks, np.full(7, -2.0, np.float32), np.zeros(7, np.float32)], -1)
    rows = np.concatenate([centers, np.ones((7, 1), np.float32)], -1)
    plane = np.array([0, -1, 0, 0, 1, 0, 0, 0], np.float32)
    fold = np.concatenate([rows.reshape(-1), rows.reshape(-1), plane, plane])
    o, d = edge_rays(torch.as_tensor(np.concatenate([centers, centers])), torch.ones(14), 200, 3)[:2]
    down_o = torch.as_tensor(np.stack([ks, np.zeros(7, np.float32), np.zeros(7, np.float32)], -1))
    down_d = torch.tensor([0.0, -1.0, 0.0]).expand(7, 3)
    return torch.as_tensor(fold), (14, 2, 0, 0), torch.cat([down_o, o]), torch.cat([down_d, d])


def _probe_case(name):
    """(fold table, counts, origins [n, 3], directions [n, 3])."""
    if name == "ties":
        return _tie_table()
    if name == "inside":  # the camera at the centre of the Cornell scene's sphere 0
        scene = S.cornell_scene("cpu")
        rays = primary_rays(Camera.create(scene.spheres.pos[0].tolist(), [0.3, 0.2, 0.0], 90.0, "cpu"),
                            W, H)
    elif name == "ragged303":  # 303 spheres: no multiple of the tile or of R
        scene = S.big_scene("cpu", 303)
        rays = primary_rays(Camera.create(*SCENES["big300"][1], 90.0, "cpu"), W, H)
    else:
        scene, rays, _ = _case("big300" if name == "odd" else name)
    tables = NE.nee_scene_tables(scene)
    n = H * W - 1 if name == "odd" else H * W
    return (tables.fold, tables.counts, rays.origin.reshape(-1, 3)[:n].contiguous(),
            rays.direction.reshape(-1, 3)[:n].contiguous())


PROBE_TILE_ROWS = 7


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("name", ["cornell", "box_tri", "big300", "ragged303", "ties", "inside", "odd"])
def test_tiled_probe_matches_primary_hit(lib, name, R):
    """The probe kernel's fold, R rays per group over the sphere rows in
    tiles of 7, then the other kinds, against `primary_hit`, bit for bit:
    exact ties between spheres and between a sphere and a plane, a camera
    inside a sphere, a table that is no multiple of the tile or of R, and
    an odd ray count."""
    fold, counts, o, d = _probe_case(name)
    n = o.shape[0]
    got = torch.empty(n), torch.empty(n, dtype=torch.int32)
    want = torch.empty(n), torch.empty(n, dtype=torch.int32)
    lib.hpt_probe_tiled_host(R, PROBE_TILE_ROWS, _p(fold), *counts, _p(o), _p(d), _p(got[0]),
                             _p(got[1]), n)
    lib.hpt_probe_host(_p(fold), *counts, _p(o), _p(d), _p(want[0]), _p(want[1]), n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    hit = want[0] < INFINITE
    assert hit.any() and (counts[0] > PROBE_TILE_ROWS or name == "box_tri")
    if name == "ties":
        # Each downward ray: sphere k at t = 1, tied by its copy and the planes.
        assert torch.equal(want[0][:7], torch.ones(7)) and torch.equal(want[1][:7], torch.arange(7, dtype=torch.int32))
    if name == "inside":
        assert hit.all() and (want[1] != 0).all()
    if name == "odd":
        assert n % 2 == 1


def _dimmed_big(device):
    """The 300-sphere scene with a third of its spheres black and a third
    at colour 5e-4 (throughput quadrance 7.5e-7, under the near-zero 1e-6):
    paths end on near-zero throughput as well as on misses and budget."""
    scene = S.big_scene(device, 300)
    m = scene.spheres.material
    color = m.color.clone()
    color[0::3] = 0.0
    color[1::3] = 5e-4
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, material=dataclasses.replace(m, color=color)))


LOOP_SCENES = {**SCENES, "dimmed300": (_dimmed_big, SCENES["big300"][1])}
UNWRITTEN = 0x5A5A5A58  # no live bit: a word neither loop may touch


def _loop(lib, flat, tables, rays, rng, spp, bounces, kinds, record):
    rad = torch.empty(H, W, 3)
    rng_out = torch.empty(H, W, 4, dtype=torch.int32)
    steps = torch.empty(H, W, dtype=torch.int32)
    words = torch.full((spp * bounces, H * W), UNWRITTEN, dtype=torch.int32) if record else None
    mixed = lib.hpt_nee_loop_host(
        _p(tables.fold), _p(tables.payload), _p(tables.lights), *tables.counts, tables.num_lights,
        flat, _p(rays.origin), _p(rays.direction), _p(rng), _p(rad), _p(rng_out), _p(steps),
        _p(words), H * W, spp, bounces, int(1 in kinds), int(2 in kinds))
    return (rad, rng_out, steps) + ((words,) if record else ()), mixed


def _ends(words, spp, bounces):
    """Samples (over lanes) that end on a primary miss, on a later miss, on
    near-zero throughput, and by using the whole bounce budget."""
    w = words.reshape(spp, bounces, -1)
    live, hit = (w & NE.LIVE_BIT) != 0, (w & NE.HIT_BIT) != 0
    dead = NE.written_words(words, spp, bounces).reshape(spp, bounces, -1) & ~live
    return {"sky": int((dead[:, 0] & ~hit[:, 0]).sum()), "miss": int((dead[:, 1:] & ~hit[:, 1:]).sum()),
            "near_zero": int((dead & hit).sum()), "budget": int(live.all(1).sum())}


@pytest.mark.parametrize("spp", range(1, 9))
@pytest.mark.parametrize("name", list(LOOP_SCENES))
def test_flat_loop_matches_nested_loop(lib, name, spp):
    """The flat loop, in lockstep over 32-lane groups, against the nested
    loop: radiance, rng and live bounces of both instances, and every
    residual word of the recording one (the unwritten ones included), bit
    for bit, at 1-6 bounces."""
    build, pose = LOOP_SCENES[name]
    scene = build("cpu")
    cam = world.initial_camera("cpu") if pose is None else Camera.create(*pose, 90.0, "cpu")
    rays, rng = primary_rays(cam, W, H), gen_seeds((H, W), 59 + spp, "cpu")
    tables, kinds = NE.nee_scene_tables(scene), _present_kinds(scene)
    ends = dict.fromkeys(("sky", "miss", "near_zero", "budget"), 0)
    mixed = 0
    for bounces in range(1, 7):
        for record in (False, True):
            want, _ = _loop(lib, 0, tables, rays, rng, spp, bounces, kinds, record)
            got, rounds = _loop(lib, 1, tables, rays, rng, spp, bounces, kinds, record)
            for a, b in zip(got, want):
                assert torch.equal(a, b), f"{bounces} bounces, record {record}"
            mixed += rounds
        for k, v in _ends(want[3], spp, bounces).items():
            ends[k] += v
    assert want[2].sum() > 0
    present = {k for k, v in ends.items() if v}
    assert "budget" in present
    if name in ("glassy", "box_tri", "big300", "dimmed300"):
        # Paths of unequal length: the lanes of a group part samples.
        assert {"sky", "miss"} <= present
        assert mixed > 0 or spp == 1
    if name == "dimmed300":
        assert "near_zero" in present


def test_flat_loop_writes_every_sky_sample(lib):
    """A lane whose primary ray misses completes all its samples without a
    bounce, and the recording instance writes each sample's dead bounce-0
    word (the winner prim0, no flag), as the nested loop does: the backward
    reads that word to end each sample's replay."""
    build, pose = LOOP_SCENES["dimmed300"]
    scene = build("cpu")
    rays, rng = primary_rays(Camera.create(*pose, 90.0, "cpu"), W, H), gen_seeds((H, W), 61, "cpu")
    tables, kinds = NE.nee_scene_tables(scene), _present_kinds(scene)
    spp, bounces = 5, 3
    t0, prim0 = NE.primary_probe(tables, rays)
    sky = (t0 >= INFINITE).reshape(-1)
    assert 0 < sky.sum() < H * W
    (rad, rng_out, steps, words), _ = _loop(lib, 1, tables, rays, rng, spp, bounces, kinds, True)
    first = words.reshape(spp, bounces, -1)[:, 0, sky]
    assert torch.equal(first, (prim0.reshape(-1)[sky] << NE.PRIM_SHIFT).expand(spp, -1))
    assert (words.reshape(spp, bounces, -1)[:, 1:, sky] == UNWRITTEN).all()
    assert (steps.reshape(-1)[sky] == 0).all() and (rad.reshape(-1, 3)[sky] == 0).all()
    assert torch.equal(rng_out.reshape(-1, 4)[sky], rng.reshape(-1, 4)[sky])
    want, _ = _loop(lib, 0, tables, rays, rng, spp, bounces, kinds, True)
    assert torch.equal(words, want[3])


def test_warp_efficiency_forms(lib):
    """`chip_smoke.py`'s warp efficiencies on the flat loop's telemetry and
    words: one sample gives the flat and the nested form the same value,
    and over several the flat loop's (max over lanes of the sum over
    samples) is never below the nested loop's (sum of maxes)."""
    path = os.path.join(os.path.dirname(MK.CSRC), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build, pose = LOOP_SCENES["dimmed300"]
    scene = build("cpu")
    rays, rng = primary_rays(Camera.create(*pose, 90.0, "cpu"), W, H), gen_seeds((H, W), 67, "cpu")
    tables, kinds = NE.nee_scene_tables(scene), _present_kinds(scene)
    eff = {}
    for spp in (1, 6):
        (_, _, steps, words), _ = _loop(lib, 1, tables, rays, rng, spp, 4, kinds, True)
        eff[spp] = smoke.warp_efficiency(steps), smoke.nested_warp_efficiency(words, spp, 4)
        assert all(0.0 < e <= 1.0 for e in eff[spp])
        order = torch.randperm(H * W, generator=torch.Generator().manual_seed(spp)).to(torch.int32)
        lanes = steps.reshape(-1)[order.long()]
        assert smoke.warp_efficiency(steps, order) == smoke.warp_efficiency(lanes)
    assert eff[1][0] == pytest.approx(eff[1][1], rel=1e-12)
    assert eff[6][0] > eff[6][1]
