"""The splitting kernel's per-pixel traversal, checked on the host.

``csrc/split.cuh`` compiles under a plain C++ compiler as well as under
nvcc, so ``tests/split_host.cpp`` builds it with g++ (FMA contraction off,
as nvcc's ``-fmad=false``) and runs the kernel's flat step loop
(`split_start`, `split_step`, `split_store`) on the tables of
`ops/megakernel.py:scene_tables`: pixel by pixel, one lane alone
(`split_pixel`), and in emulated warps of 32 lanes stepping in turn, their
pixels handed out in a permuted queue order, each lane free as in the
kernel or held to the warp's earliest sample.  These tests hold both against the plain PyTorch
version, `ops/split.py:trace_split_reference`: every rng word equal and
the radiance within 1e-6 (the host's sinf/cosf may differ from PyTorch's in
the last bit), and the warp bit for bit against the lane alone, with the
register stacks of 1, 2 and 4 slots and the local-memory stack, on glass,
mixed kinds and the 300-sphere scene.  On the card, `chip_smoke.py` runs
the same comparison against the CUDA build.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import split as SP
from haskell_path_tracer_torch.ops.rng import gen_seeds

from torch_port_fixtures import jax_mixed_scene, torch_scene

torch.set_num_threads(2)
HARNESS = __file__.replace("test_torch_split_host.py", "split_host.cpp")
H, W = 16, 40
ORIGIN = ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host harness")
    out = str(tmp_path_factory.mktemp("split") / "libsplit_host.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", MK.CSRC, "-o", out, HARNESS],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hpt_split_host.argtypes = [vp, i, vp, i, i, i, i, vp, vp, vp, vp, vp, i, i, i, i, i]
    lib.hpt_split_host.restype = None
    lib.hpt_stack_capacity.argtypes = [i]
    lib.hpt_stack_capacity.restype = i
    lib.hpt_split_warp_host.argtypes = [vp, i, vp, i, i, i, i, vp, vp, vp, vp, vp, vp,
                                        i, i, i, i, i, i]
    lib.hpt_split_warp_host.restype = ctypes.c_long
    return lib


SCENES = {
    "glass": (S.suite_glass_scene, ORIGIN),
    "glassy": (S.glassy_scene, ORIGIN),
    "mixed": (lambda d: torch_scene(jax_mixed_scene(), d), ORIGIN),
    "reference": (world.main_scene, None),
    "big300": (lambda d: S.big_scene(d, 300), ([0.0, 2.0, 0.0], [0.2, 0.0, 0.0])),
}


def _host(lib, scene, rays, rng, bounces, spp, stack_depth, cap):
    geom, mat = MK.scene_tables(scene)
    rad = torch.empty(H, W, 3)
    rng_out = torch.empty(H, W, 4, dtype=torch.int32)
    lib.hpt_split_host(geom.data_ptr(), geom.shape[1], mat.data_ptr(), *MK.primitive_counts(scene),
                       rays.origin.contiguous().data_ptr(), rays.direction.contiguous().data_ptr(),
                       rng.data_ptr(), rad.data_ptr(), rng_out.data_ptr(), H * W, spp, bounces,
                       stack_depth, cap)
    return rad, rng_out


@pytest.mark.parametrize("name,bounces,spp,stack_depth", [
    ("glass", 6, 2, 2), ("glass", 8, 1, 1), ("glass", 8, 1, 4), ("glass", 15, 1, 14),
    ("glassy", 6, 2, 2), ("mixed", 5, 2, 2), ("reference", 6, 2, 2), ("big300", 4, 1, 2),
])
def test_pixel_code_matches_plain_version(lib, name, bounces, spp, stack_depth):
    build, pose = SCENES[name]
    scene = build("cpu")
    cam = world.initial_camera("cpu") if pose is None else Camera.create(*pose, 90.0, "cpu")
    rays, rng = primary_rays(cam, W, H), gen_seeds((H, W), 51, "cpu")
    want = SP.trace_split_reference(scene, rays, rng, bounces, spp, stack_depth)
    # The kernel's stack for this depth, and the local-memory one.
    caps = {lib.hpt_stack_capacity(stack_depth), 0}
    assert lib.hpt_stack_capacity(stack_depth) == (stack_depth if stack_depth in (1, 2, 4) else 0)
    for cap in caps:
        rad, rng_out = _host(lib, scene, rays, rng, bounces, spp, stack_depth, cap)
        assert torch.equal(rng_out, want[1]), cap
        torch.testing.assert_close(rad, want[0], rtol=1e-6, atol=1e-6)
    # Segments were traced (each alive one advances the rng counter by 3).
    assert torch.isfinite(rad).all() and (want[1][..., 3] != rng[..., 3]).any()


def _warp(lib, scene, rays, rng, order, bounces, spp, stack_depth, cap, barrier):
    geom, mat = MK.scene_tables(scene)
    rad = torch.empty(H, W, 3)
    rng_out = torch.empty(H, W, 4, dtype=torch.int32)
    rounds = lib.hpt_split_warp_host(
        geom.data_ptr(), geom.shape[1], mat.data_ptr(), *MK.primitive_counts(scene),
        rays.origin.contiguous().data_ptr(), rays.direction.contiguous().data_ptr(),
        rng.data_ptr(), order.data_ptr(), rad.data_ptr(), rng_out.data_ptr(), H * W, spp,
        bounces, stack_depth, cap, barrier)
    return rad, rng_out, rounds


@pytest.mark.parametrize("stack_depth", [1, 2, 4, 5])
@pytest.mark.parametrize("spp", [1, 2, 5])
@pytest.mark.parametrize("name", ["glass", "mixed", "big300"])
def test_flat_loop_in_an_emulated_warp(lib, name, spp, stack_depth):
    """The kernel's warps: 32 lanes, each on its own pixel, sample and
    step, their pixels handed out in a permuted order, free (as the kernel
    runs them) and held to the warp's earliest sample, give every pixel the
    bits of one lane run alone, and the plain version's rng and radiance.
    Stack depth 5 takes the local-memory stack."""
    bounces = 6
    build, pose = SCENES[name]
    scene = build("cpu")
    cam = Camera.create(*pose, 90.0, "cpu")
    rays, rng = primary_rays(cam, W, H), gen_seeds((H, W), 70 + spp, "cpu")
    cap = lib.hpt_stack_capacity(stack_depth)
    assert cap == (stack_depth if stack_depth in (1, 2, 4) else 0)
    order = torch.randperm(H * W, generator=torch.Generator().manual_seed(spp + stack_depth))
    order = order.to(torch.int32)
    alone = _host(lib, scene, rays, rng, bounces, spp, stack_depth, cap)
    want = SP.trace_split_reference(scene, rays, rng, bounces, spp, stack_depth, telemetry=True)
    rounds = {}
    for barrier in (1, 0):
        rad, rng_out, rounds[barrier] = _warp(lib, scene, rays, rng, order, bounces, spp,
                                              stack_depth, cap, barrier)
        assert torch.equal(rad, alone[0]) and torch.equal(rng_out, alone[1]), barrier
        assert torch.equal(rng_out, want[1])
        torch.testing.assert_close(rad, want[0], rtol=1e-6, atol=1e-6)
    # Held to the warp's earliest sample, a warp pays at most, sample by
    # sample, its longest lane's steps of the nested loop; free, no more.
    lanes = want[3].reshape(spp, -1)[:, order.long()].reshape(spp, -1, 32)
    assert rounds[0] <= rounds[1] <= lanes.amax(2).sum().item()
    assert (rng_out[..., 3] != rng[..., 3]).any()


@pytest.mark.parametrize("name,bounces,stack_depth", [
    ("glass", 2, 1), ("glass", 3, 1), ("glass", 4, 1), ("glass", 5, 1), ("glassy", 2, 1),
    ("glassy", 3, 1),
])
def test_step_budget_ends_samples_as_the_nested_loop(lib, name, bounces, stack_depth):
    """Where samples use up their bounces x (1 + stack_depth) steps of the
    nested loop, the flat loop, which runs a pop and a sample's end in the
    step that found the dead segment, still ends each sample after that
    many of the nested loop's steps."""
    build, pose = SCENES[name]
    scene = build("cpu")
    rays, rng = primary_rays(Camera.create(*pose, 90.0, "cpu"), W, H), gen_seeds((H, W), 5, "cpu")
    want = SP.trace_split_reference(scene, rays, rng, bounces, 1, stack_depth, telemetry=True)
    assert (want[3] == bounces * (1 + stack_depth)).any()
    cap = lib.hpt_stack_capacity(stack_depth)
    order = torch.arange(H * W, dtype=torch.int32)
    for rad, rng_out in (_host(lib, scene, rays, rng, bounces, 1, stack_depth, cap),
                         _warp(lib, scene, rays, rng, order, bounces, 1, stack_depth, cap, 1)[:2]):
        assert torch.equal(rng_out, want[1])
        torch.testing.assert_close(rad, want[0], rtol=1e-6, atol=1e-6)
