"""The splitting kernel's per-pixel traversal, checked on the host.

``csrc/split.cuh`` compiles under a plain C++ compiler as well as under
nvcc, so ``tests/split_host.cpp`` builds it with g++ (FMA contraction off,
as nvcc's ``-fmad=false``) and runs `split_pixel` — the splitting kernel's
whole work for one pixel, on the tables of `ops/megakernel.py:scene_tables`
— pixel by pixel.  These tests hold it against the plain PyTorch version,
`ops/split.py:trace_split_reference`: every rng word equal and the radiance
within 1e-6 (the host's sinf/cosf may differ from PyTorch's in the last
bit), with the register stacks of 1, 2 and 4 slots and the local-memory
stack, on glass, mixed kinds and the 300-sphere scene.  On the card,
`chip_smoke.py` runs the same comparison against the CUDA build.
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
