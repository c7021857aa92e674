"""The sphere-table folds' per-ray code, checked on the host.

``csrc/sphere_fold.cuh`` compiles under a plain C++ compiler as well as
under nvcc, so ``tests/sphere_fold_host.cpp`` builds it with g++ (FMA
contraction off, as nvcc's ``-fmad=false``) and runs the kernels' fold as
they run it: R rays (1, 2 or 4) per group over the table in index-ordered
tiles, here forced small so that several tiles run, the dual fold over its
live lanes only.  These tests hold it bit for bit (t, prim and the
occlusion) against the plain PyTorch versions, `sphere_nearest_chunked` and
`sphere_dual_reference`, and against the NEE megakernel's per-ray fold
(`nee.cuh:fold<false>` and `<true>`), on tables with exact ties (duplicated
spheres), at an eps that some ray meets exactly, with dead lanes and ray
counts that are no multiple of R.  The tables and rays come from
`fold_cases.py`; on the card, `chip_smoke.py` phase 18 runs the same
checks against the CUDA build.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from haskell_path_tracer_torch.models.objects import Spheres
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import sphere_fold as SF
from haskell_path_tracer_torch.ops.intersect import (
    EPSILON,
    INFINITE,
    sphere_distances,
    sphere_nearest_chunked,
)

from fold_cases import edge_rays, edge_spheres

torch.set_num_threads(2)
HARNESS = __file__.replace("test_torch_sphere_fold_host.py", "sphere_fold_host.cpp")
N_RAYS = 203  # no multiple of 2 or 4


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host harness")
    out = str(tmp_path_factory.mktemp("sphere_fold") / "libsphere_fold_host.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", MK.CSRC, "-o", out, HARNESS],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hpt_sphere_fold_host.argtypes = [i, i, vp, i, i, vp, vp, vp, vp, vp, vp, f, vp, vp, vp, i]
    lib.hpt_sphere_fold_host.restype = None
    lib.hpt_nee_sphere_fold_host.argtypes = [i, vp, i, vp, vp, vp, vp, vp, vp, f, vp, vp, vp, i]
    lib.hpt_nee_sphere_fold_host.restype = None
    return lib


def _spheres(num, seed):
    return edge_spheres(num, seed, "cpu")


def _rays(pos, radius, n, seed, dead_share=0.3):
    return edge_rays(pos, radius, n, seed, dead_share)


def _edge_eps(o, d, pos, radius):
    """A distance some ray meets exactly: as eps, that ray's t == eps."""
    t = sphere_distances(o, d, Spheres(pos=pos, radius=radius, material=None))
    finite = t[(t < INFINITE) & (t > 0.0)]
    return float(finite.sort().values[len(finite) // 2])


def _p(t):
    return None if t is None else t.data_ptr()


def _host_fold(lib, R, dual, table, tile_rows, rays, eps):
    o, d, b, t_light, li, alive = rays
    n = o.shape[0]
    t, prim, occ = torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    lib.hpt_sphere_fold_host(R, int(dual), _p(table), table.shape[0], tile_rows, _p(o), _p(d),
                             _p(b), _p(t_light), _p(li), _p(alive), eps, _p(t), _p(prim), _p(occ), n)
    return t, prim, occ != 0


def _nee_fold(lib, dual, table, rays, eps):
    o, d, b, t_light, li, alive = rays
    n = o.shape[0]
    t, prim, occ = torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    lib.hpt_nee_sphere_fold_host(int(dual), _p(table), table.shape[0], _p(o), _p(d), _p(b),
                                 _p(t_light), _p(li), _p(alive), eps, _p(t), _p(prim), _p(occ), n)
    return t, prim, occ != 0


def _plain(dual, pos, radius, rays, eps):
    o, d, b, t_light, li, alive = rays
    if dual:
        return SF.sphere_dual_reference(o, d, b, t_light, li, alive, pos, radius, eps)
    t, prim = sphere_nearest_chunked(o, d, Spheres(pos=pos, radius=radius, material=None), eps)
    return t, prim.to(torch.int32)


def _assert_equal(got, want, label):
    for name, a, b in zip(("t", "prim", "occ"), got, want):
        assert torch.equal(a, b), f"{label}: {name} differs"


def _check(lib, R, dual, pos, radius, rays, tile_rows, eps):
    """The tiled fold against the plain version and the NEE fold; returns
    the plain result."""
    table = SF.sphere_table(pos, radius)
    want = _plain(dual, pos, radius, rays, eps)
    got = _host_fold(lib, R, dual, table, tile_rows, rays, eps)
    label = f"R={R} dual={dual} P={len(pos)} tile={tile_rows} eps={eps}"
    n = 3 if dual else 2
    _assert_equal(got[:n], want[:n], label)
    _assert_equal(_nee_fold(lib, dual, table, rays, eps)[:n], want[:n], f"{label}, nee::fold")
    return want


@pytest.mark.parametrize("dual", [False, True], ids=["nearest", "dual"])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("P", [1, 7, 129, 1000])
def test_tiled_fold_matches_plain(lib, P, R, dual):
    """Several tiles (a third of the table each), R rays per group, 203
    rays, a third of the dual fold's lanes dead; at eps 0, EPSILON and a
    distance that one ray meets exactly."""
    pos, radius = _spheres(P, P)
    rays = _rays(pos, radius, N_RAYS, P + 1)
    hits = 0
    for eps in (0.0, EPSILON, _edge_eps(rays[0], rays[1], pos, radius)):
        want = _check(lib, R, dual, pos, radius, rays, max(1, (P + 2) // 3), eps)
        hits += int((want[0] < INFINITE).sum())
        if dual:
            assert torch.equal(want[0][rays[5] == 0], torch.full(((rays[5] == 0).sum(),), INFINITE))
    assert hits > 0
    if dual and P >= 7:
        assert want[2].any()


@pytest.mark.parametrize("R", [1, 2, 4])
def test_dual_all_dead_and_all_alive(lib, R):
    """Every lane dead: (INFINITE, 0, False) everywhere; every lane alive:
    the plain version's answers."""
    pos, radius = _spheres(129, 5)
    for share in (1.0, 0.0):
        rays = _rays(pos, radius, N_RAYS, 6, dead_share=share)
        want = _check(lib, R, True, pos, radius, rays, 50, EPSILON)
        if share == 1.0:
            assert (want[0] == INFINITE).all() and (want[1] == 0).all() and not want[2].any()
        else:
            assert (want[0] < INFINITE).any() and want[2].any()


@pytest.mark.parametrize("R", [1, 2, 4])
def test_duplicated_table_keeps_lowest_index(lib, R):
    """A table followed by its own copy: every exact tie goes to the first
    copy, in both folds, across a tile boundary that splits the copies."""
    pos, radius = _spheres(64, 9)
    pos2, radius2 = torch.cat([pos, pos]), torch.cat([radius, radius])
    rays = _rays(pos2, radius2, N_RAYS, 10)
    for dual in (False, True):
        want = _check(lib, R, dual, pos2, radius2, rays, 48, EPSILON)
        hit = want[0] < INFINITE
        assert hit.any() and (want[1][hit] < 64).all()
