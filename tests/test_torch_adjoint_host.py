"""The backward CUDA kernel's hand-written adjoint, checked on the host.

``csrc/bounce.cuh`` compiles under a plain C++ compiler as well as under
nvcc, so ``tests/adjoint_host.cpp`` builds it with g++ (FMA contraction
off, as nvcc's ``-fmad=false``) and these tests hold it against
torch.autograd of the plain version:

  * `bounce_vjp`, one bounce at a few hundred random states per scene —
    every primitive kind and the glass block — with random cotangents of
    all twelve outputs;
  * `pixel_backward`, the kernel's whole per-pixel replay and reverse
    sweep, against `backward_reference` on small images at 4 and 8
    bounces, the table cotangents per column;
  * the per-sample backward: the rng states the replay draws at the start
    of every sample against the plain trace's rng after s samples
    (`ops/megakernel.py:sample_states_reference`, what the recording
    forward writes), and each (pixel, sample) replayed from its state,
    summed in sample order, bit-equal to `pixel_backward` and within the
    tolerance of `backward_reference` at 4 and 8 bounces;
  * `brdf_sample` and `bounce_vjp`, which compute only the winner's
    rotation (with sincosf), bit for bit against the branchless forms the
    harness keeps (both rotations with sinf and cosf, then a select), over
    every BRDF kind and random states.

Tolerance: a scale-normalised error max|a - b| / (max|b| + 1e-6) below
1e-4 per state and per output (per column of each kind's table rows for
the whole backward); the two sides do the same float32 work in
another order, and the host's sinf/cosf differ from PyTorch's in the last
bit.  Measured below 1e-5.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import megakernel_vjp as V
from haskell_path_tracer_torch.ops.rng import gen_seeds

from torch_port_fixtures import jax_scene, torch_camera, torch_scene

torch.set_num_threads(2)
TOL = 1e-4
N_STATES = 600
HARNESS = __file__.replace("test_torch_adjoint_host.py", "adjoint_host.cpp")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host harness")
    out = str(tmp_path_factory.mktemp("adjoint") / "libadjoint_host.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", MK.CSRC, "-o", out, HARNESS],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hpt_bounce_vjp_host.argtypes = [vp, i, vp, i, i, i, i, i, i, vp, vp, vp, vp, vp, vp]
    lib.hpt_bounce_vjp_host.restype = None
    lib.hpt_backward_host.argtypes = [vp, i, vp, i, i, i, i, i, i, vp, vp, vp, vp, i, i, vp, vp, vp, vp]
    lib.hpt_backward_host.restype = i
    lib.hpt_bounce_vjp_branchless_host.argtypes = lib.hpt_bounce_vjp_host.argtypes
    lib.hpt_bounce_vjp_branchless_host.restype = None
    lib.hpt_brdf_sample_host.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.hpt_brdf_sample_host.restype = None
    lib.hpt_sample_states_host.argtypes = [vp, i, vp, i, i, i, i, i, i, vp, vp, vp, i, i, vp]
    lib.hpt_sample_states_host.restype = i
    lib.hpt_backward_samples_host.argtypes = lib.hpt_backward_host.argtypes
    lib.hpt_backward_samples_host.restype = i
    return lib


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data


def _tables(name):
    scene = torch_scene(jax_scene(name)[0])
    geom, mat = MK.scene_tables(scene)
    return scene, geom, mat, MK.primitive_counts(scene), scene.has_dielectric()


def _norm_err(a, b, axis=None):
    return np.abs(a - b).max(axis=axis) / (np.abs(b).max(axis=axis) + 1e-6)


class _BatchRows:
    """`geom[p][k]` of per-state tables [n, P, cols]: the [n] column."""

    def __init__(self, t):
        self.t = t

    def __getitem__(self, p):
        row = self.t[:, p]
        return [row[:, k] for k in range(row.shape[1])]


def _random_states(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform([-6.0, -2.9, -16.0], [8.0, 10.0, -2.0], size=(n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    th = rs.uniform(0.0, 1.0, size=(n, 3))
    # The uniforms' grid: k 2^-24 mapped to [-1, 1].
    v = rs.integers(0, 2**24, size=(n, 3)) * 2.0**-23 - 1.0
    state = np.concatenate([o, d, th, v], axis=1).astype(np.float32)
    cot = rs.normal(size=(n, 12)).astype(np.float32)
    return np.ascontiguousarray(state), cot


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_bounce_adjoint_matches_autograd(lib, name):
    _, geom, mat, counts, has_diel = _tables(name)
    state, cot = _random_states(N_STATES, seed=len(name))
    n, (P, gcols) = N_STATES, geom.shape
    g_state = np.zeros((n, 9), np.float32)
    dgeom = np.zeros((n, P, gcols), np.float32)
    dmat = np.zeros((n, P, 8), np.float32)
    winner = np.zeros(n, np.int32)
    G, M = geom.numpy().copy(), mat.numpy().copy()
    lib.hpt_bounce_vjp_host(
        _ptr(G), gcols, _ptr(M), *counts, int(has_diel), n, _ptr(state),
        _ptr(cot), _ptr(g_state), _ptr(dgeom), _ptr(dmat), _ptr(winner),
    )

    # The plain bounce on per-state copies of the tables, so each state's
    # table gradient stays apart.
    gt = geom[None].repeat(n, 1, 1).requires_grad_()
    mt = mat[None].repeat(n, 1, 1).requires_grad_()
    st = torch.tensor(state)
    o, d, th = (st[:, k:k + 3].clone().requires_grad_() for k in (0, 3, 6))
    no, nd, nth, em, dead = MK.bounce_reference(
        _BatchRows(gt), _BatchRows(mt), counts, o.unbind(-1), d.unbind(-1),
        th.unbind(-1), st[:, 9:12].unbind(-1), has_diel,
    )
    out = torch.stack([*no, *nd, *nth, *em], dim=-1)
    want = torch.autograd.grad((out * torch.tensor(cot)).sum(), [gt, mt, o, d, th])
    want_state = torch.cat(want[2:], dim=-1).numpy()

    np.testing.assert_array_equal(dead.numpy(), winner < 0)
    # Every kind the scene has, and glass where it has glass, was a winner.
    kinds = [k for k, c in zip(range(4), counts) for _ in range(c)]
    won = {kinds[w] for w in winner[winner >= 0]}
    assert won == {k for k, c in enumerate(counts) if c}, won
    if has_diel:
        is_glass = mat[:, 5].numpy() == 2.0
        assert (is_glass[winner[winner >= 0]]).sum() >= 20
    for label, got, ref in [
        ("rays", g_state, want_state),
        ("geom", dgeom, want[0].numpy()),
        ("mat", dmat, want[1].numpy()),
    ]:
        err = _norm_err(got.reshape(n, -1), ref.reshape(n, -1), axis=1)
        assert err.max() < TOL, (label, err.max(), int(err.argmax()))


def _pixel_backward_errors(lib, name, H, W, bounces, spp):
    """Normalised errors of the kernel's per-pixel replay and reverse sweep,
    pixel after pixel, against autograd of the plain trace: the ray
    cotangents whole, the table cotangents per column of each kind's rows."""
    _, geom, mat, counts, has_diel = _tables(name)
    rays = primary_rays(torch_camera(jax_scene(name)[1]), W, H)
    rng = gen_seeds((H, W), 9, "cpu")
    g_rad = torch.tensor(np.random.default_rng(4).normal(size=(H, W, 3)), dtype=torch.float32)
    want = V.backward_reference(geom, mat, counts, rays, rng, g_rad, bounces, spp, has_diel)

    G, M = geom.numpy().copy(), mat.numpy().copy()
    got = [np.zeros_like(G), np.zeros_like(M), np.zeros((H, W, 3), np.float32),
           np.zeros((H, W, 3), np.float32)]
    origin, direction = rays.origin.numpy(), rays.direction.numpy()
    rng_u32, g = rng.numpy().view(np.uint32), g_rad.numpy()
    assert lib.hpt_backward_host(
        _ptr(G), G.shape[1], _ptr(M), *counts, int(has_diel), H * W,
        _ptr(origin), _ptr(direction), _ptr(rng_u32), _ptr(g), spp, bounces,
        *(_ptr(a) for a in got),
    ) == 0
    bounds = np.cumsum([0, *counts])
    errs = {}
    for label, a, b in zip(("d_geom", "d_mat", "d_origin", "d_direction"), got, want):
        b = b.numpy()
        # The mixed scene's camera sees only flat surfaces first, whose
        # shading does not depend on where a ray lands: no ray gradient.
        if name != "mixed" or label in ("d_geom", "d_mat"):
            assert np.abs(b).max() > 0, label
        if label in ("d_geom", "d_mat"):
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                if hi > lo:
                    errs[f"{label}[{lo}:{hi}]"] = _norm_err(a[lo:hi], b[lo:hi], axis=0).max()
        else:
            errs[label] = _norm_err(a, b)
    return errs


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_pixel_backward_matches_backward_reference(lib, name):
    """4 bounces, 2 samples."""
    errs = _pixel_backward_errors(lib, name, 16, 32, 4, 2)
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_pixel_backward_at_eight_bounces(lib, name):
    """8 bounces, as the training path at 512x512 runs: the residual slots
    past the fourth and the longer reverse sweep."""
    errs = _pixel_backward_errors(lib, name, 16, 32, 8, 2)
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("has_diel", [False, True])
def test_brdf_sample_bit_equal_to_the_branchless_form(lib, has_diel):
    """The winner's rotation only, as the kernels compute it, gives the bits
    of both rotations and a select, for matte, glossy and glass winners
    (glass only in the dielectric instance; without it a glass row samples
    as matte in both forms)."""
    n = 30000
    rs = np.random.default_rng(17 + has_diel)
    nrm = rs.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # brdf_param over the reference's range and its special values.
    p = rs.choice([rs.uniform(0.0, 2.0), 0.0, 0.5, 1.0, 1.33, 1.5], size=n)
    p = np.where(rs.uniform(size=n) < 0.5, rs.uniform(0.0, 2.0, size=n), p)
    kd = rs.integers(0, 3, size=n).astype(np.float32)
    v = rs.integers(0, 2**24, size=(n, 3)) * 2.0**-23 - 1.0
    args = [np.ascontiguousarray(a, np.float32) for a in (nrm, d, p, kd, v)]
    nd, nd_ref = np.zeros((n, 3), np.float32), np.ones((n, 3), np.float32)
    scale, scale_ref = np.zeros(n, np.float32), np.ones(n, np.float32)
    lib.hpt_brdf_sample_host(int(has_diel), n, *(_ptr(a) for a in args), _ptr(nd),
                             _ptr(scale), _ptr(nd_ref), _ptr(scale_ref))
    np.testing.assert_array_equal(nd, nd_ref)
    np.testing.assert_array_equal(scale, scale_ref)
    assert np.isfinite(nd).all() and (scale != 0).mean() > 0.5
    # Every kind was drawn, and the glass branch took both of its ways.
    assert {0.0, 1.0, 2.0} <= set(kd.tolist())
    if has_diel:
        glass = kd == 2.0
        assert (scale[glass] == 1.0).all() and not (scale[~glass] == 1.0).all()


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_bounce_adjoint_bit_equal_to_the_branchless_form(lib, name):
    """`bounce_vjp` with only the winner's rotation and the half angles
    shared with its adjoint gives the bits of the branchless adjoint: the
    ray, throughput and table cotangents of every state."""
    _, geom, mat, counts, has_diel = _tables(name)
    state, cot = _random_states(N_STATES, seed=3 + len(name))
    n, (P, gcols) = N_STATES, geom.shape
    G, M = geom.numpy().copy(), mat.numpy().copy()
    outs = []
    for fn in (lib.hpt_bounce_vjp_host, lib.hpt_bounce_vjp_branchless_host):
        out = [np.zeros((n, 9), np.float32), np.zeros((n, P, gcols), np.float32),
               np.zeros((n, P, 8), np.float32), np.zeros(n, np.int32)]
        fn(_ptr(G), gcols, _ptr(M), *counts, int(has_diel), n, _ptr(state), _ptr(cot),
           *(_ptr(a) for a in out))
        outs.append(out)
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert (outs[0][3] >= 0).sum() > n // 4 and np.abs(outs[0][0]).max() > 0


@pytest.mark.parametrize("bounces", [4, 8])
@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_per_sample_backward_from_recorded_states(lib, name, bounces):
    """The states the per-sample backward starts from are the plain trace's
    rng after s samples, and replaying each sample from its state gives the
    per-pixel backward's bits and backward_reference's cotangents."""
    H, W, spp = 12, 16, 3
    _, geom, mat, counts, has_diel = _tables(name)
    rays = primary_rays(torch_camera(jax_scene(name)[1]), W, H)
    rng = gen_seeds((H, W), 21, "cpu")
    g_rad = torch.tensor(np.random.default_rng(5).normal(size=(H, W, 3)), dtype=torch.float32)
    G, M = geom.numpy().copy(), mat.numpy().copy()
    origin, direction = rays.origin.numpy(), rays.direction.numpy()
    rng_u32, g = rng.numpy().view(np.uint32), g_rad.numpy()

    states = np.zeros((H, W, spp, 4), np.uint32)
    assert lib.hpt_sample_states_host(_ptr(G), G.shape[1], _ptr(M), *counts, int(has_diel), H * W,
                                      _ptr(origin), _ptr(direction), _ptr(rng_u32), spp,
                                      bounces, _ptr(states)) == 0
    want_states = MK.sample_states_reference(geom, mat, counts, rays, rng, bounces, spp, has_diel)
    np.testing.assert_array_equal(states, want_states.numpy().view(np.uint32))
    assert (states[:, :, -1] != states[:, :, 0]).any()

    outs = []
    for fn, r in ((lib.hpt_backward_samples_host, states), (lib.hpt_backward_host, rng_u32)):
        out = [np.zeros_like(G), np.zeros_like(M), np.zeros((H, W, 3), np.float32),
               np.zeros((H, W, 3), np.float32)]
        assert fn(_ptr(G), G.shape[1], _ptr(M), *counts, int(has_diel), H * W, _ptr(origin),
                  _ptr(direction), _ptr(r), _ptr(g), spp, bounces, *(_ptr(a) for a in out)) == 0
        outs.append(out)
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
    want = V.backward_reference(geom, mat, counts, rays, rng, g_rad, bounces, spp, has_diel)
    for a, b in zip(outs[0], want):
        assert _norm_err(a, b.numpy()) < TOL
