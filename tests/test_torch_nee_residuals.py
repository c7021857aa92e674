"""The NEE gradient's residual mode in the port, on the CPU.

  (a) The port's plain residual words (`ops/nee.py:
      trace_physical_nee_reference(residuals=True)`) against the JAX
      package's Pallas NEE kernel in its recording mode
      (`_trace_nee_from_tables(..., grad_residuals=True, interpret=True)`)
      at 16x8 / 2 spp / 3 bounces on a small mixed scene: glass, glossy and
      matte spheres, a plane, a blocker triangle, a sphere emitter and a
      triangle emitter.  Under the lane-parity contract of
      `tests/test_pallas_nee.py:assert_lane_parity`: at most 0.5% of lanes
      with another rng or another word; the winner and the hit bit are held
      on every word (a path that ended keeps its winner and hit bit in both
      packages), the occlusion bit on the live words only (the TPU kernel
      leaves it undefined on a dead lane, the port writes 0).
  (b) The plain backward from the words (`ops/nee_vjp.py:
      backward_reference(words=...)`, autograd of `trace_from_words`, no
      fold) against the plain fold-replay backward (autograd of the plain
      trace) on the cases cornell8, tri, glassy and big200 of
      `tests/torch_port_fixtures.py`: per `SceneParams` field and for the ray
      cotangents a normalised error max|a - b| / max|b| within 1e-6 (the two
      take the same decisions; they differ in the order of a few float
      sums).
  (c) The mode gate: `RESIDUAL_MAX_BYTES` and the light tile's size pick
      each mode, the tile gate reads its constant, the CPU routes launch
      nothing and the launchers refuse CPU tensors (above 768 emitters too,
      where the gradient agrees with the residual mode's); the word replay
      reads nothing past a path's end.
"""

import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays
from haskell_path_tracer_tpu.models.objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Scene as JaxScene,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)
from haskell_path_tracer_tpu.ops.pallas_nee import (
    _nee_scene_tables,
    _trace_nee_from_tables,
    scene_light_indices,
)
from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models.objects import Rays
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops import nee_vjp as NV
from haskell_path_tracer_torch.render.nee import _present_kinds

import torch_port_fixtures as F
from test_pallas_nee import assert_lane_parity

torch.set_num_threads(2)
H, W, SPP, B = 8, 16, 2, 3
MAX_DIVERGED = 0.005
GRAD_TOL = 1e-6


def jax_mixed_scene():
    """Spheres of all three BRDFs (one an emitter), a floor plane, an
    emissive triangle and a matte blocker triangle."""
    spheres = make_spheres(
        [[0.0, -1.0, -6.0], [-2.5, 0.0, -7.0], [2.3, -0.5, -5.5]],
        [1.6, 1.2, 1.0],
        make_materials([
            ([0.95, 0.95, 0.99], 0.0, BRDF_DIELECTRIC, 1.5),
            ([0.9, 0.9, 0.9], 0.0, BRDF_GLOSSY, 1.0),
            ([0.3, 0.8, 0.5], 6.0, BRDF_MATTE, 1.0),
        ]),
    )
    planes = make_planes(
        [[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.55], 0.0, BRDF_MATTE, 1.0)]),
    )
    tris = make_triangles(
        [[-2.0, 5.0, -7.5], [-1.0, 0.5, -4.0]],
        [[2.0, 5.0, -7.5], [1.0, 0.5, -4.0]],
        [[0.0, 5.0, -4.5], [0.0, 2.0, -5.0]],
        make_materials([
            ([1.0, 0.95, 0.8], 20.0, BRDF_MATTE, 1.0),
            ([0.4, 0.5, 0.9], 0.0, BRDF_MATTE, 1.0),
        ]),
    )
    return JaxScene(spheres=spheres, planes=planes, triangles=tris)


@pytest.fixture(scope="module")
def jax_words():
    """One interpret-mode call of the JAX package's recording NEE kernel:
    its inputs and outputs as numpy arrays."""
    scene = jax_mixed_scene()
    rays = jax_primary_rays(J.initial_camera(), W, H)
    rng = J.make_accumulator(W, H, seed=61).rng
    light_idx = scene_light_indices(scene)
    rad, rng_out, (prims, flags) = _trace_nee_from_tables(
        *_nee_scene_tables(scene, light_idx), rays.origin, rays.direction, rng,
        num_spheres=scene.spheres.count, num_planes=scene.planes.count,
        num_tris=scene.triangles.count, num_boxes=0, num_lights=len(light_idx),
        has_glossy=True, has_diel=True, num_bounces=B, spp=SPP, interpret=True,
        grad_residuals=True,
    )
    return {
        "scene": C.scene_to_numpy(scene),
        "origin": np.asarray(rays.origin, np.float32),
        "direction": np.asarray(rays.direction, np.float32),
        "rng_in": np.asarray(rng),
        "radiance": np.asarray(rad),
        "rng_out": np.asarray(rng_out),
        "prims": np.stack([np.asarray(p).reshape(-1) for p in prims]).astype(np.int32),
        "flags": np.stack([np.asarray(f).reshape(-1) for f in flags]).astype(np.int32),
    }


def _port_words(inp):
    scene = C.scene_from_numpy(inp["scene"], "cpu")
    rays = Rays(origin=torch.tensor(inp["origin"]), direction=torch.tensor(inp["direction"]))
    return NE.trace_physical_nee_reference(scene, rays, C.rng_from_numpy(inp["rng_in"], "cpu"),
                                           B, SPP, _present_kinds(scene), residuals=True)


def test_plain_words_match_jax_recording_kernel(jax_words):
    """(a): the port's plain words against the TPU kernel's two residual
    planes, lane by lane."""
    rad, rng_out, words = _port_words(jax_words)
    assert_lane_parity(jax_words["rng_out"], C.rng_to_numpy(rng_out),
                       jax_words["radiance"], rad.numpy())
    words = words.numpy()
    prims, flags = jax_words["prims"], jax_words["flags"]
    live = (words & NE.LIVE_BIT) != 0
    off = ((words >> NE.PRIM_SHIFT) != prims) | ((words & NE.HIT_BIT) != (flags & 2))
    off |= live & ((words & NE.OCC_BIT) != (flags & 1))
    rng_off = ~(C.rng_to_numpy(rng_out) == jax_words["rng_out"]).all(-1).reshape(-1)
    assert (off.any(0) | rng_off).mean() <= MAX_DIVERGED
    # Every kind of word shows up: live, ended, shadowed, and a miss.
    assert live.any() and (~live).any()
    assert (live & ((words & NE.OCC_BIT) != 0)).any()
    assert ((words & NE.HIT_BIT) == 0).any()
    # A live word is a hit.
    assert ((words[live] & NE.HIT_BIT) != 0).all()


def test_plain_words_kinds_of_winner(jax_words):
    """The words name winners of every kind the scene has: spheres, the
    plane and the triangles."""
    _, _, words = _port_words(jax_words)
    prims = set((words[(words & NE.LIVE_BIT) != 0] >> NE.PRIM_SHIFT).tolist())
    assert prims & {0, 1, 2} and 3 in prims and prims & {4, 5}


def _grad_inputs(case):
    jscene, jcam = F.jax_nee_scene(case)
    scene = F.torch_scene(jscene)
    rays = jax_primary_rays(jcam, F.NEE_GRAD_W, F.NEE_GRAD_H)
    rays = Rays(origin=torch.tensor(np.asarray(rays.origin)),
                direction=torch.tensor(np.asarray(rays.direction)))
    seed = F.NEE_GRAD_CASES[case]
    rng = C.rng_from_numpy(np.asarray(J.make_accumulator(F.NEE_GRAD_W, F.NEE_GRAD_H, seed=seed).rng),
                           "cpu")
    shape = (F.NEE_GRAD_H, F.NEE_GRAD_W, 3)
    wts = torch.as_tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return scene, rays, rng, wts


@pytest.mark.parametrize("case", ["cornell8", "tri", "glassy", "big200"])
def test_word_backward_matches_fold_replay(case):
    """(b): the plain backward that takes every decision from the words
    against the plain backward that replays the folds."""
    scene, rays, rng, wts = _grad_inputs(case)
    kinds = _present_kinds(scene)
    bounces, spp = F.NEE_GRAD_BOUNCES, F.NEE_GRAD_SPP
    rad, rng_out, words = NE.trace_physical_nee_reference(scene, rays, rng, bounces, spp, kinds,
                                                          residuals=True)
    # The word replay's forward is the plain trace's.
    rad_w, rng_w = NV.trace_from_words(NE.nee_scene_tables(scene), rays, rng, words, bounces, spp,
                                       1 in kinds, 2 in kinds)
    assert torch.equal(rng_w, rng_out)
    torch.testing.assert_close(rad_w, rad, rtol=1e-5, atol=1e-5)

    want, want_o, want_d = NV.backward_reference(scene, rays, rng, wts, bounces, spp, kinds)
    got, got_o, got_d = NV.backward_reference(scene, rays, rng, wts, bounces, spp, kinds,
                                              words=words)
    nonzero = 0
    for f, w in want.items():
        if w.numel():
            assert torch.isfinite(got[f]).all(), f
            err = ((got[f] - w).abs().max() / w.abs().max().clamp(min=1e-6)).item()
            assert err <= GRAD_TOL, (f, err)
            nonzero += int(w.abs().max() > 0)
    assert nonzero >= 8
    for g, w in ((got_o, want_o), (got_d, want_d)):
        assert ((g - w).abs().max() / w.abs().max().clamp(min=1e-6)).item() <= GRAD_TOL


def test_word_replay_reads_nothing_past_a_path_end():
    """(c): words past the bounce where a path ended, which the kernel
    leaves unwritten, change nothing in the word replay."""
    scene, rays, rng, wts = _grad_inputs("glassy")
    kinds = _present_kinds(scene)
    bounces, spp = F.NEE_GRAD_BOUNCES, F.NEE_GRAD_SPP
    _, _, words = NE.trace_physical_nee_reference(scene, rays, rng, bounces, spp, kinds,
                                                  residuals=True)
    written = NE.written_words(words, spp, bounces)
    assert not written.all()
    garbage = torch.where(written, words, torch.randint_like(words, -2**31, 2**31 - 1))
    tables = NE.nee_scene_tables(scene)
    a = NV.trace_from_words(tables, rays, rng, words, bounces, spp, 1 in kinds, 2 in kinds)
    b = NV.trace_from_words(tables, rays, rng, garbage, bounces, spp, 1 in kinds, 2 in kinds)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_mode_gate_reads_the_byte_budget(monkeypatch):
    """(c): `RESIDUAL_MAX_BYTES` picks the residual mode up to its bytes (4
    per lane, sample and bounce), the replay mode above; 0 forces the
    replay mode."""
    assert NV.records_residuals(1920 * 1088, 8, 4, 10)  # suite config 7: 267 MB
    assert NV.records_residuals(512 * 512, 1, 4, 10)
    assert not NV.records_residuals(3840 * 2160, 64, 16, 10)
    n = NV.RESIDUAL_MAX_BYTES // 16
    assert NV.records_residuals(n, 1, 4, 10) and not NV.records_residuals(n + 1, 1, 4, 10)
    monkeypatch.setattr(NV, "RESIDUAL_MAX_BYTES", 0)
    assert not NV.records_residuals(1, 1, 1, 10)


def test_mode_gate_reads_the_light_tile():
    """(c): the residual mode keeps the light cotangents in a shared-memory
    tile of 64 B per emitter row (one row without emitters), so it is taken
    only while that tile fits in RESIDUAL_LIGHT_TILE_MAX_BYTES: 768
    emitters at 48 KB, not 769; the replay mode above."""
    rows = NV.RESIDUAL_LIGHT_TILE_MAX_BYTES // 64
    assert rows == 768
    assert NV.records_residuals(512 * 512, 1, 4, 0)
    assert NV.records_residuals(512 * 512, 1, 4, rows)
    assert not NV.records_residuals(512 * 512, 1, 4, rows + 1)
    assert not NV.records_residuals(1, 1, 1, 1 << 20)


def test_tile_gate_reads_its_constant(monkeypatch):
    """(c): the residual mode's cotangent tiles go to shared memory when the
    three of them fit in RESIDUAL_TILE_MAX_BYTES, two blocks' worth per SM
    of an H100: suite config 7's 1000 spheres and 1600 spheres do, 3400
    and 20000 do not."""
    from haskell_path_tracer_torch.models import scenes as S

    assert 2 * (NV.RESIDUAL_TILE_MAX_BYTES + 1024) == 228 * 1024
    tables = NE.nee_scene_tables(S.big_scene("cpu", 1000))
    nbytes = 4 * (tables.fold.numel() + tables.payload.numel() + tables.lights.numel())
    assert NV.residual_tiles_in_smem(tables)
    assert NV.residual_tiles_in_smem(NE.nee_scene_tables(S.big_scene("cpu", 1600)))
    for n in (3400, 20000):
        assert not NV.residual_tiles_in_smem(NE.nee_scene_tables(S.big_scene("cpu", n)))
    monkeypatch.setattr(NV, "RESIDUAL_TILE_MAX_BYTES", nbytes - 4)
    assert not NV.residual_tiles_in_smem(tables)


@pytest.mark.parametrize("budget", [0, 1 << 31], ids=["replay", "residual"])
def test_cpu_routes_never_launch(monkeypatch, budget):
    """(c): on CPU tensors the differentiable trace runs the plain version,
    whatever the budget: no kernel launch is counted, and the launchers
    refuse CPU tensors before launching."""
    monkeypatch.setattr(NV, "RESIDUAL_MAX_BYTES", budget)
    scene, rays, rng, wts = _grad_inputs("cornell8")
    counts = (dict(NE.LAUNCHES), NE.RECORD_LAUNCHES, NV.LAUNCHES, NV.RESIDUAL_LAUNCHES)
    rad, rng_out = NV.trace_physical_nee_diff(scene, rays, rng, 2, 1)
    want = NE.trace_physical_nee_reference(scene, rays, rng, 2, 1)
    assert torch.equal(rad, want[0]) and torch.equal(rng_out, want[1])
    tables = NE.nee_scene_tables(scene)
    words = torch.zeros((2, rng.shape[0] * rng.shape[1]), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        NV.launch_nee_backward(tables, rays, rng, wts, 2, 1, words=words)
    assert (dict(NE.LAUNCHES), NE.RECORD_LAUNCHES, NV.LAUNCHES, NV.RESIDUAL_LAUNCHES) == counts


def test_many_emitters_take_the_replay_mode_and_agree_with_the_residual_mode(monkeypatch):
    """(c): a scene of more than 768 emitters takes the replay mode (the
    residual mode's light tile does not hold it); on the CPU the
    differentiable trace still runs the plain version and launches nothing,
    and its gradient agrees with the residual mode's plain backward from
    the words, which the gate takes on the same scene once the light-tile
    limit is raised above it."""
    from haskell_path_tracer_torch.models import scenes as S
    from haskell_path_tracer_torch.models.camera import primary_rays
    from haskell_path_tracer_torch.models.objects import Camera
    from haskell_path_tracer_torch.ops.rng import gen_seeds

    h, w, spp, bounces = 8, 8, 2, 3
    scene = S.big_scene("cpu", 900, emitter_share=0.95)
    lights = len(NE.scene_light_indices(scene))
    assert lights > NV.RESIDUAL_LIGHT_TILE_MAX_BYTES // 64
    assert not NV.records_residuals(h * w, spp, bounces, lights)
    rays = primary_rays(Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0, "cpu"), w, h)
    rng = gen_seeds((h, w), 3, "cpu")
    wts = torch.as_tensor(np.random.default_rng(3).normal(size=(h, w, 3)).astype(np.float32))

    counts = (dict(NE.LAUNCHES), NE.RECORD_LAUNCHES, NV.LAUNCHES, NV.RESIDUAL_LAUNCHES)
    leaves = NV._leaves(scene)
    o, d = rays.origin.clone().requires_grad_(), rays.direction.clone().requires_grad_()
    rad, _ = NV.trace_physical_nee_diff(NV._leaf_scene(leaves, scene), Rays(origin=o, direction=d),
                                        rng, bounces, spp)
    grads = torch.autograd.grad(rad, [*leaves, o, d], wts, allow_unused=True)
    assert (dict(NE.LAUNCHES), NE.RECORD_LAUNCHES, NV.LAUNCHES, NV.RESIDUAL_LAUNCHES) == counts

    kinds = _present_kinds(scene)
    _, _, words = NE.trace_physical_nee_reference(scene, rays, rng, bounces, spp, kinds, residuals=True)
    want, want_o, want_d = NV.backward_reference(scene, rays, rng, wts, bounces, spp, kinds, words=words)
    nonzero = 0
    for g, (f, x) in zip(grads, want.items()):
        if x.numel():
            g = torch.zeros_like(x) if g is None else g
            err = ((g - x).abs().max() / x.abs().max().clamp(min=1e-6)).item()
            assert err <= GRAD_TOL, (f, err)
            nonzero += int(x.abs().max() > 0)
    assert nonzero >= 8
    for g, x in ((grads[-2], want_o), (grads[-1], want_d)):
        assert ((g - x).abs().max() / x.abs().max().clamp(min=1e-6)).item() <= GRAD_TOL
    monkeypatch.setattr(NV, "RESIDUAL_LIGHT_TILE_MAX_BYTES", 64 * lights)
    assert NV.records_residuals(h * w, spp, bounces, lights)
