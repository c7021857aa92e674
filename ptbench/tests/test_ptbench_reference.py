"""The frozen reference against the program's plain paths at tiny sizes, on
the CPU.  Only this file imports both."""

import os

import numpy as np
import pytest
import torch

import haskell_path_tracer_torch as hpt
from haskell_path_tracer_torch.models import scenes as port_scenes
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops.rng import np_gen_seeds
from haskell_path_tracer_torch.render import nee as port_nee
from haskell_path_tracer_torch.render.integrator import trace_inline
from ptbench import harness, scenes
from ptbench.loops import common
from ptbench.reference import core as C
from ptbench.reference import parity, physical, progressive

CONFIGS = os.path.join(harness.HERE, "configs")


def config(name):
    return harness.load_json(os.path.join(CONFIGS, name + ".json"))


def port_scene(arrays):
    return common.program_scene(arrays, "cpu")


def test_scene_arrays_are_the_programs_scenes():
    big = scenes.build(config("big1000_nee")["scene"])
    port = port_scenes.big_scene("cpu", 1000)
    ref = scenes.build(config("reference_parity")["scene"])
    main = world.main_scene("cpu")
    for arrays, scene in ((big, port), (ref, main)):
        got = hpt.scene_to_params(port_scene(arrays))
        want = hpt.scene_to_params(scene)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for part, key in ((scene.spheres, "sphere_kind"), (scene.planes, "plane_kind")):
            assert np.array_equal(part.material.brdf_kind.numpy(), arrays[key])


@pytest.mark.parametrize("name", ["big1000_nee", "reference_parity"])
def test_primary_rays_bit_equal(name):
    cam = config(name)["camera"]
    port = hpt.primary_rays(Camera.create(cam["position"], cam["rotation"], cam["fov"], "cpu"),
                            40, 24)
    f32 = dict(dtype=torch.float32)
    o, d = C.primary_rays(torch.tensor(cam["position"], **f32),
                          torch.tensor(cam["rotation"], **f32), torch.tensor(cam["fov"], **f32),
                          40, 24)
    assert torch.equal(o, port.origin) and torch.equal(d, port.direction)


def test_seed_states_are_the_programs():
    want = np_gen_seeds((6, 5), 2**31 + 99).view(np.int32)
    assert np.array_equal(C.seed_states((6, 5), 2**31 + 99), want)
    pixels = np.array([3, 17, 29])
    assert np.array_equal(C.seed_states((6, 5), 2**31 + 99, pixels), want.reshape(-1, 4)[pixels])


def rays_and_rng(name, w=16, h=12, seed=5):
    cfg = config(name)
    cam = cfg["camera"]
    rays = hpt.primary_rays(Camera.create(cam["position"], cam["rotation"], cam["fov"], "cpu"),
                            w, h)
    rng = torch.as_tensor(np_gen_seeds((h, w), seed).view(np.int32))
    return cfg, rays, rng


def test_nee_sample_bit_equal_to_the_plain_loop():
    cfg, rays, rng = rays_and_rng("big1000_nee")
    arrays = scenes.build(cfg["scene"])
    want, want_rng, want_live = port_nee._trace(port_scene(arrays), rays, rng, 4, True, None)
    scene = C.scene_from_arrays(arrays, "cpu")
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    got, got_rng, words, live = physical.trace(scene, o, d, rng.reshape(-1, 4), 4,
                                               C.present_kinds(scene),
                                               first=physical.primary(scene, o, d))
    assert torch.equal(got, want.reshape(-1, 3)) and torch.equal(got_rng, want_rng.reshape(-1, 4))
    assert torch.equal(live, want_live.reshape(-1))
    # Replaying the words gives the same floats.
    again, again_rng = physical.trace(scene, o, d, rng.reshape(-1, 4), 4,
                                      C.present_kinds(scene), words=words)
    assert torch.equal(again, got) and torch.equal(again_rng, got_rng)


def test_parity_sample_bit_equal_to_the_plain_loop():
    cfg, rays, rng = rays_and_rng("reference_parity")
    arrays = scenes.build(cfg["scene"])
    want, want_rng = trace_inline(port_scene(arrays), rays, rng, 8)
    scene = C.scene_from_arrays(arrays, "cpu")
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    got, got_rng, words, _ = parity.trace(scene, o, d, rng.reshape(-1, 4), 8,
                                          C.present_kinds(scene))
    assert torch.equal(got, want.reshape(-1, 3)) and torch.equal(got_rng, want_rng.reshape(-1, 4))
    again, _ = parity.trace(scene, o, d, rng.reshape(-1, 4), 8, C.present_kinds(scene),
                            words=words)
    assert torch.equal(again, got)


def test_frame_lanes_equal_the_renderer():
    from haskell_path_tracer_torch.render.renderer import Renderer
    from haskell_path_tracer_torch.utils.config import RenderConfig

    cfg, rays, _ = rays_and_rng("big1000_nee", 12, 8)
    arrays = scenes.build(cfg["scene"])
    acc = Renderer(RenderConfig(width=12, height=8, algorithm="physical", bounces=3,
                                reseed_interval=4, device="cpu")).render(
        port_scene(arrays), Camera.create(cfg["camera"]["position"], cfg["camera"]["rotation"],
                                          cfg["camera"]["fov"], "cpu"), 6, 2**33 + 1)
    pixels = np.array([0, 5, 40, 95])
    o, d = rays.origin.reshape(-1, 3)[pixels], rays.direction.reshape(-1, 3)[pixels]
    colour, rng, iterations = progressive.frame_lanes(
        "physical", C.scene_from_arrays(arrays, "cpu"), o, d, [2**33 + 1] * 4, pixels, (8, 12),
        6, 3, 4)
    assert iterations == acc.iterations == 6
    assert torch.equal(rng, acc.rng.reshape(-1, 4)[pixels])
    assert torch.equal(colour, acc.color.reshape(-1, 3)[pixels])


@pytest.mark.parametrize("name,spp,bounces", [("reference_parity", 3, 5), ("big1000_nee", 2, 3)])
def test_gradient_matches_the_plain_autograd(name, spp, bounces):
    cfg, rays, rng = rays_and_rng(name, 12, 10, seed=11)
    arrays = scenes.build(cfg["scene"])
    scene = port_scene(arrays)
    target = torch.full((10, 12, 3), 0.3)
    kw = dict(num_bounces=bounces, spp=spp, estimator=cfg["estimator"])
    if cfg["light_idx"]:
        kw.update(light_idx=hpt.scene_light_indices(scene))
    loss, grads = hpt.loss_and_grad(hpt.scene_to_params(scene), scene, Camera.create(
        cfg["camera"]["position"], cfg["camera"]["rotation"], cfg["camera"]["fov"], "cpu"),
        target, rng, **kw)
    leaves = {k: torch.as_tensor(arrays[k]) for k in C.FIELDS}
    kinds = {k: torch.as_tensor(arrays[k]) for k in C.KINDS}
    ref_loss, ref_grads = progressive.loss_and_grad(cfg["estimator"], leaves, kinds, rays.origin,
                                                    rays.direction, rng, target, spp, bounces)
    assert ref_loss.item() == pytest.approx(loss.item(), rel=1e-6)
    for k in C.FIELDS:
        want = getattr(grads, k)
        scale = max(want.abs().max().item(), 1e-12)
        assert (ref_grads[k] - want).abs().max().item() <= 1e-4 * scale, k


def test_replay_blocks_do_not_change_the_gradient(monkeypatch):
    cfg, rays, rng = rays_and_rng("reference_parity", 8, 6, seed=3)
    arrays = scenes.build(cfg["scene"])
    leaves = {k: torch.as_tensor(arrays[k]) for k in C.FIELDS}
    kinds = {k: torch.as_tensor(arrays[k]) for k in C.KINDS}
    target = torch.full((6, 8, 3), 0.2)
    args = ("parity", leaves, kinds, rays.origin, rays.direction, rng, target, 4, 4)
    _, whole = progressive.loss_and_grad(*args)
    monkeypatch.setattr(progressive, "REPLAY_LANES", 37)
    _, blocks = progressive.loss_and_grad(*args)
    for k in C.FIELDS:
        assert torch.allclose(whole[k], blocks[k], rtol=1e-5, atol=1e-7 * whole[k].abs().max())


def test_bfloat16_runs_and_departs():
    cfg, rays, rng = rays_and_rng("big1000_nee", 12, 8)
    scene = C.scene_from_arrays(scenes.build(cfg["scene"]), "cpu")
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    full = progressive.render_sum("physical", scene, o, d, rng.reshape(-1, 4), 2, 3)
    low = progressive.render_sum("physical", scene, o, d, rng.reshape(-1, 4), 2, 3,
                                 dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and torch.isfinite(low.float()).all()
    assert not torch.equal(low.float(), full)
