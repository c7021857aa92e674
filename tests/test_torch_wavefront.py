"""The PyTorch port's wavefront integrator against the JAX package's: the
bounce loop with and without Russian roulette (rng equal, radiance within
1e-6; with splitting within SPLIT_TOL, below), its occupancy telemetry and
depth histogram, the batch's summed stats, the splitting stats' capacity,
the Renderer and the CLI's `--stats` line; and the large-scene nearest
hit that the wavefront runs above 128 primitives."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.ops import intersect as jint
from haskell_path_tracer_tpu.render import wavefront as jwf
from haskell_path_tracer_tpu.render.renderer import Renderer as JaxRenderer
from haskell_path_tracer_tpu.utils.config import RenderConfig as JaxConfig

from haskell_path_tracer_torch.app.main import main as torch_main
from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.convert import rng_to_numpy
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops import intersect as tint
from haskell_path_tracer_torch.ops import split as SP
from haskell_path_tracer_torch.render import integrator
from haskell_path_tracer_torch.render import wavefront as twf
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils.config import RenderConfig

from torch_port_fixtures import jax_scene, torch_camera, torch_scene

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 32, 8


def _pair(name, seed):
    jscene, jcam = jax_scene(name)
    return (jscene, jcam, J.make_accumulator(W, H, seed=seed),
            torch_scene(jscene), torch_camera(jcam), integrator.make_accumulator(W, H, seed, "cpu"))


def _assert_same(acc, jacc, tol=1e-6):
    assert acc.iterations == int(jacc.iterations)
    np.testing.assert_array_equal(rng_to_numpy(acc.rng), np.asarray(jacc.rng))
    np.testing.assert_allclose(acc.color.numpy(), np.asarray(jacc.color), rtol=tol, atol=tol)


# The splitting integrator against the JAX package's compiled one: XLA
# contracts a*b + c into FMAs inside its compiled loop, which moves a few
# radiance values by up to 1.2e-5 relative on the glass scene (the JAX
# function run eagerly, op by op, agrees with the port within 6e-8;
# tests/test_torch_split.py holds that).  The rng stays equal on every lane;
# the radiance is held to tests/test_pallas_split.py's 1e-4.
SPLIT_TOL = 1e-4


@pytest.mark.parametrize("name,roulette", [("main", False), ("glass", False), ("glass", True)])
def test_sample_and_stats_match_jax(name, roulette):
    jscene, jcam, jacc, scene, cam, acc = _pair(name, 3)
    jout, jstats = jwf.render_sample_wavefront(jscene, jcam, jacc, num_bounces=6,
                                               russian_roulette=roulette, return_stats=True)
    out, stats = twf.render_sample_wavefront(scene, cam, acc, num_bounces=6,
                                             russian_roulette=roulette, return_stats=True)
    _assert_same(out, jout)
    assert stats.capacity == int(jstats.capacity) == W * H
    np.testing.assert_array_equal(stats.occupancy.numpy(), np.asarray(jstats.occupancy))
    hist = twf.depth_histogram(stats)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jwf.depth_histogram(jstats)))
    assert int(hist.sum()) == W * H and stats.occupancy.dtype == torch.int32


@pytest.mark.parametrize("roulette", [False, True])
def test_batch_matches_jax_and_sums_stats(roulette):
    jscene, jcam, jacc, scene, cam, acc = _pair("glass", 5)
    jout, jstats = jwf.render_batch_wavefront(jscene, jcam, jacc, 3, num_bounces=5,
                                              russian_roulette=roulette, return_stats=True)
    out, stats = twf.render_batch_wavefront(scene, cam, acc, 3, num_bounces=5,
                                            russian_roulette=roulette, return_stats=True)
    _assert_same(out, jout)
    np.testing.assert_array_equal(stats.occupancy.numpy(), np.asarray(jstats.occupancy))
    # The batch's occupancy is the sum of its samples'.
    total, a = torch.zeros(6, dtype=torch.int32), acc
    for _ in range(3):
        a, s = twf.render_sample_wavefront(scene, cam, a, num_bounces=5,
                                           russian_roulette=roulette, return_stats=True)
        total += s.occupancy
    assert torch.equal(total, stats.occupancy) and stats.capacity == W * H
    _assert_same(twf.render_batch_wavefront(scene, cam, acc, 3, num_bounces=5,
                                            russian_roulette=roulette), jout)


def test_wavefront_equals_inline():
    """Split-free or not, the wavefront's bounce is the inline integrator's."""
    _, _, _, scene, cam, acc = _pair("glass", 8)
    a = twf.render_batch_wavefront(scene, cam, acc, 2, num_bounces=6)
    b = integrator.render_batch_inline(scene, cam, acc, 2, num_bounces=6)
    assert torch.equal(a.rng, b.rng) and torch.equal(a.color, b.color)


@pytest.mark.parametrize("queue_factor", [1.0, 2.5, 3.5])
def test_split_stats_capacity(queue_factor):
    jscene, jcam, jacc, scene, cam, acc = _pair("glass", 4)
    jout, jstats = jwf.render_batch_wavefront_split(
        jscene, jcam, jacc, 2, num_bounces=5, queue_factor=queue_factor, return_stats=True)
    out, stats = twf.render_batch_wavefront_split(
        scene, cam, acc, 2, num_bounces=5, queue_factor=queue_factor, return_stats=True)
    # round(): 2.5 -> 2 and 3.5 -> 4 slots, clamped to bounces - 1.
    slots = {1.0: 1, 2.5: 2, 3.5: 4}[queue_factor]
    assert stats.capacity == int(jstats.capacity) == W * H * 5 * (1 + slots)
    np.testing.assert_array_equal(stats.occupancy.numpy(), np.asarray(jstats.occupancy))
    _assert_same(out, jout, SPLIT_TOL)


@pytest.mark.parametrize("split", [False, True])
def test_renderer_matches_jax(split):
    jscene, jcam, _, scene, cam, _ = _pair("glass", 0)
    kw = dict(width=W, height=H, bounces=4, algorithm="wavefront", split=split, queue_factor=2.0)
    jr = JaxRenderer(JaxConfig(**kw))
    jacc = jr.render(jscene, jcam, 3, seed=6)
    renderer = Renderer(RenderConfig(device="cpu", **kw))
    acc = renderer.render(scene, cam, 3, seed=6)
    _assert_same(acc, jacc, SPLIT_TOL if split else 1e-6)
    assert renderer.wavefront_stats(scene, cam, acc) == jr.wavefront_stats(jscene, jcam, jacc)
    inline = Renderer(RenderConfig(device="cpu", width=W, height=H))
    assert inline.wavefront_stats(scene, cam, acc) is None


@pytest.mark.parametrize("variant", [["--variant", "streams"], ["--variant", "wavefront", "--split"],
                                     ["--variant", "inline"]])
def test_cli_stats_line_matches_jax(tmp_path, capfd, variant):
    """The CLI's `--stats` line after 2 samples at 16x8 on the reference
    scene: the JAX package's Renderer's telemetry after the same render
    (the JAX CLI logs it through a stream bound at import)."""
    algorithm = "inline" if "inline" in variant else "wavefront"
    kw = dict(width=16, height=8, bounces=4, algorithm=algorithm, split="--split" in variant,
              queue_factor=2.0)
    jr = JaxRenderer(JaxConfig(**kw))
    jacc = jr.render(J.main_scene(), J.initial_camera(), 2, seed=1)
    want = jr.wavefront_stats(J.main_scene(), J.initial_camera(), jacc)
    args = ["--width", "16", "--height", "8", "--spp", "2", "--bounces", "4", "--seed", "1",
            "--quiet", "--stats", "--device", "cpu", "-o", str(tmp_path / "port.png"), *variant]
    assert torch_main(args) == 0
    lines = [json.loads(l) for l in capfd.readouterr().err.splitlines() if l.startswith("{")]
    (rec,) = [r for r in lines if r["event"] in ("wavefront_stats", "stats_unavailable")]
    if want is None:
        assert rec["event"] == "stats_unavailable" and rec["variant"] == "inline"
    else:
        assert rec["event"] == "wavefront_stats"
        assert {k: rec[k] for k in want} == want
        assert sum(rec["depth_histogram"]) == rec["occupancy"][0] == 16 * 8
    assert SP.LAUNCHES["split_kernel"] == 0


def test_large_scene_nearest_hit_matches_jax():
    """Above 128 primitives `nearest_hit` takes the large-scene fold (on
    CUDA tensors the nearest-sphere kernel, once per wavefront bounce); on
    the CPU it is unchanged and still equals the JAX package's on the
    config-4 scene: the same winners and normals' source rows, t within the
    1e-4 relative that the JAX package's compiled scan allows
    (tests/test_torch_nee.py::test_chunked_fold_matches_jax)."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import suite

    jscene = suite.big_scene(1000)
    scene = S.big_scene("cpu", 1000)
    assert scene.num_primitives > tint.CHUNKED_THRESHOLD
    cam = Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0, "cpu")
    rays = primary_rays(cam, 64, 16)
    got = tint.nearest_hit(rays.origin, rays.direction, scene)
    want = jint.nearest_hit(rays.origin.numpy(), rays.direction.numpy(), jscene)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-4, atol=0)
    assert got.hit.any() and not got.hit.all()
