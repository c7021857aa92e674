"""The PyTorch port's render path against the JAX package: the inline
integrator, the fused path's plain version, the Renderer's schedule and
reseeding, checkpoints in both directions, the CLI, image output and
metrics, and that importing the port leaves JAX out."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.render import integrator as jint
from haskell_path_tracer_tpu.render.renderer import Renderer as JaxRenderer
from haskell_path_tracer_tpu.utils import checkpoint as jckpt
from haskell_path_tracer_tpu.utils.config import RenderConfig as JaxConfig

from haskell_path_tracer_torch.models.convert import rng_to_numpy
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.render import integrator as tint
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils import checkpoint as tckpt
from haskell_path_tracer_torch.utils.config import RenderConfig

from torch_port_fixtures import H, W, jax_scene, lane_agreement, torch_camera, torch_scene

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_agree(acc, jacc):
    assert acc.iterations == int(jacc.iterations)
    rng_match, close, lit_close = lane_agreement(
        rng_to_numpy(acc.rng), jacc.rng, acc.color.numpy(), jacc.color
    )
    assert rng_match >= 0.995 and close >= 0.99 and lit_close >= 0.99, (
        rng_match, close, lit_close,
    )


@pytest.fixture(scope="module")
def jax_inline():
    """The JAX package's inline render of the glass scene: 2 spp, 6 bounces."""
    jscene, jcam = jax_scene("glass")
    return jint.render_batch_inline(
        jscene, jcam, J.make_accumulator(W, H, seed=4), 2, num_bounces=6
    )


@pytest.mark.parametrize("fn", ["render_batch_inline", "render_batch_auto", "render_batch_fused"])
def test_render_batch_matches_jax_inline(jax_inline, fn):
    jscene, jcam = jax_scene("glass")
    acc = getattr(tint, fn)(
        torch_scene(jscene), torch_camera(jcam),
        tint.make_accumulator(W, H, 4, "cpu"), 2, num_bounces=6,
    )
    _assert_agree(acc, jax_inline)


def test_render_sample_counts_one_and_fused_counts_spp():
    scene, cam = torch_scene(jax_scene("main")[0]), torch_camera(jax_scene("main")[1])
    acc = tint.make_accumulator(16, 4, 0, "cpu")
    assert tint.render_sample_inline(scene, cam, acc, num_bounces=2).iterations == 1
    assert tint.render_batch_fused(scene, cam, acc, 3, num_bounces=2).iterations == 3
    assert tint.render_batch_inline(scene, cam, acc, 3, num_bounces=2).iterations == 3


def test_renderer_schedule_matches_jax():
    ours = Renderer(RenderConfig(device="cpu"))
    theirs = JaxRenderer(JaxConfig())
    for it in list(range(0, 300)) + [999, 2000, 5000, 123456]:
        assert ours.batch_size(it) == theirs.batch_size(it)
    for prev, new in [(1999, 2000), (1900, 1999), (3990, 4030), (0, 1)]:
        assert ours.should_reseed(prev, new) == theirs.should_reseed(prev, new)


def test_renderer_render_matches_jax_with_reseeding():
    """8 samples with a reseed every 4: same iterations, the rng of the last
    reseed (seed + done) and the same image as the JAX Renderer."""
    jscene, jcam = jax_scene("glass")
    kw = dict(width=32, height=8, bounces=3, reseed_interval=4)
    jacc = JaxRenderer(JaxConfig(**kw)).render(jscene, jcam, 8, seed=5)
    renderer = Renderer(RenderConfig(device="cpu", **kw))
    acc = renderer.render(torch_scene(jscene), torch_camera(jcam), 8, seed=5)
    assert acc.iterations == int(jacc.iterations) == 8
    np.testing.assert_array_equal(
        rng_to_numpy(acc.rng), np.asarray(J.make_accumulator(32, 8, seed=13).rng)
    )
    _assert_agree(acc, jacc)
    img = renderer.image(acc)
    assert img.shape == (8, 32, 3) and np.isfinite(img).all()


def test_unported_algorithm_raises():
    """The stateless threefry sampler is still to port (ROADMAP); an
    algorithm the JAX package does not have is refused."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(RenderConfig(device="cpu", algorithm="physical", sampler="threefry"))
    with pytest.raises(ValueError, match="unknown algorithm"):
        Renderer(RenderConfig(device="cpu", algorithm="streams"))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "state.npz")
    jscene, jcam = jax_scene("main")
    acc = tint.render_batch_inline(
        torch_scene(jscene), torch_camera(jcam), tint.make_accumulator(16, 4, 1, "cpu"), 2,
        num_bounces=3,
    )
    if writer == "torch":
        tckpt.save_accumulator(path, acc, extra={"step": np.int32(7)})
        loaded, extra = jckpt.load_accumulator(path)
        assert np.asarray(loaded.rng).dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(loaded.rng), rng_to_numpy(acc.rng))
        np.testing.assert_array_equal(np.asarray(loaded.color), acc.color.numpy())
        assert int(loaded.iterations) == 2 and int(extra["step"]) == 7
    else:
        jacc = J.make_accumulator(16, 4, seed=1)
        jckpt.save_accumulator(path, jacc)
        loaded, _ = tckpt.load_accumulator(path, "cpu")
        assert loaded.rng.dtype == torch.int32 and loaded.iterations == 0
        np.testing.assert_array_equal(rng_to_numpy(loaded.rng), np.asarray(jacc.rng))
        np.testing.assert_array_equal(loaded.color.numpy(), np.asarray(jacc.color))
    with np.load(path) as z:
        assert z["rng"].dtype == np.uint32 and int(z["version"]) == tckpt.FORMAT_VERSION


def test_cli_writes_png_and_resumes(tmp_path):
    from haskell_path_tracer_torch.app.main import main

    out, ckpt = str(tmp_path / "out.png"), str(tmp_path / "state.npz")
    args = ["--device", "cpu", "--width", "64", "--height", "48", "--seed", "0",
            "--quiet", "--checkpoint", ckpt, "-o", out]
    assert main(args + ["--spp", "3"]) == 0
    blob = open(out, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and blob[16:24] == (64).to_bytes(4, "big") + (48).to_bytes(4, "big")
    assert main(args + ["--spp", "4", "--resume"]) == 0
    acc, _ = tckpt.load_accumulator(ckpt, "cpu")
    assert acc.iterations == 4
    assert MK.LAUNCHES == 0


def test_cli_kernel_cuda_on_cpu_raises(tmp_path):
    from haskell_path_tracer_torch.app.main import main

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        main(["--device", "cpu", "--kernel", "cuda", "--width", "8", "--height", "4",
              "--spp", "1", "--quiet", "-o", str(tmp_path / "x.png")])


def test_cli_save_scene_round_trips(tmp_path):
    from haskell_path_tracer_torch.app.main import main
    from haskell_path_tracer_tpu.models.io import load_scene

    path = str(tmp_path / "scene.json")
    assert main(["--device", "cpu", "--save-scene", path]) == 0
    scene, cam = load_scene(path)
    assert scene.spheres.count == 5 and cam is not None


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import haskell_path_tracer_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'haskell_path_tracer_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_image_output_matches_jax(tmp_path):
    """The vendored tonemap and PNG encoder give the JAX package's bytes,
    and save_render flips rows at the display boundary."""
    from haskell_path_tracer_tpu.utils import image as jimage
    from haskell_path_tracer_torch.utils import image as timage

    img = np.random.default_rng(5).gamma(1.0, 2.0, size=(12, 20, 3)).astype(np.float32)
    rgb8 = timage.tonemap(img, exposure=0.6, gamma=2.2)
    np.testing.assert_array_equal(rgb8, jimage.tonemap(img, exposure=0.6, gamma=2.2))
    assert timage.encode_png(rgb8) == jimage.encode_png(rgb8)
    path = str(tmp_path / "x.png")
    timage.save_render(path, img, exposure=0.6)
    assert open(path, "rb").read() == jimage.encode_png(jimage.tonemap(img[::-1], exposure=0.6))
    ppm = str(tmp_path / "x.ppm")
    timage.save_render(ppm, img)
    assert open(ppm, "rb").read().endswith(timage.tonemap(img[::-1]).tobytes())


def test_metrics_and_profiler_trace(tmp_path):
    import json

    from haskell_path_tracer_torch.utils import metrics as M

    m = M.RenderMetrics(width=4, height=2, bounces=3, samples=5, wall_seconds=2.0)
    with m.phase("render"):
        pass
    rec = json.loads(m.to_json())
    assert rec["rays_per_s"] == 60 and rec["resolution"] == "4x2" and "render" in rec["phases"]
    with M.profiler_trace(None):
        pass
    trace_dir = str(tmp_path / "prof")
    with M.profiler_trace(trace_dir):
        torch.ones(8).sum()
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
