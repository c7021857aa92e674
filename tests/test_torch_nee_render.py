"""The PyTorch port's physical/NEE render path on the CPU: accumulation,
the Renderer and the CLI, the tables and the plain probe and presort of
the NEE kernels, the golden file the CUDA kernel is held to on the card,
and the scenes the card renders.

Tolerance against the JAX package: `assert_lane_parity`
(tests/test_pallas_nee.py).  The plain probe and the presort are exact
(bit-identical images), as is accumulation over samples.
"""

import dataclasses

import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.ops.pallas_nee import scene_light_indices as jax_light_indices

from haskell_path_tracer_torch.models import scenes as S
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.convert import (
    rng_from_numpy, rng_to_numpy, scene_from_numpy, scene_to_numpy,
)
from haskell_path_tracer_torch.ops import intersect as tint
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.render import integrator as tint_render
from haskell_path_tracer_torch.render import nee as tnee
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils.config import RenderConfig

from test_pallas_nee import assert_lane_parity
from torch_port_fixtures import (
    NEE_CASES,
    NEE_GOLDEN_PATH,
    jax_nee_scene,
    jax_nee_trace,
    nee_golden_arrays,
    torch_camera,
    torch_rays,
    torch_scene,
)

torch.set_num_threads(2)
H, W = 16, 64


def _scene_cam(name):
    jscene, jcam = jax_nee_scene(name)
    return torch_scene(jscene), torch_camera(jcam)


def test_render_batch_equals_render_sample_steps():
    scene, cam = _scene_cam("tri")
    acc0 = tint_render.make_accumulator(W, H, 5, "cpu")
    batch = tnee.render_batch_physical(scene, cam, acc0, 3, num_bounces=3)
    steps = acc0
    for _ in range(3):
        steps = tnee.render_sample_physical(scene, cam, steps, num_bounces=3)
    assert batch.iterations == steps.iterations == 3
    assert torch.equal(batch.color, steps.color) and torch.equal(batch.rng, steps.rng)
    # On CPU tensors kernel="auto" is the plain loop; kernel="cuda" raises.
    NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
    auto = tnee.render_batch_physical(scene, cam, acc0, 3, num_bounces=3, kernel="auto")
    assert torch.equal(auto.color, batch.color)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tnee.render_batch_physical(scene, cam, acc0, 1, kernel="cuda")
    assert NE.LAUNCHES == {"nee_megakernel": 0, "primary_probe": 0}


def test_renderer_physical_matches_render_batch():
    scene, cam = _scene_cam("box_tri")
    config = RenderConfig(width=W, height=H, algorithm="physical", kernel="torch",
                          bounces=3, device="cpu", reseed_interval=1000)
    renderer = Renderer(config)
    acc = renderer.render(scene, cam, 4, seed=2)
    want = tnee.render_batch_physical(
        scene, cam, tint_render.make_accumulator(W, H, 2, "cpu"), 4, num_bounces=3)
    assert acc.iterations == 4
    assert torch.equal(acc.color, want.color) and torch.equal(acc.rng, want.rng)
    img = renderer.image(acc)
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.max() > 0
    # nee=False is the BSDF-sampling estimator: another image.
    no_nee = Renderer(config.replace(nee=False)).render(scene, cam, 4, seed=2)
    assert not torch.equal(no_nee.color, acc.color)


def test_cli_physical_writes_png(tmp_path):
    from haskell_path_tracer_torch.app.main import main
    from haskell_path_tracer_torch.utils.checkpoint import load_accumulator

    out, ckpt = str(tmp_path / "phys.png"), str(tmp_path / "state.npz")
    NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
    assert main(["--variant", "physical", "--device", "cpu", "--kernel", "torch", "--width", "32",
                 "--height", "16", "--spp", "2", "--bounces", "3", "--seed", "0", "--quiet",
                 "--checkpoint", ckpt, "-o", out]) == 0
    blob = open(out, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and blob[16:24] == (32).to_bytes(4, "big") + (16).to_bytes(4, "big")
    acc, _ = load_accumulator(ckpt, "cpu")
    assert acc.iterations == 2 and acc.color.abs().max() > 0
    assert NE.LAUNCHES["nee_megakernel"] == 0


def test_plain_probe_and_presort_are_exact():
    """The plain probe is the eps = 0 fold, and the plain version run on
    the lanes in presort order gives the same image bit for bit."""
    scene, cam = _scene_cam("big200")
    rays = primary_rays(cam, W, H)
    t0, prim0 = NE.primary_probe(NE.nee_scene_tables(scene), rays)
    t, prim = tint.nearest_t_prim(rays.origin, rays.direction, scene, 0.0)
    assert prim0.dtype == torch.int32 and torch.equal(prim0, prim.to(torch.int32))
    assert torch.equal(t0, t) and 0.05 < (t0 < tint.INFINITE).double().mean() < 0.95
    rng = tint_render.make_accumulator(W, H, 3, "cpu").rng
    raster = NE.trace_physical_nee(scene, rays, rng, 3, 2, presort=False, telemetry=True)
    sorted_ = NE.trace_physical_nee(scene, rays, rng, 3, 2, presort=True, telemetry=True)
    for a, b in zip(raster, sorted_):
        assert torch.equal(a, b)
    # Telemetry counts the live bounces: a sky lane has none.
    assert (raster[2][t0 >= tint.INFINITE] == 0).all() and raster[2].max() <= 2 * 3


def test_probe_refuses_unaligned_table():
    """The probe kernel copies sphere rows 16 bytes at a time: its launcher
    refuses a fold table that does not start on a 16-byte boundary, before
    it builds or launches anything."""
    scene, cam = _scene_cam("big200")
    tables = NE.nee_scene_tables(scene)
    shifted = torch.cat([tables.fold.new_zeros(1), tables.fold])[1:]
    assert shifted.data_ptr() % 16 and torch.equal(shifted, tables.fold)
    with pytest.raises(ValueError, match="16-byte"):
        NE.launch_probe(dataclasses.replace(tables, fold=shifted), primary_rays(cam, W, H))
    assert NE.LAUNCHES["primary_probe"] == 0


@pytest.mark.parametrize("name", ["cornell8", "tri", "box_tri", "zero_light"])
def test_tables_and_light_indices(name):
    """The emitters' index tuple is the JAX package's, and the tables hold
    each emitter's row at its global primitive index."""
    jscene, _ = jax_nee_scene(name)
    scene = torch_scene(jscene)
    li = NE.scene_light_indices(scene)
    assert li == jax_light_indices(jscene)
    tables = NE.nee_scene_tables(scene)
    ns, npl, nb, nt = tables.counts
    assert tables.num_lights == len(li)
    assert tables.fold.shape == (4 * ns + 8 * npl + 8 * nb + 12 * nt,)
    for row, i in zip(tables.lights.tolist(), li):
        is_tri = i >= ns
        assert row[0] == float(is_tri)
        part = scene.triangles if is_tri else scene.spheres
        k = i - ns if is_tri else i
        assert row[1] == (ns + npl + nb + k if is_tri else i)
        assert row[2:5] == (part.material.color[k] * part.material.illuminance[k]).tolist()
        assert row[5:8] == (part.v0[k] if is_tri else part.pos[k]).tolist()
    # The carry-over keeps every kind and its materials.
    arrays = scene_to_numpy(scene)
    for k, v in scene_to_numpy(jscene).items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)


def _golden_case(z, case):
    prefix = f"{case}__scene__"
    scene = scene_from_numpy({k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}, "cpu")
    return scene, {k: z[f"{case}__{k}"] for k in
                   ("origin", "direction", "rng_in", "light_idx", "radiance", "rng_out", "config")}


def test_nee_golden_file_is_current():
    """Recomputed from the JAX package's XLA estimator, the NEE golden file
    is unchanged."""
    want = nee_golden_arrays({case: jax_nee_trace(case) for case in NEE_CASES})
    with np.load(NEE_GOLDEN_PATH) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)


@pytest.mark.parametrize("case", list(NEE_CASES))
def test_reference_matches_nee_golden_file(case):
    with np.load(NEE_GOLDEN_PATH) as z:
        scene, inp = _golden_case(z, case)
    spp, bounces = inp["config"].tolist()
    assert NE.scene_light_indices(scene) == tuple(inp["light_idx"].tolist())
    rad, rng = NE.trace_physical_nee_reference(
        scene, torch_rays(inp), rng_from_numpy(inp["rng_in"], "cpu"), bounces, spp)
    assert_lane_parity(inp["rng_out"], rng_to_numpy(rng), inp["radiance"], rad.numpy())
    assert np.abs(inp["radiance"]).max() > 0


def _suite_config(n):
    """The (scene, camera) that benchmarks/suite.py's config n renders,
    taken from the step it builds, without running it."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
    import suite

    class Captured(Exception):
        pass

    def capture(step, state, k, n=2):
        raise Captured(step)

    orig, suite._pipeline = suite._pipeline, capture
    try:
        getattr(suite, f"config{n}")()
    except Captured as e:
        cells = dict(zip(e.args[0].__code__.co_freevars, (c.cell_contents for c in e.args[0].__closure__)))
    finally:
        suite._pipeline = orig
    return cells["scene"], cells["cam"]


@pytest.mark.parametrize("config,builder", [(6, "cornell_scene"), (4, "big_scene"), (8, "tri_emitter_scene")])
def test_card_scenes_equal_the_suite(config, builder):
    jscene, jcam = _suite_config(config)
    got = scene_to_numpy(getattr(S, builder)("cpu"))
    want = scene_to_numpy(jscene)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    cam = torch_camera(jcam)
    assert cam.fov.item() == 90.0
    if config == 4:
        assert cam.position.tolist() == [0.0, 2.0, 0.0] and jscene.spheres.count == 1000
    else:
        assert cam.position.tolist() == J.initial_camera().position.tolist()


@pytest.mark.parametrize("name,builder", [
    ("glassy", "glassy_scene"), ("zero_light", "zero_light_scene"), ("box_tri", "box_tri_scene"),
])
def test_card_scenes_equal_the_kernel_tests(name, builder):
    got = scene_to_numpy(getattr(S, builder)("cpu"))
    for k, v in scene_to_numpy(jax_nee_scene(name)[0]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
