"""The PyTorch port's scene layer against the JAX package: vector math, the
data model and its numpy conversion, primary rays, JSON scenes and the
megakernel's table packing."""

import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.core import linalg as jlinalg
from haskell_path_tracer_tpu.models import io as jio
from haskell_path_tracer_tpu.models.camera import primary_rays as jrays
from haskell_path_tracer_tpu.ops.pallas_megakernel import _scene_tables

import haskell_path_tracer_torch as T
from haskell_path_tracer_torch.core import linalg as tlinalg
from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models import io as tio
from haskell_path_tracer_torch.ops.megakernel import scene_tables

from torch_port_fixtures import jax_scene, torch_camera, torch_scene

torch.set_num_threads(2)


def _v(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def test_linalg_matches_jax():
    a, b = _v(257, 0), _v(257, 1)
    a[0] = 0.0  # a zero vector through normalize_safe
    angles = _v(257, 2)
    ta, tb, tang = map(torch.as_tensor, (a, b, angles))
    pairs = [
        (tlinalg.dot(ta, tb), jlinalg.dot(a, b)),
        (tlinalg.cross(ta, tb), jlinalg.cross(a, b)),
        (tlinalg.normalize_safe(ta), jlinalg.normalize_safe(a)),
        (tlinalg.near_zero(ta * 1e-4), jlinalg.near_zero(a * np.float32(1e-4))),
        (tlinalg.angles_to_quaternion(tang), jlinalg.angles_to_quaternion(angles)),
        (
            tlinalg.quat_rotate(tlinalg.angles_to_quaternion(tang), tb),
            jlinalg.quat_rotate(jlinalg.angles_to_quaternion(angles), b),
        ),
        (tlinalg.angles_to_direction(tang), jlinalg.angles_to_direction(angles)),
        (tlinalg.reflect(ta, tb), jlinalg.reflect(a, b)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["main", "mixed"])
def test_convert_round_trips(name):
    jscene, jcam = jax_scene(name)
    arrays = C.scene_to_numpy(jscene)
    scene = C.scene_from_numpy(arrays, "cpu")
    back = C.scene_to_numpy(scene)
    assert back.keys() == arrays.keys()
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert scene.num_primitives == jscene.num_primitives
    cam = C.camera_to_numpy(C.camera_from_numpy(C.camera_to_numpy(jcam), "cpu"))
    for k, v in C.camera_to_numpy(jcam).items():
        np.testing.assert_array_equal(cam[k], v)

    jacc = J.make_accumulator(16, 4, seed=3)
    acc = C.accumulator_from_numpy(C.accumulator_to_numpy(jacc), "cpu")
    assert acc.rng.dtype == torch.int32 and acc.iterations == 0
    np.testing.assert_array_equal(C.rng_to_numpy(acc.rng), np.asarray(jacc.rng))
    np.testing.assert_array_equal(C.accumulator_to_numpy(acc)["rng"], np.asarray(jacc.rng))


def test_to_device_keeps_every_field():
    scene = T.main_scene("cpu").to("cpu")
    assert scene.boxes.count == 0 and scene.triangles.count == 0
    assert scene.device == torch.device("cpu")
    np.testing.assert_array_equal(
        C.scene_to_numpy(scene)["spheres.pos"], np.asarray(J.main_scene().spheres.pos)
    )


def test_world_matches_jax():
    for k, v in C.scene_to_numpy(J.main_scene()).items():
        np.testing.assert_array_equal(C.scene_to_numpy(T.main_scene("cpu"))[k], v, err_msg=k)
    for k, v in C.camera_to_numpy(J.initial_camera()).items():
        np.testing.assert_array_equal(C.camera_to_numpy(T.initial_camera("cpu"))[k], v)


@pytest.mark.parametrize(
    "width,height,row_offset,full_height",
    [(128, 16, 0, None), (64, 8, 24, 48), (40, 30, 0, None)],
)
def test_primary_rays_match_jax(width, height, row_offset, full_height):
    jcam = J.initial_camera()
    want = jrays(jcam, width, height, row_offset, full_height)
    got = T.primary_rays(torch_camera(jcam), width, height, row_offset, full_height)
    assert got.origin.is_contiguous() and got.direction.is_contiguous()
    np.testing.assert_allclose(got.origin.numpy(), np.asarray(want.origin), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.direction.numpy(), np.asarray(want.direction), rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_json_scene_loads_in_both_packages(tmp_path, writer):
    jscene, jcam = jax_scene("mixed")
    path = str(tmp_path / "scene.json")
    if writer == "jax":
        jio.save_scene(path, jscene, jcam)
    else:
        tio.save_scene(path, torch_scene(jscene), torch_camera(jcam))
    js2, jc2 = jio.load_scene(path)
    ts2, tc2 = tio.load_scene(path, "cpu")
    for k, v in C.scene_to_numpy(js2).items():
        np.testing.assert_array_equal(C.scene_to_numpy(ts2)[k], v, err_msg=k)
        np.testing.assert_array_equal(C.scene_to_numpy(jscene)[k], v, err_msg=k)
    for k, v in C.camera_to_numpy(jc2).items():
        np.testing.assert_array_equal(C.camera_to_numpy(tc2)[k], v)
    assert tio.scene_to_dict(ts2, tc2) == jio.scene_to_dict(js2, jc2)


@pytest.mark.parametrize("name", ["main", "mixed", "glass"])
def test_scene_tables_match_jax(name):
    jscene, _ = jax_scene(name)
    geom, mat = scene_tables(torch_scene(jscene))
    jgeom, jmat = _scene_tables(jscene)
    assert geom.shape == jgeom.shape and mat.shape == (jscene.num_primitives, 8)
    np.testing.assert_array_equal(geom.numpy(), np.asarray(jgeom))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
