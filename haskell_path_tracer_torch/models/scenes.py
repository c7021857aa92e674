"""The physical/NEE test and benchmark scenes, built from numpy seeds.

Each builder makes the same arrays as its source in the repository, so a
machine without JAX renders the scenes the JAX package is measured on:

  * `cornell_scene`, `big_scene` — ``benchmarks/suite.py``'s scenes of
    configs 2, 4, 6 and 7 (8 spheres and two planes; n spheres scattered
    over a 60 x 12.5 x 52 box with ~1% emitters and a floor);
  * `tri_emitter_scene` — config 8's: the Cornell scene plus two ceiling
    light triangles and two blocker triangles;
  * `glassy_scene`, `zero_light_scene`, `box_tri_scene` — the scenes of
    ``tests/test_pallas_nee.py`` that cover dielectrics, a scene with no
    NEE emitter (lit by an emissive plane) and all four kinds with three
    emitter classes.
"""

from __future__ import annotations

import numpy as np

from .objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Scene,
    make_boxes,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)


def cornell_scene(device) -> Scene:
    rng = np.random.default_rng(0)
    pos = rng.uniform([-3, -2, -8], [3, 2, -4], (8, 3))
    mats = make_materials(
        [
            (rng.uniform(0.2, 0.9, 3).tolist(), 30.0 if i == 0 else 0.0,
             BRDF_GLOSSY if i % 3 == 2 else BRDF_MATTE, 0.9)
            for i in range(8)
        ],
        device,
    )
    spheres = make_spheres(pos, rng.uniform(0.4, 1.0, 8), mats, device)
    planes = make_planes(
        [[0, -3, 0], [0, 8, 0]],
        [[0, 1, 0], [0, -1, 0]],
        make_materials(
            [([0.7, 0.7, 0.7], 0.0, BRDF_MATTE, 1.2), ([0.8, 0.8, 0.8], 0.0, BRDF_MATTE, 1.0)],
            device,
        ),
        device,
    )
    return Scene(spheres=spheres, planes=planes)


def big_scene(device, n: int = 1000) -> Scene:
    """n matte spheres, about 1% of them emitters (illuminance 50)."""
    rng = np.random.default_rng(7)
    pos = rng.uniform([-30, -2.5, -60], [30, 10, -8], (n, 3))
    radius = rng.uniform(0.2, 0.9, n)
    illum = np.where(rng.random(n) < 0.01, 50.0, 0.0)
    # One draw of 3n values is the stream of n draws of 3.
    color = rng.uniform(0.2, 0.9, (n, 3))
    mats = make_materials(
        [(color[i], float(illum[i]), BRDF_MATTE, 1.0) for i in range(n)], device
    )
    planes = make_planes(
        [[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.6], 0.0, BRDF_MATTE, 1.0)], device), device,
    )
    return Scene(spheres=make_spheres(pos, radius, mats, device), planes=planes)


def tri_emitter_scene(device) -> Scene:
    base = cornell_scene(device)
    tris = make_triangles(
        [[-2.5, 7.5, -9.0], [2.5, 7.5, -5.0], [-1.5, 0.0, -6.0], [1.0, -1.0, -4.5]],
        [[2.5, 7.5, -9.0], [-2.5, 7.5, -5.0], [-0.5, 0.0, -6.5], [2.0, -1.0, -5.0]],
        [[0.0, 7.5, -5.0], [0.0, 7.5, -9.0], [-1.0, 1.5, -6.2], [1.5, 0.2, -4.7]],
        make_materials(
            [([1.0, 0.95, 0.8], 18.0, BRDF_MATTE, 1.0), ([0.9, 0.9, 1.0], 12.0, BRDF_MATTE, 1.0),
             ([0.5, 0.5, 0.8], 0.0, BRDF_MATTE, 1.0), ([0.8, 0.6, 0.4], 0.0, BRDF_MATTE, 1.0)],
            device,
        ),
        device,
    )
    return Scene(spheres=base.spheres, planes=base.planes, triangles=tris)


def glassy_scene(device) -> Scene:
    spheres = make_spheres(
        [[0.0, 0.0, -4.0], [1.8, 0.5, -6.0], [-2.0, 1.0, -5.0]],
        [1.3, 0.9, 0.7],
        make_materials(
            [([0.97, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, 1.5),
             ([0.9, 0.95, 1.0], 0.0, BRDF_DIELECTRIC, 1.33),
             ([1.0, 0.9, 0.7], 8.0, BRDF_MATTE, 1.0)],
            device,
        ),
        device,
    )
    planes = make_planes(
        [[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
        make_materials([([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2)], device), device,
    )
    return Scene(spheres=spheres, planes=planes)


def zero_light_scene(device) -> Scene:
    spheres = make_spheres(
        [[0.0, 0.0, -5.0], [1.5, 0.8, -4.0]],
        [1.2, 0.6],
        make_materials(
            [([0.8, 0.4, 0.3], 0.0, BRDF_MATTE, 1.0), ([0.4, 0.8, 0.5], 0.0, BRDF_GLOSSY, 1.0)],
            device,
        ),
        device,
    )
    planes = make_planes(
        [[0.0, -3.0, 0.0], [0.0, 9.0, 0.0]],
        [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]],
        make_materials(
            [([0.7, 0.7, 0.7], 0.0, BRDF_MATTE, 1.0), ([1.0, 1.0, 0.9], 4.0, BRDF_MATTE, 1.0)],
            device,
        ),
        device,
    )
    return Scene(spheres=spheres, planes=planes)


def box_tri_scene(device) -> Scene:
    spheres = make_spheres(
        [[0.0, -1.0, -6.0], [2.5, 0.8, -7.0]], [1.6, 0.9],
        make_materials(
            [([0.8, 0.4, 0.3], 0.0, BRDF_MATTE, 1.0), ([0.9, 0.8, 0.2], 12.0, BRDF_MATTE, 1.0)],
            device,
        ),
        device,
    )
    planes = make_planes(
        [[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.55], 0.0, BRDF_MATTE, 1.0)], device), device,
    )
    boxes = make_boxes(
        [[-3.0, -2.0, -7.5], [0.5, 2.0, -5.5]],
        [[-1.5, 0.5, -6.0], [1.5, 3.0, -4.8]],
        make_materials(
            [([0.5, 0.7, 0.9], 0.0, BRDF_GLOSSY, 1.0), ([1.0, 0.9, 0.7], 8.0, BRDF_MATTE, 1.0)],
            device,
        ),
        device,
    )
    tris = make_triangles(
        [[-1.0, 4.0, -7.0]], [[1.0, 4.0, -7.0]], [[0.0, 4.0, -5.0]],
        make_materials([([1.0, 1.0, 0.9], 15.0, BRDF_MATTE, 1.0)], device), device,
    )
    return Scene(spheres=spheres, planes=planes, boxes=boxes, triangles=tris)
