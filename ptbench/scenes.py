"""The configurations' scenes as numpy arrays, made from the configuration's
file alone.

Two forms:
  * "primitives": spheres and planes listed one by one;
  * "scattered_spheres": n spheres drawn from a numpy PCG64 stream in the
    order of `benchmarks/suite.py:big_scene` (positions in a box, radii,
    the emitter draw, colours), one material for all, and a floor plane.
The arrays (`FIELDS` and the kind tags of `reference/core.py`) go to the
program through its scene constructors (`loops/common.py`) and to the
reference as they are.
"""

from __future__ import annotations

import numpy as np

BRDFS = {"matte": 0, "glossy": 1, "dielectric": 2}


def _materials(items):
    return (np.array([m["color"] for m in items], np.float32).reshape(-1, 3),
            np.array([m["illuminance"] for m in items], np.float32),
            np.array([BRDFS[m["brdf"]] for m in items], np.int32),
            np.array([m["param"] for m in items], np.float32))


def _planes(planes):
    color, illum, kind, param = _materials(planes)
    return {"plane_pos": np.array([p["pos"] for p in planes], np.float32).reshape(-1, 3),
            "plane_normal": np.array([p["normal"] for p in planes], np.float32).reshape(-1, 3),
            "plane_color": color, "plane_illum": illum, "plane_kind": kind, "plane_param": param}


def build(spec: dict) -> dict:
    """The scene's arrays from the configuration's "scene" entry."""
    if spec["form"] == "primitives":
        spheres = spec["spheres"]
        color, illum, kind, param = _materials(spheres)
        out = {"sphere_pos": np.array([s["pos"] for s in spheres], np.float32).reshape(-1, 3),
               "sphere_radius": np.array([s["radius"] for s in spheres], np.float32),
               "sphere_color": color, "sphere_illum": illum, "sphere_kind": kind,
               "sphere_param": param}
    elif spec["form"] == "scattered_spheres":
        n = spec["count"]
        rng = np.random.default_rng(spec["seed"])
        pos = rng.uniform(spec["box_lo"], spec["box_hi"], (n, 3))
        radius = rng.uniform(*spec["radius"], n)
        illum = np.where(rng.random(n) < spec["emitter_share"], spec["emitter_illuminance"], 0.0)
        color = rng.uniform(*spec["color"], (n, 3))
        out = {"sphere_pos": pos.astype(np.float32), "sphere_radius": radius.astype(np.float32),
               "sphere_color": color.astype(np.float32), "sphere_illum": illum.astype(np.float32),
               "sphere_kind": np.full(n, BRDFS[spec["brdf"]], np.int32),
               "sphere_param": np.full(n, spec["param"], np.float32)}
    else:
        raise ValueError(f"unknown scene form {spec['form']!r}")
    out.update(_planes(spec["planes"]))
    return out
