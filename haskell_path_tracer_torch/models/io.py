"""Scene serialization: the JSON schema of ``haskell_path_tracer_tpu/models/io.py``,
so one scene file loads in both packages."""

from __future__ import annotations

import json

from .convert import to_numpy
from .objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Camera,
    Scene,
    make_boxes,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)

_KIND_NAMES = {BRDF_MATTE: "matte", BRDF_GLOSSY: "glossy", BRDF_DIELECTRIC: "dielectric"}
_KIND_IDS = {v: k for k, v in _KIND_NAMES.items()}


def _material_to_dict(m, i):
    return {
        "color": to_numpy(m.color[i]).tolist(),
        "illuminance": float(m.illuminance[i]),
        "brdf": _KIND_NAMES[int(m.brdf_kind[i])],
        "param": float(m.brdf_param[i]),
    }


def scene_to_dict(scene: Scene, camera: Camera | None = None) -> dict:
    d = {
        "spheres": [
            {
                "position": to_numpy(scene.spheres.pos[i]).tolist(),
                "radius": float(scene.spheres.radius[i]),
                "material": _material_to_dict(scene.spheres.material, i),
            }
            for i in range(scene.spheres.count)
        ],
        "planes": [
            {
                "position": to_numpy(scene.planes.pos[i]).tolist(),
                "normal": to_numpy(scene.planes.normal[i]).tolist(),
                "material": _material_to_dict(scene.planes.material, i),
            }
            for i in range(scene.planes.count)
        ],
    }
    if scene.boxes.count:
        d["boxes"] = [
            {
                "lo": to_numpy(scene.boxes.lo[i]).tolist(),
                "hi": to_numpy(scene.boxes.hi[i]).tolist(),
                "material": _material_to_dict(scene.boxes.material, i),
            }
            for i in range(scene.boxes.count)
        ]
    if scene.triangles.count:
        d["triangles"] = [
            {
                "vertices": [
                    to_numpy(scene.triangles.v0[i]).tolist(),
                    to_numpy(scene.triangles.v1[i]).tolist(),
                    to_numpy(scene.triangles.v2[i]).tolist(),
                ],
                "material": _material_to_dict(scene.triangles.material, i),
            }
            for i in range(scene.triangles.count)
        ]
    if camera is not None:
        d["camera"] = {
            "position": to_numpy(camera.position).tolist(),
            "rotation": to_numpy(camera.rotation).tolist(),
            "fov": float(to_numpy(camera.fov)),
        }
    return d


def scene_from_dict(d: dict, device):
    """Returns (scene, camera_or_None) on `device`."""

    def mats(entries):
        return make_materials(
            [
                (
                    e["material"]["color"],
                    e["material"]["illuminance"],
                    _KIND_IDS[e["material"]["brdf"]],
                    e["material"]["param"],
                )
                for e in entries
            ],
            device,
        )

    spheres = make_spheres(
        [s["position"] for s in d["spheres"]],
        [s["radius"] for s in d["spheres"]],
        mats(d["spheres"]),
        device,
    )
    planes = make_planes(
        [p["position"] for p in d["planes"]],
        [p["normal"] for p in d["planes"]],
        mats(d["planes"]),
        device,
    )
    extra = {}
    if d.get("boxes"):
        extra["boxes"] = make_boxes(
            [b["lo"] for b in d["boxes"]],
            [b["hi"] for b in d["boxes"]],
            mats(d["boxes"]),
            device,
        )
    if d.get("triangles"):
        extra["triangles"] = make_triangles(
            [t["vertices"][0] for t in d["triangles"]],
            [t["vertices"][1] for t in d["triangles"]],
            [t["vertices"][2] for t in d["triangles"]],
            mats(d["triangles"]),
            device,
        )
    camera = None
    if "camera" in d:
        c = d["camera"]
        camera = Camera.create(c["position"], c["rotation"], c["fov"], device)
    return Scene(spheres=spheres, planes=planes, **extra), camera


def save_scene(path: str, scene: Scene, camera: Camera | None = None) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene, camera), f, indent=2)


def load_scene(path: str, device):
    with open(path) as f:
        return scene_from_dict(json.load(f), device)
