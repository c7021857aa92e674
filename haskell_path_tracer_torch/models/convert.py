"""State carried across from the JAX package as plain numpy arrays.

A scene, camera or accumulator is flattened to a dict of numpy arrays
keyed by field path ("spheres.pos", "planes.material.color", ...).  The
``*_to_numpy`` functions read any object with this package's field layout,
which the JAX package's pytrees share, so a JAX scene converts with
``scene_to_numpy(jax_scene)`` without this package importing JAX.

The SFC32 state is uint32 in numpy (and in the JAX package) and int32
holding the same bits in torch; the conversions are views, not casts.

Scene parameters for inverse rendering (`diff/grad.py:SceneParams`) cross
as a dict of numpy arrays keyed by field name, or as any named tuple with
the same fields, as the JAX package's `SceneParams` is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..diff.grad import SceneParams
from .objects import (
    Accumulator,
    Boxes,
    Camera,
    Materials,
    Planes,
    Scene,
    Spheres,
    Triangles,
)

_KINDS = (
    ("spheres", Spheres, ("pos", "radius")),
    ("planes", Planes, ("pos", "normal")),
    ("boxes", Boxes, ("lo", "hi")),
    ("triangles", Triangles, ("v0", "v1", "v2")),
)
_MATERIAL_FIELDS = ("color", "illuminance", "brdf_kind", "brdf_param")
_CAMERA_FIELDS = ("position", "rotation", "fov")


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype), device=device)


def scene_to_numpy(scene) -> dict:
    out = {}
    for kind, _, fields in _KINDS:
        part = getattr(scene, kind)
        for f in fields:
            out[f"{kind}.{f}"] = to_numpy(getattr(part, f)).astype(np.float32)
        for f in _MATERIAL_FIELDS:
            out[f"{kind}.material.{f}"] = to_numpy(getattr(part.material, f))
    return out


def scene_from_numpy(arrays: dict, device) -> Scene:
    parts = {}
    for kind, cls, fields in _KINDS:
        mat = Materials(
            color=_tensor(arrays[f"{kind}.material.color"], np.float32, device),
            illuminance=_tensor(
                arrays[f"{kind}.material.illuminance"], np.float32, device
            ),
            brdf_kind=_tensor(
                arrays[f"{kind}.material.brdf_kind"], np.int32, device
            ),
            brdf_param=_tensor(
                arrays[f"{kind}.material.brdf_param"], np.float32, device
            ),
        )
        geo = {
            f: _tensor(arrays[f"{kind}.{f}"], np.float32, device)
            for f in fields
        }
        parts[kind] = cls(material=mat, **geo)
    return Scene(**parts)


def camera_to_numpy(camera) -> dict:
    return {f: to_numpy(getattr(camera, f)).astype(np.float32) for f in _CAMERA_FIELDS}


def camera_from_numpy(arrays: dict, device) -> Camera:
    return Camera(
        **{f: _tensor(arrays[f], np.float32, device) for f in _CAMERA_FIELDS}
    )


def rng_to_numpy(rng: torch.Tensor) -> np.ndarray:
    """SFC32 words (int32 bits from torch, or uint32) -> uint32."""
    a = to_numpy(rng)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def rng_from_numpy(rng, device) -> torch.Tensor:
    """uint32 SFC32 words -> the same bits as an int32 tensor."""
    a = np.array(rng, np.uint32).view(np.int32)
    return torch.as_tensor(a, device=device)


def accumulator_to_numpy(acc) -> dict:
    return {
        "color": to_numpy(acc.color).astype(np.float32),
        "rng": rng_to_numpy(acc.rng),
        "iterations": np.int32(int(acc.iterations)),
    }


def accumulator_from_numpy(arrays: dict, device) -> Accumulator:
    return Accumulator(
        color=_tensor(arrays["color"], np.float32, device),
        rng=rng_from_numpy(arrays["rng"], device),
        iterations=int(arrays["iterations"]),
    )


def params_to_numpy(params) -> dict:
    """SceneParams (this package's or the JAX package's) -> {field: f32}."""
    return {f: to_numpy(getattr(params, f)).astype(np.float32) for f in SceneParams._fields}


def params_from_numpy(arrays, device):
    """{field: array} or a named tuple with SceneParams' fields ->
    this package's SceneParams of f32 tensors on `device`."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    return SceneParams(
        *(_tensor(to_numpy(arrays[f]), np.float32, device) for f in SceneParams._fields)
    )
