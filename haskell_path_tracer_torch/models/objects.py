"""Scene data model as structure-of-arrays dataclasses of tensors.

Counterpart of ``haskell_path_tracer_tpu/models/objects.py``.  Each
primitive kind is a batch of per-field tensors; primitive index order is
spheres ++ planes ++ boxes ++ triangles, the same contract the JAX package
keeps, so nearest-hit ties and primitive indices agree between the two.

Every class is a frozen dataclass with ``.to(device)``.  The ``make_*``
functions take an explicit ``device``: nothing here picks a device on its own.

``Accumulator.rng`` is int32 ``[H, W, 4]`` holding the SFC32 words' uint32
bit patterns (torch has no uint32 arithmetic on the CPU; see ``ops/rng.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# BRDF kind tags (the reference's `Brdf` sum type, plus the dielectric
# extension of the JAX package).
BRDF_MATTE = 0
BRDF_GLOSSY = 1
BRDF_DIELECTRIC = 2


def _to(obj, device):
    """Move every tensor field (recursively through nested dataclasses)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = v.to(device)
    return dataclasses.replace(obj, **changes)


@dataclass(frozen=True)
class Materials:
    """SoA material batch.

    color        [N, 3] f32 — albedo
    illuminance  [N]    f32 — emission scale (emittance = color * illuminance)
    brdf_kind    [N]    i32 — BRDF_MATTE / BRDF_GLOSSY / BRDF_DIELECTRIC
    brdf_param   [N]    f32 — Matte/Glossy parameter, or the dielectric's IOR
    """

    color: torch.Tensor
    illuminance: torch.Tensor
    brdf_kind: torch.Tensor
    brdf_param: torch.Tensor

    @property
    def count(self) -> int:
        return self.color.shape[0]

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclass(frozen=True)
class Spheres:
    pos: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    material: Materials

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "Spheres":
        return _to(self, device)


@dataclass(frozen=True)
class Planes:
    """One-sided infinite planes: only rays travelling against `normal` hit."""

    pos: torch.Tensor  # [M, 3]
    normal: torch.Tensor  # [M, 3]
    material: Materials

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "Planes":
        return _to(self, device)


@dataclass(frozen=True)
class Boxes:
    """Axis-aligned boxes; only entry faces hit."""

    lo: torch.Tensor  # [N, 3] min corner
    hi: torch.Tensor  # [N, 3] max corner
    material: Materials

    @property
    def count(self) -> int:
        return self.lo.shape[0]

    def to(self, device) -> "Boxes":
        return _to(self, device)


@dataclass(frozen=True)
class Triangles:
    """Triangles, one-sided: the front face is where
    normalize(cross(v1 - v0, v2 - v0)) points."""

    v0: torch.Tensor  # [N, 3]
    v1: torch.Tensor  # [N, 3]
    v2: torch.Tensor  # [N, 3]
    material: Materials

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    def to(self, device) -> "Triangles":
        return _to(self, device)


def empty_materials(device) -> Materials:
    return Materials(
        color=torch.zeros((0, 3), dtype=torch.float32, device=device),
        illuminance=torch.zeros((0,), dtype=torch.float32, device=device),
        brdf_kind=torch.zeros((0,), dtype=torch.int32, device=device),
        brdf_param=torch.zeros((0,), dtype=torch.float32, device=device),
    )


def empty_boxes(device) -> Boxes:
    z = torch.zeros((0, 3), dtype=torch.float32, device=device)
    return Boxes(lo=z, hi=z.clone(), material=empty_materials(device))


def empty_triangles(device) -> Triangles:
    z = torch.zeros((0, 3), dtype=torch.float32, device=device)
    return Triangles(
        v0=z, v1=z.clone(), v2=z.clone(), material=empty_materials(device)
    )


@dataclass(frozen=True)
class Scene:
    """Sphere and plane batches, plus optional boxes and triangles.

    Primitive index order is spheres ++ planes ++ boxes ++ triangles.
    Omitted boxes/triangles become empty batches on the spheres' device.
    """

    spheres: Spheres
    planes: Planes
    boxes: Optional[Boxes] = None
    triangles: Optional[Triangles] = None

    def __post_init__(self):
        device = self.spheres.pos.device
        if self.boxes is None:
            object.__setattr__(self, "boxes", empty_boxes(device))
        if self.triangles is None:
            object.__setattr__(self, "triangles", empty_triangles(device))

    @property
    def num_primitives(self) -> int:
        return (
            self.spheres.count
            + self.planes.count
            + self.boxes.count
            + self.triangles.count
        )

    @property
    def device(self) -> torch.device:
        return self.spheres.pos.device

    def has_dielectric(self) -> bool:
        """Whether any primitive is glass (reads the kinds back to the host)."""
        return any(
            bool((part.material.brdf_kind == BRDF_DIELECTRIC).any())
            for part in (self.spheres, self.planes, self.boxes, self.triangles)
            if part.count
        )

    def to(self, device) -> "Scene":
        return _to(self, device)


@dataclass(frozen=True)
class Camera:
    """Pinhole camera: position, Euler rotation (roll, pitch, yaw), vertical
    FOV in degrees."""

    position: torch.Tensor  # [3] f32
    rotation: torch.Tensor  # [3] f32
    fov: torch.Tensor  # [] f32, degrees

    @staticmethod
    def create(position, rotation, fov, device) -> "Camera":
        f32 = dict(dtype=torch.float32, device=device)
        return Camera(
            position=torch.as_tensor(np.asarray(position, np.float32), **f32),
            rotation=torch.as_tensor(np.asarray(rotation, np.float32), **f32),
            fov=torch.as_tensor(np.asarray(fov, np.float32), **f32),
        )

    def to(self, device) -> "Camera":
        return _to(self, device)


@dataclass(frozen=True)
class Rays:
    origin: torch.Tensor  # [..., 3]
    direction: torch.Tensor  # [..., 3]

    def to(self, device) -> "Rays":
        return _to(self, device)


@dataclass(frozen=True)
class Accumulator:
    """Progressive render state.

    color      [H, W, 3] f32   — accumulated (unnormalized) radiance sum
    rng        [H, W, 4] int32 — per-pixel SFC32 state (a, b, c, counter),
                                 the uint32 bit patterns
    iterations int             — samples accumulated so far (host-side)
    """

    color: torch.Tensor
    rng: torch.Tensor
    iterations: int

    @property
    def image(self) -> torch.Tensor:
        """Normalized image: accumulated color / iterations."""
        return self.color / float(max(self.iterations, 1))

    def to(self, device) -> "Accumulator":
        return _to(self, device)


def make_materials(entries, device) -> Materials:
    """Build a `Materials` batch from (color, illuminance, brdf_kind,
    brdf_param) tuples."""
    color = np.array([e[0] for e in entries], np.float32).reshape(-1, 3)
    illum = np.array([e[1] for e in entries], np.float32)
    kind = np.array([e[2] for e in entries], np.int32)
    param = np.array([e[3] for e in entries], np.float32)
    return Materials(
        color=torch.as_tensor(color, device=device),
        illuminance=torch.as_tensor(illum, device=device),
        brdf_kind=torch.as_tensor(kind, device=device),
        brdf_param=torch.as_tensor(param, device=device),
    )


def _v3(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32).reshape(-1, 3), device=device)


def make_spheres(pos, radius, materials: Materials, device) -> Spheres:
    return Spheres(
        pos=_v3(pos, device),
        radius=torch.as_tensor(np.array(radius, np.float32), device=device),
        material=materials,
    )


def make_planes(pos, normal, materials: Materials, device) -> Planes:
    return Planes(
        pos=_v3(pos, device), normal=_v3(normal, device), material=materials
    )


def make_boxes(lo, hi, materials: Materials, device) -> Boxes:
    return Boxes(lo=_v3(lo, device), hi=_v3(hi, device), material=materials)


def make_triangles(v0, v1, v2, materials: Materials, device) -> Triangles:
    return Triangles(
        v0=_v3(v0, device),
        v1=_v3(v1, device),
        v2=_v3(v2, device),
        material=materials,
    )
