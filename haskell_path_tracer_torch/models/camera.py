"""Primary ray generation from the pinhole camera.

Counterpart of ``haskell_path_tracer_tpu/models/camera.py`` (the
reference's `primaryRays`, quirks included): the virtual screen sits at
distance 1/tan(fov/2), screen x runs [-1, 1) left to right and y (-1, 1]
top to bottom, and the top offset is divided by the aspect ratio.
"""

from __future__ import annotations

import math

import torch

from ..core import linalg
from ..utils.metrics import span
from .objects import Camera, Rays


def camera_basis(camera: Camera):
    """The virtual-plane frame: (plane_center, look_direction, right_offset)."""
    fov = camera.fov.to(torch.float32)
    screen_angle = (fov * math.pi / 180.0) / 2.0
    screen_distance = 1.0 / torch.tan(screen_angle)
    screen_half_width = torch.tan(screen_angle) * screen_distance  # == 1.0

    c_dir = linalg.angles_to_direction(camera.rotation)
    center = camera.position + c_dir * screen_distance
    center_offset = center - camera.position
    up = torch.tensor(linalg.UP, dtype=torch.float32, device=center.device)
    right_offset = (
        linalg.normalize_safe(linalg.cross(center_offset, up))
        / screen_half_width
    )
    return center, c_dir, right_offset


def primary_rays(
    camera: Camera,
    width: int,
    height: int,
    row_offset: int = 0,
    full_height: int | None = None,
) -> Rays:
    """One primary ray per pixel, on the camera's device.  Returns Rays with
    contiguous origin/direction of shape [height, width, 3].

    For a tile of rows of a larger image, `height` is the tile height,
    `row_offset` its first global row and `full_height` the image height
    that screen space is normalized against.  Runs in span "hpt.camera.rays".
    """
    with span("hpt.camera.rays"):
        device = camera.position.device
        center, c_dir, right_offset = camera_basis(camera)
        fh = height if full_height is None else full_height
        f32 = dict(dtype=torch.float32, device=device)
        aspect = torch.tensor(float(width), **f32) / torch.tensor(float(fh), **f32)
        top_offset = linalg.cross(c_dir, right_offset) / aspect

        xs = torch.arange(width, **f32).expand(height, width)
        ys = torch.arange(height, **f32)[:, None].expand(height, width)
        ys = ys + torch.tensor(float(row_offset), **f32)
        screen_x = xs / float(width) * 2.0 - 1.0
        screen_y = ys / float(-fh) * 2.0 + 1.0

        virtual_point = (
            center
            + right_offset * screen_x[..., None]
            + top_offset * screen_y[..., None]
        )
        ray_dir = linalg.normalize_safe(virtual_point - camera.position)
        origin = camera.position.expand_as(ray_dir).contiguous()
        return Rays(origin=origin, direction=ray_dir.contiguous())
