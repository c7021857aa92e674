"""Camera interaction: the reference's input loop as state arithmetic.

Counterpart of ``haskell_path_tracer_tpu/app/interact.py``:
  * WASD/Ctrl/Space translation deltas are summed, normalized and scaled by
    `MOVEMENT_SPEED * elapsed`, with a 4x sprint factor;
  * the translation is applied in the camera's rotated frame;
  * mouselook adds `(dy, dx, 0) * MOUSE_SENSITIVITY` to the Euler rotation;
  * the roll (slot 0) is clamped to +-`ROLL_LIMIT`;
  * any change invalidates the progressive accumulator, which the caller
    resets.

The arithmetic runs in numpy on the host, bit for bit the JAX package's;
the camera is read through `models/convert.py:camera_to_numpy` (a CUDA
tensor cannot go through `np.asarray`), and the new camera is made on the
input camera's device.  Used by the flythrough renderer and the live viewer.
"""

from __future__ import annotations

import numpy as np

from ..models.convert import camera_to_numpy
from ..models.objects import Camera

MOVEMENT_SPEED = 3.0
MOUSE_SENSITIVITY = -0.001
ROLL_LIMIT = np.pi / 2 - 0.001


def clamp_roll(rotation: np.ndarray) -> np.ndarray:
    out = np.asarray(rotation, np.float32).copy()
    out[0] = min(ROLL_LIMIT, max(-ROLL_LIMIT, float(out[0])))
    return out


def _quat_np(angles):
    roll, pitch, yaw = angles
    cy, sy = np.cos(yaw * 0.5), np.sin(yaw * 0.5)
    cp, sp = np.cos(pitch * 0.5), np.sin(pitch * 0.5)
    cr, sr = np.cos(roll * 0.5), np.sin(roll * 0.5)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            sy * cp * sr + cy * sp * cr,
            sy * cp * cr - cy * sp * sr,
        ],
        np.float32,
    )


def _rotate_np(q, v):
    w, u = q[0], q[1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def move_camera(
    camera: Camera,
    translation_delta,
    rotation_delta,
    elapsed: float = 1.0 / 60.0,
    sprint: bool = False,
) -> Camera:
    """Apply one frame of input.  `translation_delta` is the raw WASD axis
    sum (camera-local), `rotation_delta` the raw mouse (dy, dx, 0) pixels.

    Returns the new camera, on `camera`'s device; the caller resets the
    accumulator if it changed.
    """
    current = camera_to_numpy(camera)
    t = np.asarray(translation_delta, np.float32)
    r = np.asarray(rotation_delta, np.float32) * MOUSE_SENSITIVITY

    rotation = clamp_roll(current["rotation"] + r)

    position = current["position"]
    norm = float(np.linalg.norm(t))
    if norm > 0:
        distance = MOVEMENT_SPEED * elapsed * (1.0 if sprint else 0.25)
        world_delta = _rotate_np(_quat_np(rotation), t / norm * distance)
        position = position + world_delta

    return Camera.create(position, rotation, float(current["fov"]), camera.position.device)
