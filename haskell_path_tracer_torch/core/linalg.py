"""Vector / quaternion math on stacked ``[..., 3]`` tensors.

Counterpart of ``haskell_path_tracer_tpu/core/linalg.py``.  A "V3" is any
tensor whose trailing axis has length 3, so every function is batched over
arbitrary leading (pixel / ray / sample) dimensions.  Sums over the
trailing axis are written out term by term, ``(x + y) + z``, so the float32
rounding order is the JAX package's and does not depend on how a backend
vectorises a reduction.
"""

from __future__ import annotations

import torch

# World basis vectors: the camera looks down -Z when unrotated; +Y is up.
FORWARD = (0.0, 0.0, -1.0)
UP = (0.0, 1.0, 0.0)

# `linear`'s `Epsilon Float` threshold: nearZero v = quadrance v <= 1e-6.
NEAR_ZERO_EPS = 1e-6


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis. Keeps leading dims."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def quadrance(v: torch.Tensor) -> torch.Tensor:
    """Squared length |v|^2."""
    return dot(v, v)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device, as JAX, numpy and
    the CUDA kernels compute it.  PyTorch's float32 sqrt on the CPU (MKL's
    vector math) can be 1 ulp off, so there it goes through float64, whose
    rounding to float32 is exact for a square root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(quadrance(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis, as `linear`'s `normalize`: no
    epsilon, so a zero vector gives NaN/Inf as in the reference.  Use
    `normalize_safe` where that must not happen."""
    return v / norm(v)[..., None]


def normalize_safe(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize with |v| clamped away from 0, so zero vectors stay finite."""
    n = torch.clamp(norm(v), min=eps)
    return v / n[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """`nearZero` for V3 Float: quadrance <= 1e-6."""
    return quadrance(v) <= NEAR_ZERO_EPS


# Quaternions: layout [..., 4] = (w, x, y, z), as linear's `Quaternion`.


def angles_to_quaternion(angles: torch.Tensor) -> torch.Tensor:
    """Euler (roll, pitch, yaw) [..., 3] -> quaternion [..., 4]."""
    roll, pitch, yaw = angles[..., 0], angles[..., 1], angles[..., 2]
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    y = sy * cp * sr + cy * sp * cr
    z = sy * cp * cr - cy * sp * sr
    return torch.stack([w, x, y, z], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by unit quaternion(s) q [..., 4]:
    v + 2w (u x v) + u x (2 (u x v))."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = cross(u, v) * 2.0
    return v + w * t + cross(u, t)


def angles_to_direction(angles: torch.Tensor) -> torch.Tensor:
    """Euler camera rotation -> looking direction (rotated FORWARD)."""
    forward = torch.tensor(FORWARD, dtype=angles.dtype, device=angles.device)
    return quat_rotate(angles_to_quaternion(angles), forward)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n
