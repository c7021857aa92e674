"""View and projection matrices (the reference's ``Linear.Projection``).

Counterpart of ``haskell_path_tracer_tpu/core/projection.py``: `look_at`,
`look_at_scratch`, `perspective` (with the reference's
``w = 1 / (0.5/far - 0.5/near)`` form), `infinite_perspective` and
`inverse_infinite_perspective`.  Nothing on the render path calls these
(primary rays come from the virtual-plane construction in
`models/camera.py`); they serve debugging, previews and any client that
wants a classic camera matrix.

Every function is batched: its inputs are float32 tensors (or numbers)
with any leading dimensions, which broadcast, and the result is
``[..., 4, 4]`` in the reference's row layout, on the inputs' device.
"""

from __future__ import annotations

import torch

from .linalg import cross, dot, normalize


def _f32(*xs) -> list:
    """The inputs as float32 tensors, on the device of the first input that
    is a tensor off the CPU (else on the CPU)."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor) and x.device.type != "cpu"),
                  None)
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in xs]


def _rows(*rows: torch.Tensor) -> torch.Tensor:
    """Stack four [..., 4] rows into [..., 4, 4]."""
    return torch.stack(torch.broadcast_tensors(*rows), dim=-2)


def _row(a, b, c, d) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(a, b, c, d), dim=-1)


def look_at(eye: torch.Tensor, center: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """A look-at view matrix: rows are the camera's right, up and negated
    forward axes, with the translation terms in the fourth column."""
    eye, center, up = _f32(eye, center, up)
    za = normalize(center - eye)
    xa = normalize(cross(za, up))
    ya = cross(xa, za)
    xd = -dot(xa, eye)
    yd = -dot(ya, eye)
    zd = dot(za, eye)
    zero, one = torch.zeros_like(xd), torch.ones_like(xd)
    return _rows(
        _row(xa[..., 0], xa[..., 1], xa[..., 2], xd),
        _row(ya[..., 0], ya[..., 1], ya[..., 2], yd),
        _row(-za[..., 0], -za[..., 1], -za[..., 2], zd),
        _row(zero, zero, zero, one),
    )


def look_at_scratch(from_: torch.Tensor, to: torch.Tensor, tmp: torch.Tensor) -> torch.Tensor:
    """The scratchapixel look-at variant the reference keeps for
    debugging: a camera-to-world basis with the eye in the last row and no
    translation column (right and up are not re-normalised)."""
    from_, to, tmp = _f32(from_, to, tmp)
    forward = normalize(from_ - to)
    right = cross(normalize(tmp), forward)
    up = cross(forward, right)
    zero = torch.zeros_like(from_[..., 0])
    return _rows(
        _row(right[..., 0], right[..., 1], right[..., 2], zero),
        _row(up[..., 0], up[..., 1], up[..., 2], zero),
        _row(forward[..., 0], forward[..., 1], forward[..., 2], zero),
        _row(from_[..., 0], from_[..., 1], from_[..., 2], zero),
    )


def perspective(fovy, aspect, near, far) -> torch.Tensor:
    """Symmetric perspective frustum matrix, with the reference's
    ``w = 1 / (0.5/far - 0.5/near)`` in place of the textbook
    ``-(2 far near) / (far - near)`` (fewer bits of error)."""
    fovy, aspect, near, far = _f32(fovy, aspect, near, far)
    tan_half = torch.tan(fovy / 2)
    x = 1 / (aspect * tan_half)
    y = 1 / tan_half
    z = -(far + near) / (far - near)
    w = 1 / (0.5 / far - 0.5 / near)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return _rows(
        _row(x, zero, zero, zero),
        _row(zero, y, zero, zero),
        _row(zero, zero, z, w),
        _row(zero, zero, -one, zero),
    )


def _infinite_frustum(fovy, aspect, near):
    """(near, top, bottom, left, right) of the infinite frustum."""
    fovy, aspect, near = _f32(fovy, aspect, near)
    t = near * torch.tan(fovy / 2)
    b = -t
    return near, t, b, b * aspect, t * aspect


def infinite_perspective(fovy, aspect, near) -> torch.Tensor:
    """Perspective frustum matrix with the far plane at infinity."""
    near, t, b, left, r = _infinite_frustum(fovy, aspect, near)
    x = (2 * near) / (r - left)
    y = (2 * near) / (t - b)
    w = -2 * near
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return _rows(
        _row(x, zero, zero, zero),
        _row(zero, y, zero, zero),
        _row(zero, zero, -one, w),
        _row(zero, zero, -one, zero),
    )


def inverse_infinite_perspective(fovy, aspect, near) -> torch.Tensor:
    """Closed-form inverse of `infinite_perspective`."""
    near, t, b, left, r = _infinite_frustum(fovy, aspect, near)
    hrn = 0.5 / near
    rx = (r - left) * hrn
    ry = (t - b) * hrn
    rw = -hrn
    zero, one = torch.zeros_like(rx), torch.ones_like(rx)
    return _rows(
        _row(rx, zero, zero, zero),
        _row(zero, ry, zero, zero),
        _row(zero, zero, zero, -one),
        _row(zero, zero, rw, -rw),
    )
