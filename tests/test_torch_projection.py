"""The port's view and projection matrices (`core/projection.py`) against
the JAX package's, and the reference's projection properties on the port.

The same seeded numpy inputs go through both packages, batched and
broadcast; tolerance rtol 1e-5, atol 1e-6 (float32 tan, sqrt and division
may round differently in the last bit between XLA and PyTorch).  The
property cases are tests/test_projection.py's, run on the port.
"""

import zlib

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.core import projection as JP
from haskell_path_tracer_torch.core import linalg
from haskell_path_tracer_torch.core import projection as P

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _vectors(rng, shape):
    return rng.normal(size=(*shape, 3)).astype(np.float32)


# (eye shape, center shape, up shape): single, batched, and broadcast
# against a single vector.
LOOK_SHAPES = {
    "single": ((), (), ()),
    "batched": ((5,), (5,), (5,)),
    "broadcast": ((4, 3), (), (3,)),
}


@pytest.mark.parametrize("fn", ["look_at", "look_at_scratch"])
@pytest.mark.parametrize("shapes", list(LOOK_SHAPES), ids=list(LOOK_SHAPES))
def test_look_at_matches_jax(fn, shapes):
    rng = np.random.default_rng(zlib.crc32(f"{fn} {shapes}".encode()))
    a, b, c = (_vectors(rng, s) for s in LOOK_SHAPES[shapes])
    want = getattr(JP, fn)(a, b, c)
    got = getattr(P, fn)(_t(a), _t(b), _t(c))
    assert got.shape == want.shape
    _close(got, want)


# (fovy, aspect, near[, far]) shapes: scalars, one batched argument, and
# arguments that broadcast against each other.
FRUSTUM_SHAPES = {
    "scalar": ((), (), (), ()),
    "batched_fovy": ((7,), (), (), ()),
    "broadcast": ((3, 1), (4,), (), (3, 4)),
}


def _frustum_args(rng, shapes):
    fovy = rng.uniform(0.3, 2.5, shapes[0]).astype(np.float32)
    aspect = rng.uniform(0.5, 2.5, shapes[1]).astype(np.float32)
    near = rng.uniform(0.01, 1.0, shapes[2]).astype(np.float32)
    far = (near + rng.uniform(1.0, 500.0, shapes[3])).astype(np.float32)
    return fovy, aspect, near, far


@pytest.mark.parametrize("fn", ["perspective", "infinite_perspective",
                                "inverse_infinite_perspective"])
@pytest.mark.parametrize("shapes", list(FRUSTUM_SHAPES), ids=list(FRUSTUM_SHAPES))
def test_frustum_matches_jax(fn, shapes):
    rng = np.random.default_rng(zlib.crc32(f"{fn} {shapes}".encode()))
    args = _frustum_args(rng, FRUSTUM_SHAPES[shapes])
    if fn != "perspective":
        args = args[:3]
    want = getattr(JP, fn)(*args)
    got = getattr(P, fn)(*(_t(a) for a in args))
    assert got.shape == want.shape
    _close(got, want)


def test_python_numbers_and_normalize():
    """Plain numbers go in as float32; `normalize` has no epsilon, so a zero
    vector gives NaN as in the reference."""
    _close(P.perspective(1.2, 4.0 / 3.0, 0.1, 100.0), JP.perspective(1.2, 4.0 / 3.0, 0.1, 100.0))
    v = _vectors(np.random.default_rng(1), (6,))
    _close(linalg.normalize(_t(v)), v / np.linalg.norm(v, axis=-1, keepdims=True))
    assert torch.isnan(linalg.normalize(torch.zeros(3))).all()


def _apply(m, v):
    """Row-major M44 applied to a homogeneous point."""
    return m.double().numpy() @ np.asarray(v, np.float64)


def _look_at_eye_to_origin():
    m = P.look_at(_t([1.0, 2.0, 3.0]), _t([0.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0]))
    out = _apply(m, [1.0, 2.0, 3.0, 1.0])
    np.testing.assert_allclose(out[:3], 0.0, atol=1e-6)
    assert out[3] == 1.0


def _look_at_view_direction():
    eye, center = np.array([1.0, 2.0, 3.0]), np.array([-2.0, 0.5, 7.0])
    m = P.look_at(_t(eye), _t(center), _t([0.0, 1.0, 0.0]))
    out = _apply(m, [*center, 1.0])
    np.testing.assert_allclose(out[:2], 0.0, atol=1e-5)
    np.testing.assert_allclose(out[2], -np.linalg.norm(center - eye), rtol=1e-5)


def _look_at_orthonormal():
    m = P.look_at(_t([4.0, -1.0, 2.0]), _t([0.0, 0.0, -5.0]), _t([0.0, 1.0, 0.0])).numpy()
    np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3), atol=1e-6)


def _look_at_scratch_basis():
    from_ = np.array([2.0, 1.0, 5.0], np.float32)
    m = P.look_at_scratch(_t(from_), _t([0.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0])).numpy()
    fwd = from_ / np.linalg.norm(from_)
    np.testing.assert_allclose(m[2, :3], fwd, rtol=1e-6)
    np.testing.assert_allclose(m[3, :3], from_, rtol=1e-6)
    gram = m[:3, :3] @ m[:3, :3].T
    np.testing.assert_allclose(gram - np.diag(np.diag(gram)), np.zeros((3, 3)), atol=1e-6)
    s2 = 1.0 - float(fwd @ np.array([0.0, 1.0, 0.0])) ** 2
    np.testing.assert_allclose(np.diag(gram), [s2, s2, 1.0], rtol=1e-5)
    np.testing.assert_allclose(m[:, 3], 0.0, atol=0)


def _perspective_gl_frustum():
    fovy, aspect, near, far = 1.2, 4.0 / 3.0, 0.1, 100.0
    m = P.perspective(fovy, aspect, near, far).numpy()
    th = np.tan(fovy / 2)
    expect = np.zeros((4, 4), np.float32)
    expect[0, 0] = 1 / (aspect * th)
    expect[1, 1] = 1 / th
    expect[2, 2] = -(far + near) / (far - near)
    expect[2, 3] = -(2 * far * near) / (far - near)
    expect[3, 2] = -1
    np.testing.assert_allclose(m, expect, rtol=1e-4)


def _perspective_clip_planes():
    fovy, aspect, near, far = 0.9, 1.5, 0.5, 50.0
    m = P.perspective(fovy, aspect, near, far)
    on, of = _apply(m, [0.0, 0.0, -near, 1.0]), _apply(m, [0.0, 0.0, -far, 1.0])
    np.testing.assert_allclose(on[2] / on[3], -1.0, rtol=1e-4)
    np.testing.assert_allclose(of[2] / of[3], 1.0, rtol=1e-4)


def _infinite_far_limit():
    near = 0.25
    m = P.infinite_perspective(1.0, 1.0, near)
    on = _apply(m, [0.0, 0.0, -near, 1.0])
    np.testing.assert_allclose(on[2] / on[3], -1.0, rtol=1e-5)
    ofar = _apply(m, [0.0, 0.0, -1e6, 1.0])
    np.testing.assert_allclose(ofar[2] / ofar[3], 1.0, rtol=1e-3)


def _inverse_is_inverse():
    args = (1.1, 16.0 / 9.0, 0.1)
    m = P.infinite_perspective(*args).double().numpy()
    mi = P.inverse_infinite_perspective(*args).double().numpy()
    np.testing.assert_allclose(m @ mi, np.eye(4), atol=1e-5)
    np.testing.assert_allclose(mi @ m, np.eye(4), atol=1e-5)


def _batched_rows_are_singles():
    eyes = _t(np.random.default_rng(0).normal(size=(5, 3)))
    center, up = torch.zeros(5, 3), torch.tensor([0.0, 1.0, 0.0]).expand(5, 3)
    m = P.look_at(eyes, center, up)
    assert m.shape == (5, 4, 4)
    np.testing.assert_allclose(m[2].numpy(), P.look_at(eyes[2], center[2], up[2]).numpy(), atol=1e-6)
    assert P.perspective(torch.full((7,), 1.0), 1.0, 0.1, 10.0).shape == (7, 4, 4)


PROPERTIES = {
    "look_at_maps_eye_to_origin": _look_at_eye_to_origin,
    "look_at_maps_view_direction_to_minus_z": _look_at_view_direction,
    "look_at_rows_are_orthonormal": _look_at_orthonormal,
    "look_at_scratch_basis": _look_at_scratch_basis,
    "perspective_matches_gl_frustum": _perspective_gl_frustum,
    "perspective_maps_near_far_to_clip_planes": _perspective_clip_planes,
    "infinite_perspective_far_limit": _infinite_far_limit,
    "inverse_infinite_perspective_is_inverse": _inverse_is_inverse,
    "batched_broadcasting": _batched_rows_are_singles,
}


@pytest.mark.parametrize("prop", list(PROPERTIES), ids=list(PROPERTIES))
def test_projection_property(prop):
    PROPERTIES[prop]()
