"""The reference's 8 hedgehog intersection properties against the port.

`tests/test_intersect.py` runs them (Tests.hs:32-116 of the Haskell
reference, ported to hypothesis) against the JAX package.  Here the same
properties, strategies, tolerances and example counts (60 each) run against
the port's plain fold, `haskell_path_tracer_torch/ops/intersect.py`: each
distance comes from `sphere_distances` or `plane_distances`, and
`nearest_t_prim` on a scene of that one primitive must give it bit for bit
with prim 0 ((INFINITE, 0) on a miss).  `nearest_t_prim` at
`reject_below=0.0` is the plain version of the primary-hit probe
(`ops/nee.py:primary_probe`).  `derandomize=True`: every run draws the
same examples.
"""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from haskell_path_tracer_torch.models.objects import (
    BRDF_MATTE,
    Scene,
    empty_materials,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer_torch.ops.intersect import (
    INFINITE,
    nearest_t_prim,
    plane_distances,
    sphere_distances,
)

torch.set_num_threads(2)
finite = dict(allow_nan=False, allow_infinity=False, width=32)
props = settings(max_examples=60, deadline=None, derandomize=True)


def f32s(lo, hi):
    """float32-representable bounds for hypothesis width=32 strategies."""
    return st.floats(float(np.float32(lo)), float(np.float32(hi)), **finite)


def _mats(n):
    return make_materials([([1.0, 1.0, 1.0], 1.0, BRDF_MATTE, 1.0)] * n, "cpu")


def _no_spheres():
    return make_spheres(np.zeros((0, 3)), np.zeros(0), empty_materials("cpu"), "cpu")


def _no_planes():
    return make_planes(np.zeros((0, 3)), np.zeros((0, 3)), empty_materials("cpu"), "cpu")


def _ray(origin, direction):
    return (torch.tensor(np.asarray(origin, np.float32))[None],
            torch.tensor(np.asarray(direction, np.float32))[None])


def _nearest(o, d, scene):
    """nearest_t_prim on a one-primitive scene: its t, checked to be the
    primitive's (prim 0) on a hit and (INFINITE, 0) on a miss."""
    t, prim = nearest_t_prim(o, d, scene, 0.0)
    assert int(prim[0]) == 0
    return t[0]


def dist_to_sphere(origin, direction, pos, radius):
    s = make_spheres([pos], [radius], _mats(1), "cpu")
    o, d = _ray(origin, direction)
    t = sphere_distances(o, d, s)[0, 0]
    assert torch.equal(_nearest(o, d, Scene(spheres=s, planes=_no_planes())), t)
    return t.item()


def dist_to_plane(origin, direction, pos, normal):
    p = make_planes([pos], [normal], _mats(1), "cpu")
    o, d = _ray(origin, direction)
    t = plane_distances(o, d, p)[0, 0]
    assert torch.equal(_nearest(o, d, Scene(spheres=_no_spheres(), planes=p)), t)
    return t.item()


def normalized(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


# --- Sphere properties (Tests.hs:32-73) ------------------------------------


@props
@given(f32s(0.1, 100.0))
def test_sphere_hit_point_on_axis(diameter):
    """intersection ((x, 0, x), x) = (0, 0, x)  (Tests.hs:35-42)."""
    t = dist_to_sphere([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [diameter, 0.0, diameter], diameter)
    assert t < INFINITE
    hit_pos = np.array([0.0, 0.0, 1.0]) * t
    np.testing.assert_allclose(hit_pos, [0.0, 0.0, diameter], rtol=1e-3, atol=1e-3)


@props
@given(f32s(0.1, 100.0), f32s(0.1, 100.0))
def test_sphere_diagonal_distance(diameter, offset):
    """distanceTo ((x,x,x), y) = sqrt(3 y^2) - y + sqrt(3 (x-y)^2)
    (Tests.hs:43-58)."""
    pos = diameter + offset
    t = dist_to_sphere([0.0, 0.0, 0.0], normalized([1.0, 1.0, 1.0]), [pos, pos, pos], diameter)
    expected = np.sqrt(3 * diameter**2) - diameter + np.sqrt(3 * offset**2)
    assert t < INFINITE
    np.testing.assert_allclose(t, expected, rtol=1e-3, atol=0.05)


@props
@given(
    f32s(0.1, 100.0),
    st.tuples(*[f32s(-1.0, 1.0)] * 3).filter(lambda v: np.linalg.norm(v) > 1e-3),
)
def test_sphere_backface_culling(diameter, direction):
    """Rays starting inside a sphere register no hit (Tests.hs:59-66)."""
    t = dist_to_sphere([0.0, 0.0, 0.0], normalized(direction), [0.0, 0.0, 0.0], diameter)
    assert t == INFINITE


@props
@given(st.tuples(*[f32s(-1.0, 1.0)] * 3).filter(lambda v: np.linalg.norm(v) > 1e-3))
def test_sphere_no_backwards_intersections(direction):
    """A sphere strictly behind the ray origin is not hit (Tests.hs:67-72)."""
    d = normalized(direction)
    t = dist_to_sphere([0.0, 0.0, 0.0], d, list(-d), 0.1)
    assert t == INFINITE


# --- Plane properties (Tests.hs:75-116) ------------------------------------


@props
@given(
    st.tuples(*[f32s(-1000.0, 1000.0)] * 3).filter(
        # The JAX test's strategy: it skips the sub-normal sliver where the
        # z >= 0 branch choice depends on denormal support.
        lambda v: v[2] == 0.0 or abs(v[2]) > 1e-6
    )
)
def test_plane_straight_on(pos):
    """Head-on hit at distance z, miss when the plane is behind
    (Tests.hs:78-85)."""
    t = dist_to_plane([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], list(pos), [0.0, 0.0, -1.0])
    z = np.float32(pos[2])
    if z >= 0.0:
        np.testing.assert_allclose(t, z, rtol=1e-5, atol=1e-5)
    else:
        assert t == INFINITE


@props
@given(st.tuples(*[f32s(-1000.0, 1000.0)] * 3))
def test_plane_backface_straight_on(pos):
    """One-sided: a plane facing away is never hit (Tests.hs:86-93)."""
    t = dist_to_plane([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], list(pos), [0.0, 0.0, 1.0])
    assert t == INFINITE


@props
@given(f32s(-1000.0, 1000.0), f32s(-1000.0, 1000.0))
def test_plane_angled(x, y):
    """Angled hit at distance 1/cos(angle) (Tests.hs:94-107)."""
    d = normalized([x, y, 1.0])
    t = dist_to_plane([0.0, 0.0, 0.0], d, [0.0, 0.0, 1.0], [0.0, 0.0, -1.0])
    expected = 1.0 / d[2]
    if expected >= 0.0:
        np.testing.assert_allclose(t, expected, rtol=1e-4, atol=1e-4)
    else:
        assert t == INFINITE


@props
@given(f32s(-1000.0, 1000.0), f32s(-1000.0, 1000.0))
def test_plane_angled_backface(x, y):
    """Angled backface culling (Tests.hs:108-115)."""
    d = normalized([x, y, 1.0])
    t = dist_to_plane([0.0, 0.0, 0.0], d, [0.0, 0.0, 1.0], [0.0, 0.0, 1.0])
    assert t == INFINITE
