"""The port's native output path (`runtime/native.py`, `runtime/build.py`,
`csrc/ptru_native.cpp`) against the JAX package's native runtime and the
numpy path, and the port's plain traces against the JAX package's scalar
C++ oracles (`haskell_path_tracer_tpu/runtime/native.py:render_inline` and
`trace_physical_nee`, ctypes witnesses that import no JAX).

Tolerances.  The native tonemap is bit-equal to the JAX package's native
one (the same C++ formula and flags) and within 1 LSB of numpy's (powf and
numpy's power differ by an ulp); the PNG bytes are the JAX writer's.  The
inline trace against `render_inline`: tests/test_native.py's contract,
> 99% of colour values close at rtol 1e-3 / atol 1e-4 and > 99.5% of lanes
with equal rng.  The NEE trace against `trace_physical_nee`: tests/
test_native.py's, >= 99.5% of lanes with equal rng and <= 0.5% of those off
by more than 1e-3 + 2e-3 |x|.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.runtime import native as jnative
from haskell_path_tracer_tpu.utils import image as jimage
from haskell_path_tracer_torch.app import animate
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render import nee as tnee
from haskell_path_tracer_torch.runtime import build, native
from haskell_path_tracer_torch.utils import image as timage

from test_pallas_nee import cornell8, tri_scene
from torch_port_fixtures import torch_scene

torch.set_num_threads(2)
PKG = os.path.dirname(os.path.abspath(timage.__file__)).rsplit(os.sep, 1)[0]


@pytest.fixture(scope="module")
def lib():
    """Both packages' native libraries, built at first use."""
    if not (native.available() and jnative.available()):
        pytest.fail(f"native build failed: {native.load_error()} / {jnative.load_error()}")
    return native


def _radiance(seed, shape=(37, 53, 3)):
    """HDR radiance with negative lanes and a few large values."""
    rng = np.random.default_rng(seed)
    img = rng.gamma(1.0, 3.0, size=shape).astype(np.float32)
    img[::7, ::5] *= 300.0
    img[::11, ::3] *= -1.0
    return img


@pytest.mark.parametrize("exposure,gamma", [(1.0, 2.2), (0.6, 2.2), (0.35, 1.0), (2.0, 1.8)])
def test_tonemap_matches_jax_native_and_numpy(lib, exposure, gamma):
    img = _radiance(int(exposure * 100))
    got = lib.tonemap_rgb8(img, exposure, gamma)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, jnative.tonemap_rgb8(img, exposure, gamma))
    ref = timage.tonemap(img, exposure=exposure, gamma=gamma)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("h,w", [(11, 5), (1, 1), (48, 64)])
def test_write_png_matches_jax_native(lib, tmp_path, h, w):
    rgb = (np.arange(h * w * 3) * 7 % 251).astype(np.uint8).reshape(h, w, 3)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    lib.write_png(ours, rgb)
    jnative.write_png(theirs, rgb)
    blob = open(ours, "rb").read()
    assert blob == open(theirs, "rb").read()
    assert struct.unpack(">II", blob[16:24]) == (w, h)
    idat = blob.index(b"IDAT")
    n = struct.unpack(">I", blob[idat - 4:idat])[0]
    rows = np.frombuffer(zlib.decompress(blob[idat + 4:idat + 4 + n]), np.uint8)
    np.testing.assert_array_equal(rows.reshape(h, 1 + w * 3)[:, 1:].reshape(h, w, 3), rgb)


def test_write_png_refuses_bad_input(lib, tmp_path):
    with pytest.raises(ValueError):
        lib.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(OSError):
        lib.write_png(str(tmp_path / "no" / "such" / "x.png"), np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("suffix", [".png", ".ppm"])
def test_save_render_takes_the_native_path(lib, tmp_path, suffix):
    img = _radiance(5, (12, 20, 3))
    timage.SAVE_PATHS.update(native=0, numpy=0)
    path = timage.save_render(str(tmp_path / f"x{suffix}"), img, exposure=0.6)
    assert timage.SAVE_PATHS == {"native": 1, "numpy": 0}
    rgb8 = jnative.tonemap_rgb8(np.ascontiguousarray(img[::-1]), 0.6, 2.2)
    blob = open(path, "rb").read()
    if suffix == ".png":
        want = str(tmp_path / "jax.png")
        jnative.write_png(want, rgb8)
        assert blob == open(want, "rb").read()
    else:
        assert blob == b"P6\n20 12\n255\n" + rgb8.tobytes()


def test_save_render_takes_numpy_without_the_library(tmp_path, monkeypatch):
    """With the library unavailable, the numpy tonemap and encoder write
    the JAX package's numpy bytes; an EXR is never tonemapped."""
    monkeypatch.setattr(native, "available", lambda: False)
    img = _radiance(6, (12, 20, 3))
    timage.SAVE_PATHS.update(native=0, numpy=0)
    path = timage.save_render(str(tmp_path / "x.png"), img, exposure=0.6)
    assert timage.SAVE_PATHS == {"native": 0, "numpy": 1}
    assert open(path, "rb").read() == jimage.encode_png(jimage.tonemap(img[::-1], exposure=0.6))
    timage.save_render(str(tmp_path / "x.exr"), img)
    assert timage.SAVE_PATHS == {"native": 0, "numpy": 1}


def test_library_is_built_into_the_port(lib):
    """Built from the port's own source into its gitignored `_build/`,
    named by a hash of the source and flags; nothing of the JAX package."""
    path = build.library_path()
    assert os.path.dirname(path) == os.path.join(PKG, "_build") == build.BUILD_DIR
    assert os.path.basename(path).startswith("libptru_native-") and os.path.exists(path)
    assert build.SOURCE == os.path.join(PKG, "csrc", "ptru_native.cpp")
    assert "-ffp-contract=off" in build.FLAGS and "-lz" in build.LIBS
    assert path == build.library_file()
    assert "haskell_path_tracer_tpu" not in open(build.SOURCE).read()


def test_failed_build_is_reported(tmp_path, monkeypatch):
    """A missing compiler is a BuildError, which `native` reports as
    unavailable (and save_render then takes numpy)."""
    monkeypatch.setattr(build, "_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(build.BuildError):
        build.library_path()
    assert not [f for f in os.listdir(tmp_path / "_build") if f.endswith(".so")]


# Witness gaps: the port's plain traces against the scalar C++ oracles.


def _close_fraction(a, b, rtol=1e-3, atol=1e-4):
    return np.isclose(a, b, rtol=rtol, atol=atol).mean()


# (camera, w, h, spp, bounces, seed): the reference's camera, and a camera
# at the origin whose middle row of rays is exactly parallel to the two
# planes (the JAX package's compiled loop makes those rays hit; the port
# and the oracle agree that they miss).
INLINE_CASES = {
    "reference_camera": (None, 32, 24, 2, 4, 11),
    "horizon_row": (([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0), 32, 24, 4, 4, 0),
}


@pytest.mark.parametrize("route", ["integrator", "fused_reference"])
@pytest.mark.parametrize("case", list(INLINE_CASES), ids=list(INLINE_CASES))
def test_plain_inline_matches_cpp_oracle(lib, case, route):
    from haskell_path_tracer_torch.render.integrator import make_accumulator, render_batch_inline

    cam_args, w, h, spp, bounces, seed = INLINE_CASES[case]
    scene = world.main_scene("cpu")
    cam = world.initial_camera("cpu") if cam_args is None else Camera.create(*cam_args, "cpu")
    acc = make_accumulator(w, h, seed, "cpu")
    rng0 = rng_to_numpy(acc.rng)
    c_cpp, r_cpp = jnative.render_inline(scene, cam, np.zeros((h, w, 3), np.float32), rng0,
                                         num_bounces=bounces, spp=spp)
    if route == "integrator":
        out = render_batch_inline(scene, cam, acc, spp, num_bounces=bounces)
        color, rng = out.color.numpy(), rng_to_numpy(out.rng)
    else:
        c, r = MK.trace_inline_fused_reference(scene, primary_rays(cam, w, h), acc.rng, bounces, spp)
        color, rng = c.numpy(), rng_to_numpy(r)
    assert _close_fraction(color, c_cpp) > 0.99
    assert (rng == r_cpp).all(axis=-1).mean() > 0.995
    np.testing.assert_allclose(color.mean(), c_cpp.mean(), rtol=5e-3)
    assert (r_cpp != rng0).any() and np.abs(c_cpp).max() > 0


# (JAX test scene, or None for the reference scene; camera; w, h; seed).
NEE_CASES = {
    "tri": (tri_scene, ([0.0] * 3, [0.0] * 3, 90.0), 64, 16, 9),
    "cornell8": (cornell8, ([0.0] * 3, [0.0] * 3, 90.0), 64, 16, 9),
    # The orbit's camera at yaw -pi, where the JAX package's compiled NEE
    # loop flips shadow tests on one row (tests/test_torch_app.py).
    "reference_orbit_yaw_pi": (None, animate.orbit_path(2)[1], 32, 24, 1),
}


@pytest.mark.parametrize("case", list(NEE_CASES), ids=list(NEE_CASES))
def test_plain_nee_matches_cpp_oracle(lib, case):
    make, cam_args, w, h, seed = NEE_CASES[case]
    scene = world.main_scene("cpu") if make is None else torch_scene(make())
    rays = primary_rays(Camera.create(*cam_args, "cpu"), w, h)
    rng = rng_to_numpy(gen_seeds((h, w), seed, "cpu"))
    rad, rng_out = tnee.trace_physical(scene, rays, rng_from_numpy(rng, "cpu"), 3,
                                       nee=True, fused=False)
    rad_c, rng_c = jnative.trace_physical_nee(scene, rays.origin.numpy(), rays.direction.numpy(),
                                              rng, 3)
    rad, rng_out = rad.numpy(), rng_to_numpy(rng_out)
    m = (rng_out == rng_c).all(-1)
    assert m.mean() >= 0.995, m.mean()
    bad = (np.abs(rad_c - rad) > (1e-3 + 2e-3 * np.abs(rad))).any(-1)
    assert (bad & m).mean() <= 0.005
    assert np.abs(rad).max() > 0
