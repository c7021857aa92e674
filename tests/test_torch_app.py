"""The port's app layer against the JAX package's: camera interaction
(`app/interact.py`) and the flythrough renderer (`app/animate.py`).

Tolerances.  `clamp_roll`, `move_camera`, `interpolate_path` and
`orbit_path` are numpy arithmetic in both packages: bit-equal.  The
flythrough renderer at 32x24, 2 or 3 frames, 4 spp, 4 bounces on the CPU:
each frame's accumulator against the JAX package's `animate.main` on the
same arguments, inline at the parity contract (`torch_port_fixtures.lane_agreement`: >= 99.5% of
lanes with equal rng, >= 99% of colour values isclose at 1e-4, and among
the lit ones), physical at the NEE lane contract
(`tests/test_pallas_nee.py:assert_lane_parity`); its EXR frames are those
accumulators' images, flipped, bit for bit.

Knife edges of the reference.  The JAX package's compiled loops contract
FMAs (ROADMAP, "Knife-edge lanes"), so on a few cameras its decisions flip
where the port and the C++ oracle agree (`test_torch_native.py` holds both
cameras against it): a middle row of rays exactly parallel to the two
planes (a camera at the origin with no rotation: 2.6% of lanes of the
inline trace), and the shadow tests of one row seen by the orbit's camera
at yaw -pi (its second frame of two: 1.3% of lanes of the physical
estimator).  So the keyframes start at the reference's own camera and the
physical orbit runs 3 frames (at most 0.39% of lanes off).
"""

import json

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.app import animate as JA
from haskell_path_tracer_tpu.app import interact as JI
from haskell_path_tracer_tpu.models.objects import Camera as JaxCamera
from haskell_path_tracer_tpu.render.renderer import Renderer as JaxRenderer
from haskell_path_tracer_torch.app import animate as TA
from haskell_path_tracer_torch.app import interact as TI
from haskell_path_tracer_torch.models.convert import camera_to_numpy, rng_to_numpy
from haskell_path_tracer_torch.models.objects import Camera
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils.image import read_exr

from test_pallas_nee import assert_lane_parity
from torch_port_fixtures import lane_agreement

torch.set_num_threads(2)
RNG_MIN, CLOSE_MIN = 0.995, 0.99


def _cameras(pos, rot, fov):
    return (Camera.create(pos, rot, fov, "cpu"), JaxCamera.create(pos, rot, fov))


def _bits_equal(port_cam, jax_cam):
    got = camera_to_numpy(port_cam)
    for f in ("position", "rotation", "fov"):
        want = np.asarray(getattr(jax_cam, f), np.float32)
        np.testing.assert_array_equal(got[f].view(np.uint32), want.view(np.uint32), err_msg=f)


@pytest.mark.parametrize("roll", [0.0, 0.3, -1.2, TI.ROLL_LIMIT, -TI.ROLL_LIMIT, 2.0, -7.5])
def test_clamp_roll_matches_jax(roll):
    r = np.array([roll, 0.25, -0.5], np.float32)
    got, want = TI.clamp_roll(r), JI.clamp_roll(r)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(r, [np.float32(roll), 0.25, -0.5])  # input untouched


# (translation, rotation delta, elapsed, sprint) of one frame of input.
MOVES = {
    "zero": ([0, 0, 0], [0, 0, 0], 1 / 60, False),
    "forward": ([0, 0, -1], [0, 0, 0], 0.5, False),
    "diagonal": ([1, 0, -1], [0, 0, 0], 1 / 60, False),
    "sprint": ([1, 1, -1], [0, 0, 0], 0.05, True),
    "look_and_walk": ([0, 0, -1], [3.0, -1570.8, 0.0], 0.05, False),
    "roll_at_clamp": ([0, 1, 0], [1e6, 5.0, 0.0], 0.05, True),
    "roll_at_negative_clamp": ([-1, 0, 0], [-1e6, 0.0, 0.0], 0.05, False),
}


@pytest.mark.parametrize("move", list(MOVES), ids=list(MOVES))
def test_move_camera_matches_jax(move):
    t, r, elapsed, sprint = MOVES[move]
    rng = np.random.default_rng(len(move))
    pos = rng.normal(size=3).astype(np.float32)
    rot = rng.uniform(-1, 1, 3).astype(np.float32)
    cam, jcam = _cameras(pos, rot, 75.0)
    got = TI.move_camera(cam, t, r, elapsed=elapsed, sprint=sprint)
    want = JI.move_camera(jcam, t, r, elapsed=elapsed, sprint=sprint)
    _bits_equal(got, want)
    assert got.position.device == cam.position.device
    assert all(x.dtype == torch.float32 for x in (got.position, got.rotation, got.fov))
    if move.startswith("roll_at"):
        assert abs(abs(float(got.rotation[0])) - TI.ROLL_LIMIT) < 1e-6


def test_move_camera_seeded_sequence_matches_jax():
    """A seeded run of 50 frames of random input, each from the last."""
    rng = np.random.default_rng(7)
    cam, jcam = _cameras([1.0, -1.6, -4.8], [0.314, -0.314, 0.0], 90.0)
    for _ in range(50):
        t = rng.integers(-1, 2, 3)
        r = [*rng.normal(0, 200, 2), 0.0]
        sprint = bool(rng.integers(2))
        cam = TI.move_camera(cam, t, r, elapsed=0.05, sprint=sprint)
        jcam = JI.move_camera(jcam, t, r, elapsed=0.05, sprint=sprint)
        _bits_equal(cam, jcam)


def test_move_camera_semantics():
    """tests/test_app.py's properties on the port: walking moves
    speed * elapsed * 0.25 along the rotated forward axis, sprint is 4x, a
    diagonal is normalised, and the rotation is applied before the step."""
    cam = Camera.create([0.0] * 3, [0.0] * 3, 90.0, "cpu")
    out = TI.move_camera(cam, [0, 0, -1], [0, 0, 0], elapsed=0.5)
    np.testing.assert_allclose(out.position.numpy(), [0.0, 0.0, -TI.MOVEMENT_SPEED * 0.125], atol=1e-6)
    fast = TI.move_camera(cam, [0, 0, -1], [0, 0, 0], elapsed=0.5, sprint=True)
    np.testing.assert_allclose(fast.position.numpy(), out.position.numpy() * 4.0, atol=1e-6)
    diagonal = TI.move_camera(cam, [1, 0, -1], [0, 0, 0], elapsed=0.5)
    np.testing.assert_allclose(np.linalg.norm(diagonal.position.numpy()),
                               np.linalg.norm(out.position.numpy()), rtol=1e-6)
    yawed = TI.move_camera(cam, [0, 0, -1], [0.0, -np.pi / 2 * 1000, 0.0]).position.numpy()
    assert abs(yawed[0]) > 1e-3 and abs(yawed[2]) < 1e-4


KEYFRAMES = [
    {"position": [1.0, -1.6, -4.8], "rotation": [0.314, -0.314, 0.0], "fov": 90},
    {"position": [2, 0.5, -1], "rotation": [0, 1, 0.1], "fov": 60},
    {"position": [3, -1, -4], "rotation": [0.2, 1.5, 0], "fov": 75},
]


@pytest.mark.parametrize("keys,frames", [(1, 3), (2, 5), (3, 7), (3, 2)])
def test_interpolate_path_matches_jax(keys, frames):
    got = TA.interpolate_path(KEYFRAMES[:keys], frames)
    want = JA.interpolate_path(KEYFRAMES[:keys], frames)
    assert len(got) == len(want) == frames
    for (p, r, f), (wp, wr, wf) in zip(got, want):
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(r, wr)
        assert f == wf and p.dtype == r.dtype == np.float32


@pytest.mark.parametrize("frames", [1, 4, 60])
def test_orbit_path_matches_jax(frames):
    for (p, r, f), (wp, wr, wf) in zip(TA.orbit_path(frames), JA.orbit_path(frames), strict=True):
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(r, wr)
        assert f == wf


def _recorded(monkeypatch, cls, out):
    """Record every accumulator `cls.render` returns, into `out`."""
    render = cls.render

    def recording(self, *a, **kw):
        acc = render(self, *a, **kw)
        out.append(acc)
        return acc

    monkeypatch.setattr(cls, "render", recording)


# Per run: its arguments and its frame count.
ANIMATIONS = {
    "inline_orbit": (["--orbit"], 2),
    "physical_orbit": (["--orbit", "--variant", "physical"], 3),
    "inline_path": ([], 2),  # --path, written by the test
}


@pytest.mark.parametrize("run", list(ANIMATIONS), ids=list(ANIMATIONS))
def test_animate_matches_jax(run, tmp_path, monkeypatch):
    extra, n_frames = ANIMATIONS[run]
    args = ["--width", "32", "--height", "24", "--frames", str(n_frames), "--spp", "4",
            "--bounces", "4", "--quiet", *extra]
    if run == "inline_path":
        path = tmp_path / "path.json"
        path.write_text(json.dumps(KEYFRAMES))
        args += ["--path", str(path)]
    accs, jaccs = [], []
    _recorded(monkeypatch, Renderer, accs)
    _recorded(monkeypatch, JaxRenderer, jaccs)
    assert TA.main([*args, "--device", "cpu", "-o", str(tmp_path / "port_%02d.exr")]) == 0
    assert JA.main([*args, "-o", str(tmp_path / "jax_%02d.exr")]) == 0
    assert len(accs) == len(jaccs) == n_frames

    frames = []
    for j, (acc, jacc) in enumerate(zip(accs, jaccs)):
        assert acc.iterations == int(jacc.iterations) == 4
        color, rng = acc.color.numpy(), rng_to_numpy(acc.rng)
        jcolor, jrng = np.asarray(jacc.color), np.asarray(jacc.rng)
        if run.startswith("physical"):
            assert_lane_parity(jrng, rng, jcolor, color)
        else:
            rng_match, close, lit_close = lane_agreement(rng, jrng, color, jcolor)
            assert rng_match >= RNG_MIN and close >= CLOSE_MIN and lit_close >= CLOSE_MIN, (
                rng_match, close, lit_close)
        img = read_exr(str(tmp_path / f"port_{j:02d}.exr"))
        np.testing.assert_array_equal(img, acc.image.numpy()[::-1])
        assert np.isfinite(img).all() and img.max() > 0
        frames.append(img)
    assert all(not np.array_equal(a, b) for a, b in zip(frames, frames[1:]))  # the camera moved


def test_animate_device_defaults_to_cuda(tmp_path):
    """`--device` defaults to cuda, which raises without a GPU; nothing
    falls back to the CPU."""
    assert TA.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TA.main(["--frames", "1", "--quiet", "-o", str(tmp_path / "f.png")])
    assert not list(tmp_path.iterdir())
