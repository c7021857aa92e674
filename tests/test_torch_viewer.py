"""The port's live viewer (`app/viewer.py`) over a real localhost socket, on
the CPU at 32x24 / 3 bounces: tests/test_viewer.py's cases (page, PNG,
status, a move resets the accumulation, 404), a non-finite or malformed
move refused, the render thread's error reported as None, the moved camera
bit-equal to the JAX package's `move_camera` on the same input, and the
render thread joined when the fixture ends.
"""

import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.app.interact import move_camera as jax_move_camera
from haskell_path_tracer_tpu.models.objects import Camera as JaxCamera
from haskell_path_tracer_torch.app.viewer import ViewerState, serve
from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.convert import camera_to_numpy
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils.config import RenderConfig

torch.set_num_threads(2)
W, H = 32, 24


def _renderer():
    return Renderer(RenderConfig(width=W, height=H, bounces=3, algorithm="inline", device="cpu"))


@pytest.fixture(scope="module")
def viewer():
    server, state, thread = serve(
        world.main_scene("cpu"), world.initial_camera("cpu"), _renderer(), port=0
    )
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    yield f"http://127.0.0.1:{server.server_port}", state
    state.stop = True
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)
    srv_thread.join(timeout=60)
    assert not thread.is_alive() and not srv_thread.is_alive()


def _get(url, timeout=30):
    return urllib.request.urlopen(url, timeout=timeout)


def _post(url):
    return _get(urllib.request.Request(url, method="POST"))


def _status(base):
    return json.loads(_get(base + "/status").read())


def _wait_for(pred, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError("condition not met")


def _wait_for_frame(state):
    def ready():
        with state.lock:
            return bool(state.png)

    _wait_for(ready)


def test_viewer_serves_page_png_and_status(viewer):
    base, state = viewer
    _wait_for_frame(state)
    assert b"path tracer" in _get(base + "/").read()
    png = _get(base + "/image.png").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (W, H)
    idat = png.index(b"IDAT")
    n = struct.unpack(">I", png[idat - 4:idat])[0]
    assert len(zlib.decompress(png[idat + 4:idat + 4 + n])) == H * (1 + 3 * W)
    status = _status(base)
    assert status["iterations"] >= 1 and status["rays_per_s"] > 0
    assert status["error"] is None


def test_viewer_move_resets_accumulation(viewer):
    base, state = viewer
    _wait_for(lambda: _status(base)["iterations"] >= 50, timeout=120)
    before_it = _status(base)["iterations"]
    before = camera_to_numpy(state.camera)
    assert _post(base + "/move?fwd=1&right=0&up=0&dx=5&dy=0&sprint=1").status == 200
    after = camera_to_numpy(state.camera)
    assert not np.allclose(before["position"], after["position"])
    assert state.camera.position.device.type == "cpu"
    # The accumulation restarted: the published count drops below where
    # it was, and frames keep coming.
    _wait_for(lambda: _status(base)["iterations"] < before_it)
    _wait_for(lambda: _status(base)["iterations"] >= 1)
    assert _status(base)["error"] is None


@pytest.mark.parametrize("query", ["fwd=nan", "dx=inf", "dy=-inf&fwd=1"])
def test_viewer_rejects_non_finite_move(viewer, query):
    base, state = viewer
    before = camera_to_numpy(state.camera)
    assert _post(base + "/move?" + query).status == 200
    after = camera_to_numpy(state.camera)
    for f in before:
        np.testing.assert_array_equal(before[f], after[f])
    assert np.isfinite(after["position"]).all()
    assert _status(base)["error"] is None


def test_viewer_refuses_malformed_move(viewer):
    base, _ = viewer
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/move?fwd=abc")
    assert e.value.code == 400


@pytest.mark.parametrize("path", ["/nope", "/image.jpg"])
def test_viewer_404(viewer, path):
    base, _ = viewer
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + path)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + path)
    assert e.value.code == 404


@pytest.mark.parametrize("move", [(1, 0, 0, 0, 0, False), (0.5, -1, 1, 30, -12, True),
                                  (0, 0, 0, 1e6, 0, False)])
def test_apply_move_matches_jax(move):
    """`apply_move`'s camera is the JAX package's `move_camera` on the same
    input, bit for bit, and the state is marked moved."""
    cam = world.initial_camera("cpu")
    state = ViewerState(world.main_scene("cpu"), cam, _renderer(), 0.6, 2.2)
    state.apply_move(*move)
    fwd, right, up, dx, dy, sprint = move
    c = camera_to_numpy(cam)
    want = jax_move_camera(JaxCamera.create(c["position"], c["rotation"], float(c["fov"])),
                           [right, up, -fwd], [dy, dx, 0.0], elapsed=0.05, sprint=sprint)
    got = camera_to_numpy(state.camera)
    for f in ("position", "rotation", "fov"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f), np.float32))
    assert state.moved
