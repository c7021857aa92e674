"""Lightweight live viewer: a localhost HTTP progressive-render monitor.

Counterpart of ``haskell_path_tracer_tpu/app/viewer.py``.  The reference
showed its progressive render in an SDL window with WASD + mouselook and an
iteration-count overlay; here the window is a dependency-free local page:

  * a background thread runs the progressive render loop with the
    reference's batching schedule (`Renderer.batch_size`, at most 32
    samples a step); on a CUDA device its steps launch the algorithm's CUDA
    kernel on the current stream of that device, from this thread;
  * the page polls `/image.png` (the tonemapped latest accumulator, numpy
    tonemap and PNG encoder in memory) and `/status` (iterations, rays/s
    and the render thread's error, if it stopped on one);
  * WASD / drag input POSTs to `/move`; a camera move resets the
    accumulator and keeps the same renderer, and a frame rendered for the
    old camera is dropped.

Stdlib http.server only; nothing leaves localhost.  Start with:

    python -m haskell_path_tracer_torch.app.viewer --width 400 --height 300
    python -m haskell_path_tracer_torch.app.viewer --device cpu --width 64 --height 48

The kernels build at first use, on the render thread: a failed build shows
as `error` in `/status`, not as an exit code.
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils.image import encode_png, tonemap
from .interact import move_camera

_PAGE = """<!doctype html>
<html><head><title>path tracer (PyTorch)</title><style>
body { background: #111; color: #ddd; font: 14px monospace; text-align: center; }
img  { image-rendering: pixelated; margin-top: 1em; outline: 1px solid #333; }
#bar { margin-top: .5em; }
</style></head><body>
<div id="bar">connecting…</div>
<img id="view" width="%(w)d" height="%(h)d">
<div>WASD/space/ctrl move · drag to look · shift sprint</div>
<script>
const img = document.getElementById('view'), bar = document.getElementById('bar');
let keys = {}, dragging = false, lx = 0, ly = 0, dx = 0, dy = 0;
onkeydown = e => keys[e.key.toLowerCase()] = true;
onkeyup   = e => keys[e.key.toLowerCase()] = false;
img.onmousedown = e => { dragging = true; lx = e.clientX; ly = e.clientY; e.preventDefault(); };
onmouseup   = () => dragging = false;
onmousemove = e => { if (dragging) { dx += e.clientX - lx; dy += e.clientY - ly; lx = e.clientX; ly = e.clientY; } };
function refresh() { img.src = '/image.png?t=' + Date.now(); }
img.onload = () => setTimeout(refresh, 100);
img.onerror = () => setTimeout(refresh, 500);
refresh();
setInterval(async () => {
  const t = (keys.w?1:0)-(keys.s?1:0), r = (keys.d?1:0)-(keys.a?1:0),
        u = (keys[' ']?1:0)-(keys.control?1:0);
  if (t || r || u || dx || dy) {
    await fetch('/move?fwd='+t+'&right='+r+'&up='+u+'&dx='+dx+'&dy='+dy+
                '&sprint='+(keys.shift?1:0), {method:'POST'});
    dx = dy = 0;
  }
  const s = await (await fetch('/status')).json();
  bar.textContent = s.error ? 'render error: ' + s.error
    : s.iterations + ' spp · ' + (s.rays_per_s/1e6).toFixed(1) + ' Mrays/s';
}, 50);
</script></body></html>"""


class ViewerState:
    """One lock, one snapshot: the camera, the accumulator, the latest PNG
    and the counters the page reads."""

    def __init__(self, scene, camera, renderer, exposure, gamma):
        self.lock = threading.Lock()
        self.scene = scene
        self.camera = camera
        self.renderer = renderer
        self.exposure = exposure
        self.gamma = gamma
        self.acc = renderer.init_accumulator()
        self.png = b""
        self.iterations = 0
        self.rays_per_s = 0.0
        self.moved = False
        self.stop = False
        self.error = None

    def apply_move(self, fwd, right, up, dx, dy, sprint):
        """Move the camera by one frame of input; non-finite input (e.g.
        /move?fwd=nan) is rejected before it reaches the camera."""
        if not all(math.isfinite(v) for v in (fwd, right, up, dx, dy)):
            return
        with self.lock:
            self.camera = move_camera(
                self.camera,
                # camera-local axes: x right, y up, z backward (forward is -z)
                [right, up, -fwd],
                [dy, dx, 0.0],
                elapsed=0.05,
                sprint=sprint,
            )
            self.moved = True


def render_loop(state: ViewerState):
    """Step, publish, repeat; a camera move restarts the accumulation with
    the same renderer.  A crash is recorded in `state.error` (shown by
    /status) instead of silently ending the thread."""
    try:
        _render_loop(state)
    except Exception as e:  # the thread's boundary: report, then stop
        with state.lock:
            state.error = f"{type(e).__name__}: {e}"
        traceback.print_exc()


def _render_loop(state: ViewerState):
    renderer = state.renderer
    done = 0
    while not state.stop:
        with state.lock:
            if state.moved:
                state.acc = renderer.init_accumulator()
                done = 0
                state.moved = False
            scene, camera, acc = state.scene, state.camera, state.acc
        n = min(renderer.batch_size(done), 32)
        t0 = time.perf_counter()
        acc = renderer.step(scene, camera, acc, spp=n)
        img = renderer.image(acc)  # waits for the device
        dt = time.perf_counter() - t0
        done += n
        # Row 0 carries the downward rays; image files put row 0 at the
        # top, so flip, as save_render does.
        png = encode_png(tonemap(img[::-1], state.exposure, state.gamma))
        cfg = renderer.config
        with state.lock:
            if state.moved:
                continue  # rendered for the old camera: drop it
            state.acc = acc
            state.png = png
            state.iterations = done
            state.rays_per_s = cfg.width * cfg.height * cfg.bounces * n / dt


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/":
                cfg = state.renderer.config
                page = _PAGE % {"w": cfg.width, "h": cfg.height}
                self._send(200, "text/html", page.encode())
            elif path == "/image.png":
                with state.lock:
                    png = state.png
                if not png:
                    self._send(503, "text/plain", b"rendering")
                else:
                    self._send(200, "image/png", png)
            elif path == "/status":
                with state.lock:
                    body = json.dumps(
                        {
                            "iterations": state.iterations,
                            "rays_per_s": round(state.rays_per_s),
                            "error": state.error,
                        }
                    ).encode()
                self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            u = urlparse(self.path)
            if u.path == "/move":
                q = parse_qs(u.query)

                def f(k):
                    return float(q.get(k, ["0"])[0])

                try:
                    move = (f("fwd"), f("right"), f("up"), f("dx"), f("dy"),
                            bool(int(q.get("sprint", ["0"])[0])))
                except ValueError:
                    self._send(400, "text/plain", b"bad move")
                    return
                state.apply_move(*move)
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(
    scene,
    camera,
    renderer,
    host: str = "127.0.0.1",
    port: int = 8265,
    exposure: float = 0.6,
    gamma: float = 2.2,
):
    """Start the render thread and bind the HTTP server (port 0 picks a
    free port).  Returns (server, state, thread); the caller runs
    `server.serve_forever()`, and to stop sets `state.stop`, shuts the
    server down and joins the thread."""
    state = ViewerState(scene, camera, renderer, exposure, gamma)
    thread = threading.Thread(target=render_loop, args=(state,), daemon=True)
    thread.start()
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.state = state
    return server, state, thread


def main(argv=None) -> int:
    from ..models import world
    from ..models.io import load_scene
    from ..render.renderer import Renderer
    from ..utils.config import add_cli_args, config_from_args

    p = argparse.ArgumentParser(prog="haskell_path_tracer_torch.app.viewer")
    add_cli_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265)
    p.add_argument("--scene", default=None)
    p.add_argument("--exposure", type=float, default=0.6)
    p.add_argument("--gamma", type=float, default=2.2)
    args = p.parse_args(argv)

    renderer = Renderer(config_from_args(args))
    device = renderer.device
    if args.scene:
        scene, camera = load_scene(args.scene, device)
        if camera is None:
            camera = world.initial_camera(device)
    else:
        scene, camera = world.main_scene(device), world.initial_camera(device)

    server, state, thread = serve(
        scene, camera, renderer,
        host=args.host, port=args.port,
        exposure=args.exposure, gamma=args.gamma,
    )
    print(f"viewing at http://{args.host}:{server.server_port}/  (Ctrl-C stops)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop = True
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
