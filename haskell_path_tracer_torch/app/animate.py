"""Offline camera-path renderer (flythrough animation).

Counterpart of ``haskell_path_tracer_tpu/app/animate.py``: a camera path
(a keyframe JSON or a procedural orbit) is rendered frame by frame; each
camera change resets the accumulator and reuses the same `Renderer`, as
the reference's window did when the camera moved.  Each frame is
`Renderer.render(scene, camera, spp, seed=seed + j)` on a fresh
accumulator, written by `save_render` (`.exr` for the raw radiance).  On a
CUDA device the steps launch the algorithm's CUDA kernel, as `app/main.py`
does; `--device` defaults to cuda and raises without a GPU.

Usage:
  python -m haskell_path_tracer_torch.app.animate --frames 90 --orbit \
      --spp 16 -o out/frame_%04d.png
  python -m haskell_path_tracer_torch.app.animate --path path.json \
      --frames 120 --spp 32 -o out/frame_%04d.png
  python -m haskell_path_tracer_torch.app.animate --device cpu --orbit \
      --width 32 --height 24 --frames 2 --spp 4 -o out/f_%02d.exr

path.json: [{"position": [..3], "rotation": [..3], "fov": 90}, ...] —
linearly interpolated (positions lerped, Euler angles lerped per
component).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def interpolate_path(keyframes, num_frames):
    """Piecewise-linear interpolation over keyframes -> num_frames cameras.

    Returns a list of (position, rotation, fov) numpy tuples.
    """
    if not keyframes:
        raise ValueError("a camera path needs at least one keyframe")
    if len(keyframes) == 1:
        k = keyframes[0]
        return [(np.asarray(k["position"], np.float32),
                 np.asarray(k["rotation"], np.float32),
                 float(k.get("fov", 90.0)))] * num_frames
    pos = np.asarray([k["position"] for k in keyframes], np.float32)
    rot = np.asarray([k["rotation"] for k in keyframes], np.float32)
    fov = np.asarray([k.get("fov", 90.0) for k in keyframes], np.float32)
    t = np.linspace(0.0, len(keyframes) - 1.0, num_frames)
    i = np.minimum(t.astype(int), len(keyframes) - 2)
    f = (t - i)[:, None].astype(np.float32)
    p = pos[i] * (1 - f) + pos[i + 1] * f
    r = rot[i] * (1 - f) + rot[i + 1] * f
    v = fov[i] * (1 - f[:, 0]) + fov[i + 1] * f[:, 0]
    return [(p[j], r[j], float(v[j])) for j in range(num_frames)]


def orbit_path(num_frames, radius=6.0, height=-1.0, target_z=-6.0):
    """Procedural orbit around the reference scene's sphere cluster."""
    frames = []
    for j in range(num_frames):
        a = 2.0 * np.pi * j / num_frames
        pos = np.asarray(
            [radius * np.sin(a), height, target_z + radius * np.cos(a)],
            np.float32,
        )
        # Yaw to face the target (world forward is -z, a positive yaw turns
        # toward -x).
        yaw = -np.arctan2(pos[0], -(target_z - pos[2]))
        rot = np.asarray([0.0, yaw, 0.0], np.float32)
        frames.append((pos, rot, 90.0))
    return frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="haskell_path_tracer_torch.app.animate")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=300)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--variant", default="inline",
                   choices=["inline", "wavefront", "streams", "physical"])
    p.add_argument("--scene", default=None)
    p.add_argument("--path", default=None, help="keyframe JSON")
    p.add_argument("--orbit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--exposure", type=float, default=0.6)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; raises without a GPU)")
    p.add_argument("-o", "--output", default="frames/frame_%04d.png",
                   help="printf-style frame pattern")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models import world
    from ..models.convert import camera_to_numpy
    from ..models.io import load_scene
    from ..models.objects import Camera
    from ..render.renderer import Renderer
    from ..utils.config import RenderConfig
    from ..utils.image import save_render
    from ..utils.metrics import log

    algo = "wavefront" if args.variant == "streams" else args.variant
    renderer = Renderer(
        RenderConfig(width=args.width, height=args.height, algorithm=algo,
                     bounces=args.bounces, seed=args.seed, device=args.device)
    )
    device = renderer.device

    if args.scene:
        scene, cam0 = load_scene(args.scene, device)
    else:
        scene, cam0 = world.main_scene(device), world.initial_camera(device)

    if args.path:
        with open(args.path) as f:
            cams = interpolate_path(json.load(f), args.frames)
    elif args.orbit:
        cams = orbit_path(args.frames)
    else:
        c = camera_to_numpy(cam0 if cam0 is not None else world.initial_camera(device))
        cams = [(c["position"], c["rotation"], float(c["fov"]))] * args.frames

    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    for j, (pos, rot, fov) in enumerate(cams):
        camera = Camera.create(pos, rot, fov, device)
        # The camera moved: a fresh accumulator, the same renderer.
        acc = renderer.render(scene, camera, args.spp, seed=args.seed + j)
        path = args.output % j if "%" in args.output else args.output
        save_render(path, renderer.image(acc), exposure=args.exposure)
        if not args.quiet:
            log("frame", index=j, total=len(cams), output=path,
                fps=round((j + 1) / (time.perf_counter() - t0), 3))
    if not args.quiet:
        log("animation_done", frames=len(cams),
            wall_s=round(time.perf_counter() - t0, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
