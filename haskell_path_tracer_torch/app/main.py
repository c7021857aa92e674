"""CLI renderer.

Counterpart of ``haskell_path_tracer_tpu/app/main.py``: the reference's
progressive batching schedule and periodic reseeding, an image file in
place of the window, and checkpoint/resume.  `--variant inline` (the
default) renders the reference's parity estimator, `--variant wavefront`
(or `streams`) the wavefront integrator (`--split` for deterministic
dielectric splitting, `--queue-factor` its stack slots; `--stats` logs its
occupancy telemetry after the render), `--variant physical` the corrected
BRDFs with next-event estimation (`--no-nee` for BSDF sampling alone); all
log the same per-phase lines.

Usage:
  python -m haskell_path_tracer_torch.app.main --device cuda \
      --width 800 --height 600 --spp 64 -o out.png
  python -m haskell_path_tracer_torch.app.main --variant physical -o out.png
  python -m haskell_path_tracer_torch.app.main --variant wavefront --split \
      --stats -o out.png
  python -m haskell_path_tracer_torch.app.main --scene scene.json \
      --checkpoint state.npz --checkpoint-every 500 --resume -o out.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from ..utils.config import add_cli_args

    p = argparse.ArgumentParser(
        prog="haskell_path_tracer_torch",
        description="Progressive path tracer on PyTorch (CUDA megakernels on a GPU)",
    )
    add_cli_args(p)
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument(
        "--scene", default=None,
        help="scene JSON (models/io.py schema); default: the built-in "
        "reference scene",
    )
    p.add_argument("--exposure", type=float, default=0.6)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="write the checkpoint every N samples (0 = only at the end)",
    )
    p.add_argument("--resume", action="store_true")
    p.add_argument(
        "--save-scene", default=None,
        help="dump the active scene (+camera) to JSON and exit",
    )
    p.add_argument("--profile-dir", default=None, help="torch.profiler trace dir")
    p.add_argument(
        "--stats", action="store_true",
        help="log wavefront telemetry (per-bounce live-ray occupancy + "
        "bounce-depth histogram) after rendering; wavefront variant only",
    )
    p.add_argument("--quiet", action="store_true")
    return p


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models import world
    from ..models.io import load_scene, save_scene
    from ..render.renderer import Renderer
    from ..utils import metrics as M
    from ..utils.checkpoint import load_accumulator, save_accumulator
    from ..utils.config import config_from_args
    from ..utils.image import save_render

    config = config_from_args(args)
    renderer = Renderer(config)
    device = renderer.device

    if args.scene:
        scene, camera = load_scene(args.scene, device)
        if camera is None:
            camera = world.initial_camera(device)
    else:
        scene, camera = world.main_scene(device), world.initial_camera(device)

    if args.save_scene:
        save_scene(args.save_scene, scene, camera)
        print(f"wrote {args.save_scene}")
        return 0

    m = M.RenderMetrics(
        width=config.width, height=config.height, bounces=config.bounces
    )

    acc = None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        acc, _ = load_accumulator(args.checkpoint, device)
        if not args.quiet:
            M.log("resume", iterations=acc.iterations)
    if acc is None:
        acc = renderer.init_accumulator(seed=config.seed)

    total = args.spp
    done = acc.iterations
    t_start = time.perf_counter()
    with M.profiler_trace(args.profile_dir):
        while done < total:
            n = min(renderer.batch_size(done), total - done)
            prev = done
            with m.phase("render"):
                acc = renderer.step(scene, camera, acc, spp=n)
                _sync(device)
            done += n
            m.dispatches += 1
            m.samples = done
            if renderer.should_reseed(prev, done):
                with m.phase("reseed"):
                    acc = renderer.reseed(acc)
            if (
                args.checkpoint
                and args.checkpoint_every
                and (prev // args.checkpoint_every) != (done // args.checkpoint_every)
            ):
                with m.phase("checkpoint"):
                    save_accumulator(args.checkpoint, acc)
            if not args.quiet:
                M.log(
                    "progress",
                    spp=done,
                    total=total,
                    rays_per_s=round(
                        config.width * config.height * config.bounces * done
                        / (time.perf_counter() - t_start)
                    ),
                )
    m.wall_seconds = time.perf_counter() - t_start

    if args.checkpoint:
        save_accumulator(args.checkpoint, acc)

    with m.phase("write"):
        save_render(
            args.output, renderer.image(acc),
            exposure=args.exposure, gamma=args.gamma,
        )
    if args.stats:
        stats = renderer.wavefront_stats(scene, camera, acc)
        if stats is None:
            M.log("stats_unavailable", variant=config.algorithm)
        else:
            M.log("wavefront_stats", **stats)
    if not args.quiet:
        M.log("done", output=args.output)
        print(m.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
