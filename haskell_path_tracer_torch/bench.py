"""The headline benchmark: fwd+bwd ray segments per second on the
differentiable parity path, the port of the JAX package's ``bench.py``.

    python -m haskell_path_tracer_torch.bench [--device cpu] [--width W]
        [--height H] [--spp N] [--bounces B] [--reps R]

One gradient evaluation is ``torch.autograd.grad`` of ``sum(radiance)``
through `trace_inline_fused_diff` (the forward and backward megakernels on
CUDA), from the reference scene's `SceneParams`, at 512x512 / 64 spp / 8
bounces by default.  On the card it is timed on CUDA events, one pair
around each call after two warm-up calls, and the median of `--reps` calls
is taken.  A ray segment is one lane-step of the bounce loop, W x H x spp
x bounces, counted as ``bench.py`` counts it (dead lanes included).

Earlier lines print the card's name and power limit (nvidia-smi) and the
times; the last line is one JSON object with ``bench.py``'s keys:
``metric``, ``value``, ``unit`` and ``vs_baseline`` against ``bench.py``'s
north-star of 5e8 rays/s.  The device is ``cuda`` unless ``--device cpu``
is given; there the metric is named for the CPU and timed on the host
clock (a check that the path runs, not a measurement of a device).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from .diff.grad import SceneParams, params_to_scene, scene_to_params
from .models import world
from .models.camera import primary_rays
from .ops.megakernel_vjp import trace_inline_fused_diff
from .ops.rng import gen_seeds

# bench.py's north-star: 5e8 ray segments per second per chip, fwd+bwd.
TARGET_RAYS_PER_S = 5.0e8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("bench: no CUDA GPU available (--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                          "torch": torch.__version__, "cuda": torch.version.cuda}))
    else:
        print(json.dumps({"device": "cpu", "torch": torch.__version__}))

    w, h, spp, bounces = args.width, args.height, args.spp, args.bounces
    scene, camera = world.main_scene(dev), world.initial_camera(dev)
    rays = primary_rays(camera, w, h)
    rng = gen_seeds((h, w), 0, dev)
    params = scene_to_params(scene)
    has_dielectric = scene.has_dielectric()

    def step():
        leaves = [p.detach().requires_grad_() for p in params]
        radiance, _ = trace_inline_fused_diff(
            params_to_scene(SceneParams(*leaves), scene), rays, rng,
            num_bounces=bounces, spp=spp, has_dielectric=has_dielectric)
        return torch.autograd.grad(radiance.sum(), leaves, allow_unused=True)

    for _ in range(2):
        step()
    ms = []
    if cuda:
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(args.reps)]
        for start, end in events:
            start.record()
            step()
            end.record()
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in events]
    else:
        for _ in range(args.reps):
            t0 = time.perf_counter()
            step()
            ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(ms)
    segments = w * h * spp * bounces
    print(json.dumps({"step_ms_median": median, "n": args.reps, "step_ms": ms,
                      "segments": segments}))
    rays_per_s = segments / (median / 1e3)
    where = "chip" if cuda else "cpu"
    print(json.dumps({
        "metric": f"ray_segments_per_s_{where}_fwd+bwd_{w}x{h}x{spp}sppx{bounces}b",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / TARGET_RAYS_PER_S,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
