"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``haskell_path_tracer_torch/csrc`` and
runs six phases, each printing one line; any failure raises and the script
exits non-zero without printing a result:

  1. device: name, power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc of csrc/megakernel.cu, timed;
  3. kernel against its plain PyTorch version on the card, at 800x600 /
     15 bounces / 1 spp, 512x512 / 8 bounces / 4 spp and a ragged 333x97,
     on the reference, mixed-kinds and glass scenes and with Russian
     roulette;
  4. kernel against the JAX package's golden outputs
     (tests/data/torch_port_golden.npz, written by
     tests/torch_port_fixtures.py);
  5. the main path end to end: the CLI renders 800x600, 15 bounces, 64 spp
     on the GPU; every step must go through the kernel and the image must
     be finite, lit, and of the reference scene's mean brightness;
  6. times: forward rays/s at 512x512 / 64 spp / 8 bounces for the kernel
     and the plain version (nominal segments W*H*spp*bounces, with the
     share of them that live paths traced), ms per Renderer.step at
     800x600 / 15 bounces / 1 spp, and one 64-spp launch at 800x600.

Lane tolerance (tests/test_pallas.py): >= 99.5% of lanes with equal rng
words, >= 99% of color values isclose at rtol = atol = 1e-4, and the same
99% among the lit values.

The line before the last is a JSON object of the kernels with their
launches in phase 5 and the numbers measured here; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
RNG_MIN, CLOSE_MIN = 0.995, 0.99
# The reference scene's image mean at 15 bounces (the verify recipe's
# "about 15-20"; negative lanes from the unclamped matte BRDF included).
MEAN_RANGE = (15.0, 20.0)


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def agreement(rng_a, rng_b, color_a, color_b):
    """(rng lane share, color isclose share, isclose share among lit values,
    max |a - b|)."""
    rng_match = (rng_a == rng_b).all(dim=-1).double().mean().item()
    close = torch.isclose(color_a, color_b, rtol=1e-4, atol=1e-4)
    lit = color_b != 0
    lit_close = close[lit].double().mean().item() if lit.any() else 1.0
    return rng_match, close.double().mean().item(), lit_close, (color_a - color_b).abs().max().item()


def check(label: str, got, want) -> dict:
    rng_match, close, lit_close, err = agreement(got[1], want[1], got[0], want[0])
    if not torch.isfinite(got[0]).all():
        raise AssertionError(f"{label}: kernel radiance is not finite")
    if rng_match < RNG_MIN or close < CLOSE_MIN or lit_close < CLOSE_MIN:
        raise AssertionError(
            f"{label}: rng {rng_match:.6f} (>= {RNG_MIN}), close {close:.6f} "
            f"lit {lit_close:.6f} (>= {CLOSE_MIN})"
        )
    return dict(case=label, rng=rng_match, close=close, lit_close=lit_close, max_abs_err=err)


def cuda_times(fn, reps: int) -> dict:
    """Per-call times of `fn` on CUDA events after one warm-up: the median,
    and the highest percentile with at least ten calls beyond it (when that
    percentile lies above the median), in ms."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in events)
    out = {"n": reps, "median_ms": statistics.median(ms)}
    k = reps - 10
    if 2 * k > reps:
        out[f"p{100 * k // reps}_ms"] = ms[k - 1]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from haskell_path_tracer_torch.app.main import main as cli_main
    from haskell_path_tracer_torch.models import convert as C
    from haskell_path_tracer_torch.models import world
    from haskell_path_tracer_torch.models.camera import primary_rays
    from haskell_path_tracer_torch.models.objects import Camera, Rays
    from haskell_path_tracer_torch.ops import megakernel as MK
    from haskell_path_tracer_torch.ops.rng import gen_seeds
    from haskell_path_tracer_torch.render.renderer import Renderer
    from haskell_path_tracer_torch.utils.checkpoint import load_accumulator
    from haskell_path_tracer_torch.utils.config import RenderConfig

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    # 1. Device.
    phase("device", name=name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. Build, from the sources in this checkout.
    lib = MK.library_path()
    if os.path.exists(lib):
        os.unlink(lib)
    t0 = time.perf_counter()
    MK.build()
    phase("build", seconds=time.perf_counter() - t0, library=os.path.relpath(lib, ROOT))

    # Scenes: the reference, all four kinds (from the golden file's mixed
    # case) and the glass variant, each with its camera.
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}

    def golden_scene(case):
        prefix = f"{case}__scene__"
        return C.scene_from_numpy(
            {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}, dev
        )

    main_cam = world.initial_camera(dev)
    scenes = {
        "main": (world.main_scene(dev), main_cam),
        "mixed": (golden_scene("mixed"), Camera.create([0.0] * 3, [0.0] * 3, 90.0, dev)),
        "glass": (golden_scene("glass"), main_cam),
    }
    if not scenes["glass"][0].has_dielectric():
        raise AssertionError("the glass scene has no dielectric")

    # 3. Kernel against its plain version, on the card.
    results = []
    # 333x97 leaves a ragged last block (32301 pixels, not a multiple of 128).
    for (w, h, bounces, spp) in [(800, 600, 15, 1), (512, 512, 8, 4), (333, 97, 6, 2)]:
        cases = [(s, s, False) for s in scenes] + [("glass+roulette", "glass", True)]
        for label, scene_name, rr in cases:
            scene, cam = scenes[scene_name]
            rays = primary_rays(cam, w, h)
            rng = gen_seeds((h, w), len(results), dev)
            args = (scene, rays, rng, bounces, spp, rr)
            got = MK.trace_inline_fused(*args)
            want = MK.trace_inline_fused_reference(*args)
            results.append(check(f"{label} {w}x{h} b{bounces} spp{spp}", got, want))
    torch.cuda.synchronize()
    max_abs_err = max(r["max_abs_err"] for r in results)
    phase("kernel_vs_plain", max_abs_err=max_abs_err, cases=results)

    # 4. Kernel against the JAX package's golden outputs.
    golden_results = []
    for case in ("main", "mixed", "glass"):
        spp, bounces, rr = golden[f"{case}__config"].tolist()
        rays = Rays(
            origin=torch.as_tensor(golden[f"{case}__origin"], device=dev),
            direction=torch.as_tensor(golden[f"{case}__direction"], device=dev),
        )
        got = MK.trace_inline_fused(
            golden_scene(case), rays, C.rng_from_numpy(golden[f"{case}__rng_in"], dev),
            bounces, spp, bool(rr),
        )
        want = (
            torch.as_tensor(golden[f"{case}__radiance"], device=dev),
            C.rng_from_numpy(golden[f"{case}__rng_out"], dev),
        )
        golden_results.append(check(f"golden {case}", got, want))
    torch.cuda.synchronize()
    phase("kernel_vs_jax_golden", cases=golden_results)

    # 5. The main path end to end, through the CLI.
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        png, ckpt = os.path.join(tmp, "render.png"), os.path.join(tmp, "state.npz")
        MK.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli_main([
            "--device", "cuda", "--width", "800", "--height", "600", "--bounces", "15",
            "--spp", "64", "--seed", "0", "--quiet", "--checkpoint", ckpt, "-o", png,
        ])
        wall = time.perf_counter() - t0
        launches = MK.LAUNCHES
        acc, _ = load_accumulator(ckpt, "cpu")
        png_bytes = os.path.getsize(png)
    img = acc.image.numpy()
    mean = float(img.mean())
    lit = float((img.sum(-1) > 1e-3).mean())
    phase("main_path", rc=rc, launches=launches, iterations=acc.iterations, wall_s=wall,
          mean=mean, lit_share=lit, png_bytes=png_bytes)
    if rc != 0 or acc.iterations != 64:
        raise AssertionError(f"CLI returned {rc} after {acc.iterations} samples")
    if launches < 64:
        raise AssertionError(f"the main path launched the kernel {launches} times (< 64)")
    if not np.isfinite(img).all() or lit == 0.0:
        raise AssertionError("the image is not finite, or all black")
    if not MEAN_RANGE[0] <= mean <= MEAN_RANGE[1]:
        raise AssertionError(f"image mean {mean} outside {MEAN_RANGE}")

    # 6. Times, per call on CUDA events after a warm-up.  The kernel is
    # timed on tables packed once (its own time); the plain version and
    # the Renderer steps include their host work.
    scene, cam = scenes["main"]
    tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))

    def kernel(rays, rng, bounces, spp):
        return lambda: MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, False)

    def plain(rays, rng, bounces, spp):
        return lambda: MK.trace_inline_fused_reference(scene, rays, rng, bounces, spp, False, 3, False)

    rays512, rng512 = primary_rays(cam, 512, 512), gen_seeds((512, 512), 0, dev)
    rays800, rng800 = primary_rays(cam, 800, 600), gen_seeds((600, 800), 0, dev)
    fwd = {"kernel": cuda_times(kernel(rays512, rng512, 8, 64), 30),
           "plain": cuda_times(plain(rays512, rng512, 8, 64), 3)}
    segments = 512 * 512 * 64 * 8
    # Bounces a path really traced: its rng counter advances by 3 per live
    # bounce, and the kernel leaves a path at its first dead one.
    _, rng_out = kernel(rays512, rng512, 8, 64)()
    live = ((rng_out[..., 3] - rng512[..., 3]).double().sum() / 3).item()
    one = {"kernel": cuda_times(kernel(rays800, rng800, 15, 1), 50),
           "plain": cuda_times(plain(rays800, rng800, 15, 1), 11)}
    spp64 = cuda_times(kernel(rays800, rng800, 15, 64), 30)
    steps = {}
    for choice, reps in (("auto", 50), ("torch", 11)):
        renderer = Renderer(RenderConfig(kernel=choice, device="cuda"))
        acc = renderer.init_accumulator(seed=0)
        steps[choice] = cuda_times(lambda: renderer.step(scene, cam, acc, spp=1), reps)
    phase(
        "times",
        nvidia_smi=smi,
        fwd_512x512_spp64_b8={
            **fwd,
            "kernel_segments_per_s": segments / (fwd["kernel"]["median_ms"] / 1e3),
            "plain_segments_per_s": segments / (fwd["plain"]["median_ms"] / 1e3),
            "live_segment_share": live / segments,
        },
        call_800x600_b15_spp1=one,
        kernel_800x600_b15_spp64=spp64,
        renderer_step_800x600_b15_spp1={"kernel_auto": steps["auto"], "kernel_torch": steps["torch"]},
    )

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel.py:558",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": one["kernel"]["median_ms"],
        "plain_ms": one["plain"]["median_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
