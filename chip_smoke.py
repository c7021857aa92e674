"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's three CUDA libraries from ``haskell_path_tracer_torch/csrc``
(one nvcc each, started together) and runs fifteen phases, each printing
one line; any failure raises and the script exits non-zero without
printing a result:

  1. device: name, power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc of csrc/megakernel.cu, csrc/megakernel_vjp.cu and
     csrc/nee_megakernel.cu (the NEE kernel and the probe), timed;
  3. forward kernel against its plain PyTorch version on the card, at
     800x600 / 15 bounces / 1 spp, 512x512 / 8 bounces / 4 spp and a
     ragged 333x97, on the reference, mixed-kinds and glass scenes and with
     Russian roulette;
  4. forward kernel against the JAX package's golden outputs
     (tests/data/torch_port_golden.npz, written by
     tests/torch_port_fixtures.py);
  5. the serving path end to end: the CLI renders 800x600, 15 bounces,
     64 spp on the GPU; every step must go through the kernel and the image
     must be finite, lit, and of the reference scene's mean brightness;
  6. forward times: rays/s at 512x512 / 64 spp / 8 bounces for the kernel
     and the plain version (nominal segments W*H*spp*bounces, with the
     share of them that live paths traced), ms per Renderer.step at
     800x600 / 15 bounces / 1 spp, and one 64-spp launch at 800x600; the
     live bounces by winning row at both shapes, for the bounds;
  7. backward kernel against its plain version on the card (autograd of
     the plain trace), through the autograd Function, at 128x96 / 4 bounces
     / 2 spp and a ragged 67x29 / 3 bounces / 1 spp on the three scenes,
     each seen by its camera pitched 0.3 rad further down, and at the
     training path's shapes on the reference scene seen by its own camera:
     512x512 / 64 spp / 8 bounces and 3840x2160 / 1 spp / 4 bounces, one
     kernel launch on the whole image against the plain backward over row
     tiles; the Function's forward must equal the forward kernel's output
     bit for bit, and the kernel must refuse 17 bounces;
  8. backward kernel against the JAX package's golden gradients;
  9. the training path end to end: `loss_and_grad` and an SGD update on the
     reference scene towards a target rendered with the emitters' light
     x1.5, 5 steps at 512x512 / 64 spp / 8 bounces (bench.py's shape) and
     2 at 3840x2160 / 1 spp / 4 bounces (benchmarks/suite.py config 5's);
     every step launches each kernel once, every gradient is finite, and
     the loss falls;
 10. training times: fwd+bwd segments/s at 512x512 / 64 spp / 8 bounces
     (counted as bench.py counts them), the backward kernel alone, ms per
     SGD step at both shapes, and the plain backward at 128x96;
 11. NEE kernel against its plain version (`trace_physical_nee_reference`)
     on the card: the reference scene at 800x600 / 15 bounces / 2 spp,
     Cornell at 512x512 / 16 spp / 4 bounces (suite config 6), glass,
     triangle emitters (config 8's scene), boxes and triangles, no emitter,
     1000 spheres at 480x272 / 4 spp / 4 bounces (config 4's scene) and
     20000 spheres, whose tables do not fit shared memory; the live-bounce
     telemetry must equal the plain version's;
 12. NEE kernel against the JAX package's outputs
     (tests/data/torch_port_nee_golden.npz);
 13. probe against the plain fold (eps = 0) on the config-4 scene, and
     presort against raster order, bit for bit;
 14. the physical serving path end to end: the CLI with `--variant
     physical` renders the reference scene at 800x600, 15 bounces, 64 spp
     (one NEE launch per step, lane parity with the same CLI run with
     `--kernel torch`), then the config-4 scene from a scene file at
     800x600 / 15 bounces / 131 spp, whose 30-sample batch takes the
     presort route (one probe launch);
 15. NEE times: the kernel at configs 6 and 8 (512x512 / 16 spp / 4
     bounces) and 4 (1920x1088 / 256 spp / 4 bounces, presort on and off)
     with the live share from the telemetry, the probe alone, the kernel
     and its plain version at the serving shape (800x600 / 15 / 1 spp),
     and `Renderer.step` at 1 spp.

Lane tolerance of the forward (tests/test_pallas.py): >= 99.5% of lanes
with equal rng words, >= 99% of color values isclose at rtol = atol =
1e-4, and the same 99% among the lit values.  Gradient tolerance
(tests/test_pallas_vjp.py): a scale-normalised error
max|a - b| / (max|b| + 1e-6) below 1e-2 for the ray cotangents and for
every column of the table cotangents' sphere and plane rows, 2e-2 for the
columns of the box and triangle rows.

NEE tolerance (tests/test_pallas_nee.py:assert_lane_parity): at most 0.5%
of lanes with a differing rng, and radiance within 1e-4 + 1e-3 |ref| on
all but 0.5% of the others.  Probe: the winner equal on >= 99.95% of lanes
and t within 1e-6 relative where it is.

The line before the last is a JSON object of the kernels with their
launches on the three main paths (phases 5, 9 and 14), their times, their
plain versions' and their bounds at each path's shape (the forward and
the NEE kernel at 800x600 / 15 bounces / 1 spp, the backward at 512x512 /
64 spp / 8 bounces, the probe at 800x600 on the config-4 scene); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from haskell_path_tracer_torch.app.main import main as cli_main  # noqa: E402
from haskell_path_tracer_torch.diff import grad as G  # noqa: E402
from haskell_path_tracer_torch.models import convert as C  # noqa: E402
from haskell_path_tracer_torch.models import world  # noqa: E402
from haskell_path_tracer_torch.models.camera import primary_rays  # noqa: E402
from haskell_path_tracer_torch.models.objects import Camera, Rays  # noqa: E402
from haskell_path_tracer_torch.ops import megakernel as MK  # noqa: E402
from haskell_path_tracer_torch.ops import megakernel_vjp as V  # noqa: E402
from haskell_path_tracer_torch.ops import nee as NE  # noqa: E402
from haskell_path_tracer_torch.ops.intersect import INFINITE, nearest_t_prim  # noqa: E402
from haskell_path_tracer_torch.models import scenes as SC  # noqa: E402
from haskell_path_tracer_torch.models.io import save_scene  # noqa: E402
from haskell_path_tracer_torch.render.nee import _present_kinds  # noqa: E402
from haskell_path_tracer_torch.ops.rng import gen_seeds, gen_vec  # noqa: E402
from haskell_path_tracer_torch.render.renderer import Renderer  # noqa: E402
from haskell_path_tracer_torch.utils.checkpoint import load_accumulator  # noqa: E402
from haskell_path_tracer_torch.utils.config import RenderConfig  # noqa: E402
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
NEE_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_nee_golden.npz")
RNG_MIN, CLOSE_MIN = 0.995, 0.99
# The reference scene's image mean at 15 bounces (the verify recipe's
# "about 15-20"; negative lanes from the unclamped matte BRDF included).
MEAN_RANGE = (15.0, 20.0)
GRAD_TOL, GRAD_TOL_BOX_TRI = 1e-2, 2e-2
# Pitch of phase 7's cameras below each scene's own: no lane grazes a
# sphere (tests/test_pallas_vjp.py), and the rays still meet the spheres.
PITCH = 0.3
LR = 1e-6  # SGD step of benchmarks/suite.py config 5

# Bounds: the least time the card could take for a kernel's work, the
# larger of its bytes over the memory rate and its fp32 operations over the
# fp32 rate outside the tensor cores (H100 SXM data sheet, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations counted from csrc/bounce.cuh that the kernels' functions
# need: each add, sub, mul, div, sqrt, sin, cos, min, max and int->float
# conversion is one (the kernels are built with -fmad=false, so there is no
# FMA).  Compares, selects, sign flips and integer work are not counted, nor
# the fold of the bounce where a path ends, so the bound is low, never high.
# A live bounce is counted by its winner's kind (sphere, plane, box,
# triangle) and BRDF (matte, glossy, dielectric), from this run's data
# (`live_bounce_mix`).
# One primitive test of the fold, for every row at every live bounce:
FOLD_OPS = (20, 14, 25, 46)  # sphere, plane, box, triangle
# A live bounce, whatever it hit: the 3 uniforms (12), the dead test (5),
# the hit point (6), emission, throughput and next origin (18), the
# radiance sum (3):
BOUNCE_OPS = 44
# The winner's normal after the hit point, by kind:
NORMAL_OPS = (13, 0, 27, 0)
# The BRDF sample the winner's kind selects, with the throughput scale:
# matte (69 + 1), glossy (83 + 1), dielectric (the Fresnel choice and the
# cheaper of its two branches, the reflection: 38).  The forward kernel
# computes both the matte and the glossy sample; only one is needed.
SAMPLE_OPS = (70, 84, 38)
# The reverse of a live bounce, without recomputing what the replay
# computed: emission and throughput (48), next ray (6), hit point (15) ...
REVERSE_BOUNCE_OPS = 69
# ... the sample's reverse: matte (87), glossy (175 and the reflection's
# 30), dielectric (the reflected branch, 3 and 30) ...
REVERSE_SAMPLE_OPS = (87, 205, 33)
# ... and the winner's normal, distance and row sums: sphere (26 + 32 + 9
# nonzero entries), plane (3 + 33 + 11), box (0 + 39 + 11), triangle
# (3 + 82 + 17).
REVERSE_GEOM_OPS = (67, 47, 50, 102)
# Bytes each kernel must move per pixel: rays 24 and rng 16 in, radiance 12
# and rng 16 out (forward); rays 24, rng 16 and the radiance cotangent 12
# in, ray cotangents 24 out (backward).  The tables add 4 B per entry.
FWD_BYTES_PER_PIXEL = 68
BWD_BYTES_PER_PIXEL = 76


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


def live_segments(rng_in, rng_out) -> float:
    """Bounces that live paths traced: a path's rng counter advances by 3
    per live bounce, and the kernels leave a path at its first dead one."""
    return ((rng_out[..., 3] - rng_in[..., 3]).double().sum() / 3).item()


def live_bounce_mix(tables, rays, rng, bounces, spp, has_dielectric):
    """Live bounces per winning table row [P], from the plain trace's
    decisions on these inputs (the kernels take the same ones)."""
    geom, mat, counts = tables
    per_row = torch.zeros(sum(counts), dtype=torch.int64, device=rng.device)
    o0, d0 = rays.origin.unbind(-1), rays.direction.unbind(-1)
    with torch.no_grad():
        for _ in range(spp):
            o, d, th = o0, d0, (torch.ones_like(o0[0]),) * 3
            for _ in range(bounces):
                v, rng2 = gen_vec(rng)
                best = MK._nearest_hit_fold(geom, mat, counts, *o, *d)["best"]
                o, d, th, _, dead = MK.bounce_reference(
                    geom, mat, counts, o, d, th, v.unbind(-1), has_dielectric)
                per_row += torch.bincount(best[~dead], minlength=len(per_row))
                rng = torch.where(dead[..., None], rng, rng2)
    return per_row.tolist()


def bounce_ops(tables, per_row, has_dielectric, backward) -> int:
    """fp32 operations the forward (or the backward, replay included)
    needs for live bounces `per_row` (`live_bounce_mix`)."""
    geom, mat, counts = tables
    kinds = [k for k, n in enumerate(counts) for _ in range(n)]
    brdfs = [int(b) if (b != 2 or has_dielectric) else 0 for b in mat[:, 5].tolist()]
    ops = sum(per_row) * (sum(n * f for n, f in zip(counts, FOLD_OPS)) + BOUNCE_OPS)
    for n, kind, brdf in zip(per_row, kinds, brdfs):
        ops += n * (NORMAL_OPS[kind] + SAMPLE_OPS[brdf])
        if backward:
            ops += n * (REVERSE_BOUNCE_OPS + REVERSE_SAMPLE_OPS[brdf] + REVERSE_GEOM_OPS[kind])
    return ops


def table_bytes(tables) -> int:
    geom, mat, _ = tables
    return 4 * (geom.numel() + mat.numel())


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def norm_err(a, b, dim=None):
    """max|a - b| / (max|b| + 1e-6), over the whole tensor or per column."""
    if dim is None:
        return ((a - b).abs().max() / (b.abs().max() + 1e-6)).item()
    return (a - b).abs().amax(dim) / (b.abs().amax(dim) + 1e-6)


KINDS = ("sphere", "plane", "box", "triangle")


def grad_errors(label, got, want, counts) -> dict:
    """Scale-normalised errors of the backward's four outputs.  A table's
    error is taken per column and per kind of row, so that a column of
    small cotangents (brdf_param beside illuminance) is held to its own
    scale: 1e-2 for the rows of spheres and planes, 2e-2 for those of boxes
    and triangles.  Reports each kind's worst column."""
    bounds = np.cumsum([0, *counts]).tolist()
    errs, bad = {}, {}
    for name, g, w in zip(("d_geom", "d_mat", "d_origin", "d_direction"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {name} is not finite")
        if name in ("d_geom", "d_mat"):
            for k, kind in enumerate(KINDS):
                lo, hi = bounds[k], bounds[k + 1]
                if lo == hi:
                    continue
                cols = norm_err(g[lo:hi], w[lo:hi], dim=0)
                key = f"{name}_{kind}"
                errs[key] = cols.max().item()
                if errs[key] >= (GRAD_TOL_BOX_TRI if k >= 2 else GRAD_TOL):
                    bad[key] = cols.tolist()
        else:
            errs[name] = norm_err(g, w)
            if errs[name] >= GRAD_TOL:
                bad[name] = errs[name]
    if bad:
        raise AssertionError(f"{label}: normalised gradient errors {bad}")
    return {"case": label, **errs,
            "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
            "max_abs": {n: w.abs().max().item() for n, w in
                        zip(("d_geom", "d_mat", "d_origin", "d_direction"), want)}}


def plain_backward(tables, rays, rng, wts, bounces, spp, has_dielectric, rows):
    """`backward_reference` over tiles of `rows` image rows: the pixels are
    independent, so the tiles' table cotangents add up and their ray
    cotangents stack."""
    parts = [V.backward_reference(
        *tables, Rays(origin=rays.origin[r:r + rows], direction=rays.direction[r:r + rows]),
        rng[r:r + rows], wts[r:r + rows], bounces, spp, has_dielectric)
        for r in range(0, len(rng), rows)]
    return (sum(p[0] for p in parts), sum(p[1] for p in parts),
            torch.cat([p[2] for p in parts]), torch.cat([p[3] for p in parts]))


def function_vs_plain(label, tables, has_dielectric, rays, rng, bounces, spp, seed, rows):
    """The Function's forward and backward, with loss = sum(radiance * wts),
    against the forward kernel and the plain backward on the same inputs;
    the plain backward timed on CUDA events (one call, over its tiles)."""
    geom, mat, counts = tables
    h, w = rng.shape[:2]
    wts = torch.as_tensor(
        np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32), device=rng.device)
    leaves = [t.clone().requires_grad_() for t in (geom, mat, rays.origin, rays.direction)]
    radiance, rng_out = V.TraceInlineFusedDiff.apply(*leaves, rng, counts, bounces, spp, has_dielectric)
    fwd = MK.launch_kernel(geom, mat, counts, rays, rng, bounces, spp, False, 3, has_dielectric)
    if not (torch.equal(radiance.detach(), fwd[0]) and torch.equal(rng_out, fwd[1])):
        raise AssertionError(f"{label}: the Function's forward is not the forward kernel's")
    got = torch.autograd.grad((radiance * wts).sum(), leaves)
    torch.cuda.reset_peak_memory_stats(rng.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_backward(tables, rays, rng, wts, bounces, spp, has_dielectric, rows)
    end.record()
    torch.cuda.synchronize()
    if not (want[1].abs().max() > 0):
        raise AssertionError(f"{label}: the material gradient is all zero")
    return {**grad_errors(label, got, want, counts), "plain_ms": start.elapsed_time(end),
            "peak_gib": torch.cuda.max_memory_allocated(rng.device) / 2**30}


def backward_vs_plain(scenes, dev) -> list:
    """Phase 7: the Function against the forward kernel and the plain
    backward, on the three scenes pitched at small shapes, and on the
    reference scene seen by its own camera at 3840x2160 / 1 spp / 4
    bounces (the plain backward over tiles of 540 rows).  The backward
    kernel refuses more bounces than its replay keeps."""
    results = []
    for (w, h, bounces, spp) in [(128, 96, 4, 2), (67, 29, 3, 1)]:
        for name, (scene, cam) in scenes.items():
            rot = cam.rotation.tolist()
            pitched = Camera.create(cam.position.tolist(), [rot[0] - PITCH, rot[1], rot[2]], 90.0, dev)
            seed = len(results)
            tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
            results.append(function_vs_plain(
                f"{name} {w}x{h} b{bounces} spp{spp}", tables, scene.has_dielectric(),
                primary_rays(pitched, w, h), gen_seeds((h, w), seed, dev), bounces, spp, seed, h))
    scene, cam = scenes["main"]
    tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
    w, h = 3840, 2160
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)
    results.append(function_vs_plain(f"main {w}x{h} b4 spp1", tables, False, rays, rng, 4, 1, w, 540))
    before = V.LAUNCHES
    try:
        V.launch_backward(*tables, rays, rng, torch.zeros_like(rays.origin), 17, 1, False)
    except ValueError:
        pass
    else:
        raise AssertionError("the backward kernel took 17 bounces")
    if V.LAUNCHES != before:
        raise AssertionError("a refused backward launch was counted")
    return results


def backward_main_shape(tables, rays, rng, mix) -> dict:
    """Phase 7 at the training path's shape, 512x512 / 64 spp / 8 bounces:
    the check, the backward kernel's time, the plain backward's (one
    sample at a time) and the kernel's bound, on the same inputs."""
    bounces, spp = 8, 64
    case = function_vs_plain("main 512x512 b8 spp64", tables, False, rays, rng, bounces, spp, 512, 512)
    wts = torch.as_tensor(
        np.random.default_rng(512).normal(size=(*rng.shape[:2], 3)).astype(np.float32), device=rng.device)
    kernel = cuda_times(lambda: V.launch_backward(*tables, rays, rng, wts, bounces, spp, False), 20)
    ops = bounce_ops(tables, mix, False, backward=True)
    return {"case": case, "kernel": kernel,
            **bound(BWD_BYTES_PER_PIXEL * rng.shape[0] * rng.shape[1] + 2 * table_bytes(tables), ops),
            "ops": ops, "live_bounces": sum(mix)}


def backward_vs_golden(golden, dev) -> list:
    """Phase 8: the backward kernel on the golden gradient cases' inputs
    against the JAX package's cotangents."""
    results = []
    for case in ("main", "mixed", "glass"):
        prefix = f"grad_{case}__"
        arrays = {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}
        scene = C.scene_from_numpy(
            {k[len("scene__"):]: v for k, v in arrays.items() if k.startswith("scene__")}, dev)
        spp, bounces = arrays["config"].tolist()
        rays = Rays(origin=torch.as_tensor(arrays["origin"], device=dev),
                    direction=torch.as_tensor(arrays["direction"], device=dev))
        geom, mat = MK.scene_tables(scene)
        counts = MK.primitive_counts(scene)
        got = V.launch_backward(
            geom, mat, counts, rays, C.rng_from_numpy(arrays["rng_in"], dev),
            torch.as_tensor(arrays["wts"], device=dev), bounces, spp, scene.has_dielectric(),
        )
        want = [torch.as_tensor(arrays[k], device=dev)
                for k in ("d_geom", "d_mat", "d_origin", "d_direction")]
        torch.cuda.synchronize()
        results.append(grad_errors(f"golden {case} 32x16 b{bounces} spp{spp}", got, want, counts))
    return results


def sgd_step(params, scene, cam, target, rng, bounces, spp):
    loss, grads = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp)
    return loss, grads, G.SceneParams(*(p - LR * g for p, g in zip(params, grads)))


def training_path(dev) -> dict:
    """Phase 9: SGD on the reference scene towards a target rendered with
    the emitters' illuminance x1.5, through `loss_and_grad` on CUDA."""
    scene, cam = world.main_scene(dev), world.initial_camera(dev)
    params0 = G.scene_to_params(scene)
    brighter = G.params_to_scene(params0._replace(sphere_illum=params0.sphere_illum * 1.5), scene)
    shapes = [(512, 512, 64, 8, 5), (3840, 2160, 1, 4, 2)]
    targets = []
    with torch.no_grad():
        for w, h, spp, bounces, _ in shapes:
            rng = gen_seeds((h, w), 1, dev)
            targets.append((rng, G.render_radiance(brighter, cam, rng, w, h, bounces, spp)))
    torch.cuda.synchronize()

    out = {}
    MK.LAUNCHES = V.LAUNCHES = 0
    for (w, h, spp, bounces, steps), (rng, target) in zip(shapes, targets):
        label = f"{w}x{h}_spp{spp}_b{bounces}"
        params, losses = params0, []
        t0 = time.perf_counter()
        for step in range(steps):
            before = (MK.LAUNCHES, V.LAUNCHES)
            loss, grads, params = sgd_step(params, scene, cam, target, rng, bounces, spp)
            if (MK.LAUNCHES - before[0], V.LAUNCHES - before[1]) != (1, 1):
                raise AssertionError(f"{label} step {step}: launches {before} -> "
                                     f"{(MK.LAUNCHES, V.LAUNCHES)}, not one of each")
            bad = [f for f, g in grads._asdict().items() if not torch.isfinite(g).all()]
            if bad:
                raise AssertionError(f"{label} step {step}: gradients not finite: {bad}")
            losses.append(loss)
        with torch.no_grad():
            losses.append(G.image_loss(params, scene, cam, target, rng, bounces, spp))
        losses = [float(x) for x in losses]
        wall = time.perf_counter() - t0
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss did not fall: {losses}")
        out[label] = {"losses": losses, "wall_s": wall}
    out["launches"] = {"megakernel": MK.LAUNCHES, "megakernel_vjp": V.LAUNCHES}
    return out


def training_times(scenes, dev) -> dict:
    """Phase 10: fwd+bwd and backward-kernel times at bench.py's shape, SGD
    steps at both training shapes, and kernel vs plain backward at 128x96."""
    scene, cam = world.main_scene(dev), world.initial_camera(dev)
    tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
    params = G.scene_to_params(scene)
    out = {}

    w, h, spp, bounces = 512, 512, 64, 8
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)

    def fwd_bwd():
        # bench.py's step: jax.grad of sum(radiance) through the
        # differentiable trace, from the scene parameters.
        leaves = [p.detach().requires_grad_() for p in params]
        radiance, _ = V.trace_inline_fused_diff(
            G.params_to_scene(G.SceneParams(*leaves), scene), rays, rng,
            num_bounces=bounces, spp=spp, has_dielectric=False)
        return torch.autograd.grad(radiance.sum(), leaves, allow_unused=True)

    step = cuda_times(fwd_bwd, 20)
    segments = w * h * spp * bounces
    live = live_segments(rng, MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, False)[1])
    ones = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
    bwd = cuda_times(lambda: V.launch_backward(*tables, rays, rng, ones, bounces, spp, False), 20)
    # The same work with a zero cotangent: every row cotangent is then zero
    # and the kernel skips its atomic adds, so the difference is their cost.
    zeros = torch.zeros_like(ones)
    bwd_no_atomics = cuda_times(
        lambda: V.launch_backward(*tables, rays, rng, zeros, bounces, spp, False), 20)
    out["fwd_bwd_512x512_spp64_b8"] = {
        "step": step,
        "segments_per_s": segments / (step["median_ms"] / 1e3),
        "live_segment_share": live / segments,
        "backward_kernel": bwd,
        "backward_kernel_zero_cotangent": bwd_no_atomics,
    }

    brighter = G.params_to_scene(params._replace(sphere_illum=params.sphere_illum * 1.5), scene)
    for w, h, spp, bounces, reps in [(512, 512, 64, 8, 10), (3840, 2160, 1, 4, 5)]:
        rng = gen_seeds((h, w), 1, dev)
        with torch.no_grad():
            target = G.render_radiance(brighter, cam, rng, w, h, bounces, spp)
        out[f"sgd_step_{w}x{h}_spp{spp}_b{bounces}"] = cuda_times(
            lambda: sgd_step(params, scene, cam, target, rng, bounces, spp), reps)

    # Kernel and plain backward on the same inputs: phase 7's first case.
    scene7, cam7 = scenes["main"]
    rot = cam7.rotation.tolist()
    w, h, spp, bounces = 128, 96, 2, 4
    rays = primary_rays(Camera.create(cam7.position.tolist(), [rot[0] - PITCH, rot[1], rot[2]], 90.0, dev), w, h)
    rng = gen_seeds((h, w), 0, dev)
    wts = torch.as_tensor(np.random.default_rng(0).normal(size=(h, w, 3)).astype(np.float32), device=dev)
    tables7 = (*MK.scene_tables(scene7), MK.primitive_counts(scene7))
    out["compare_128x96_b4_spp2"] = {
        "kernel": cuda_times(lambda: V.launch_backward(*tables7, rays, rng, wts, bounces, spp, False), 30),
        "plain": cuda_times(lambda: V.backward_reference(*tables7, rays, rng, wts, bounces, spp, False), 3),
    }
    return out


# The NEE kernel's operations, counted from csrc/nee.cuh as above.  The
# fold, per primitive: the nearest test of a sphere (19; the primary fold,
# once per pixel), and at a live bounce the dual test that shares its
# `center - point` vector with the shadow ray (19 + 12); a plane 14 (+ 6
# for the shadow ray, whose numerator is the BSDF ray's), a box 25 (+ 19),
# a triangle 46 (+ 30).
PRIMARY_FOLD_OPS = (19, 14, 25, 46)
DUAL_FOLD_OPS = (31, 20, 44, 76)
# A live bounce, whatever it hit: the 6 uniforms (12), the dead test (5),
# the hit point (6), the next throughput (3) and the cheapest sample, the
# mirror reflection (12); with emitters, the light choice (3) and the
# cheapest light sample, the cone with its distance (74).  Normals,
# emission, the other BRDFs and the NEE sum are not counted.
NEE_BOUNCE_OPS, NEE_LIGHT_OPS = 38, 77
# Bytes per pixel: rays 24 and rng 16 in, radiance 12 and rng 16 out (the
# NEE kernel); rays 24 in, t and prim 8 out (the probe).  The tables add
# 4 B per entry.
NEE_BYTES_PER_PIXEL, PROBE_BYTES_PER_RAY = 68, 32
LANE_MAX_DIVERGED = 0.005
PROBE_PRIM_MIN, PROBE_T_RTOL = 0.9995, 1e-6
CAM4 = ([0.0, 2.0, 0.0], [0.2, 0.0, 0.0])  # suite config 4's camera


def lane_parity(label, got, want) -> dict:
    """tests/test_pallas_nee.py:assert_lane_parity on (radiance, rng)."""
    rad, rng = got[0], got[1]
    rad_ref, rng_ref = want[0], want[1]
    if not torch.isfinite(rad).all():
        raise AssertionError(f"{label}: kernel radiance is not finite")
    match = (rng == rng_ref).all(dim=-1)
    diverged = 1.0 - match.double().mean().item()
    bad = ((rad - rad_ref).abs() > 1e-4 + 1e-3 * rad_ref.abs()).any(dim=-1)
    off = (bad & match).double().mean().item()
    if diverged > LANE_MAX_DIVERGED or off > LANE_MAX_DIVERGED:
        raise AssertionError(f"{label}: rng diverged on {diverged:.4%}, radiance off on {off:.4%}")
    return dict(case=label, rng_diverged=diverged, radiance_off=off,
                max_abs_err=(rad - rad_ref).abs().max().item())


def nee_ops(tables, live, pixels) -> int:
    """fp32 operations the NEE kernel's function needs: the primary fold
    per pixel, the dual fold and a live bounce's least work per live bounce."""
    counts = tables.counts
    per_bounce = sum(n * f for n, f in zip(counts, DUAL_FOLD_OPS)) + NEE_BOUNCE_OPS
    per_bounce += NEE_LIGHT_OPS if tables.num_lights else 0
    return pixels * sum(n * f for n, f in zip(counts, PRIMARY_FOLD_OPS)) + live * per_bounce


def nee_table_bytes(tables) -> int:
    return 4 * (tables.fold.numel() + tables.payload.numel() + tables.lights.numel())


def nee_bound(tables, live, pixels) -> dict:
    ops = nee_ops(tables, live, pixels)
    return {**bound(NEE_BYTES_PER_PIXEL * pixels + nee_table_bytes(tables), ops), "ops": ops}


def probe_bound(tables, rays) -> dict:
    n = rays.origin.numel() // 3
    ops = n * sum(c * f for c, f in zip(tables.counts, PRIMARY_FOLD_OPS))
    return {**bound(PROBE_BYTES_PER_RAY * n + 4 * tables.fold.numel(), ops), "ops": ops}


def nee_cases(dev) -> dict:
    origin = Camera.create([0.0] * 3, [0.0] * 3, 90.0, dev)
    ref = world.initial_camera(dev)
    cam4 = Camera.create(*CAM4, 90.0, dev)
    return {
        "reference": (world.main_scene(dev), ref, 800, 600, 15, 2),
        "cornell8": (SC.cornell_scene(dev), ref, 512, 512, 4, 16),
        "glassy": (SC.glassy_scene(dev), origin, 512, 256, 6, 4),
        "tri_emitters": (SC.tri_emitter_scene(dev), ref, 512, 512, 4, 4),
        "box_tri": (SC.box_tri_scene(dev), origin, 512, 256, 4, 4),
        "zero_light": (SC.zero_light_scene(dev), ref, 512, 256, 4, 4),
        "big1000": (SC.big_scene(dev, 1000), cam4, 480, 272, 4, 4),
        "big20000": (SC.big_scene(dev, 20000), cam4, 320, 180, 3, 2),
    }


def nee_vs_plain(dev) -> list:
    """Phase 11: the NEE kernel against its plain version, lane parity and
    equal telemetry, on every case; the 20000-sphere tables (320 KB) are
    read from device memory, the others from shared memory."""
    results = []
    for label, (scene, cam, w, h, bounces, spp) in nee_cases(dev).items():
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), len(results) + 100, dev)
        got = NE.trace_physical_nee(scene, rays, rng, bounces, spp, presort=False, telemetry=True)
        want = NE.trace_physical_nee_reference(scene, rays, rng, bounces, spp, telemetry=True)
        torch.cuda.synchronize()
        case = lane_parity(f"{label} {w}x{h} b{bounces} spp{spp}", got, want)
        if not torch.equal(got[2], want[2]):
            raise AssertionError(f"{label}: live bounces differ from the plain version's")
        tables = NE.nee_scene_tables(scene)
        results.append({**case, "live_bounces": int(got[2].sum()), "primitives": list(tables.counts),
                        "lights": tables.num_lights,
                        "tables_in_shared_memory": 4 * tables.fold.numel() <= 48 * 1024,
                        "mean": want[0].mean().item()})
    return results


def nee_vs_golden(dev) -> list:
    """Phase 12: the NEE kernel on the golden cases' inputs against the JAX
    package's outputs."""
    results = []
    with np.load(NEE_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    for case in sorted({k.split("__")[0] for k in golden}):
        prefix = f"{case}__scene__"
        scene = C.scene_from_numpy(
            {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}, dev)
        spp, bounces = golden[f"{case}__config"].tolist()
        light_idx = tuple(golden[f"{case}__light_idx"].tolist())
        if NE.scene_light_indices(scene) != light_idx:
            raise AssertionError(f"golden {case}: emitters {light_idx} differ")
        rays = Rays(origin=torch.as_tensor(golden[f"{case}__origin"], device=dev),
                    direction=torch.as_tensor(golden[f"{case}__direction"], device=dev))
        got = NE.trace_physical_nee(scene, rays, C.rng_from_numpy(golden[f"{case}__rng_in"], dev),
                                    bounces, spp, light_idx=light_idx)
        want = (torch.as_tensor(golden[f"{case}__radiance"], device=dev),
                C.rng_from_numpy(golden[f"{case}__rng_out"], dev))
        torch.cuda.synchronize()
        results.append(lane_parity(f"golden {case} 128x16 b{bounces} spp{spp}", got, want))
    return results


def probe_check(dev) -> dict:
    """Phase 13: the probe against the plain fold on the config-4 scene at
    1920x1088 (the plain fold over row tiles), and the NEE kernel with the
    presort (probe, argsort, lane order) against raster order, bit for bit,
    at 1920x1088 / 2 spp / 4 bounces."""
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    rays, rng = primary_rays(cam, 1920, 1088), gen_seeds((1088, 1920), 7, dev)
    tables = NE.nee_scene_tables(scene)
    t0, prim0 = NE.launch_probe(tables, rays)
    tiles = [nearest_t_prim(rays.origin[r:r + 136], rays.direction[r:r + 136], scene, 0.0)
             for r in range(0, 1088, 136)]
    t_ref, prim_ref = torch.cat([t for t, _ in tiles]), torch.cat([p for _, p in tiles]).to(torch.int32)
    same = prim0 == prim_ref
    share = same.double().mean().item()
    hit = same & (t_ref < INFINITE)
    rel = ((t0 - t_ref).abs() / t_ref.abs())[hit].max().item()
    if share < PROBE_PRIM_MIN or rel > PROBE_T_RTOL or not torch.equal(t0[~hit & same], t_ref[~hit & same]):
        raise AssertionError(f"probe: winners equal on {share:.6f}, t rel {rel}")
    raster = NE.trace_physical_nee(scene, rays, rng, 4, 2, presort=False, telemetry=True)
    presorted = NE.trace_physical_nee(scene, rays, rng, 4, 2, presort=True, telemetry=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(raster, presorted)):
        raise AssertionError("presort changed a pixel's radiance, rng or telemetry")
    return {"prim_equal": share, "t_rel_err_max": rel,
            "max_abs_err": (t0 - t_ref)[hit].abs().max().item(),
            "sky_share": (t_ref >= INFINITE).double().mean().item(), "presort_bit_identical": True}


def physical_main_path(dev) -> dict:
    """Phase 14: the physical serving path through the CLI, counted from 0:
    the reference scene at 800x600 / 15 bounces / 64 spp (the kernel, and
    the same run on the plain path for lane parity of the accumulators),
    then the config-4 scene from a scene file at 800x600 / 15 / 131 spp."""
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        big_json = os.path.join(tmp, "big1000.json")
        save_scene(big_json, SC.big_scene("cpu", 1000), Camera.create(*CAM4, 90.0, "cpu"))

        def cli(name, args):
            png, ckpt = os.path.join(tmp, f"{name}.png"), os.path.join(tmp, f"{name}.npz")
            t0 = time.perf_counter()
            rc = cli_main(["--variant", "physical", "--width", "800", "--height", "600", "--seed", "0",
                           "--quiet", "--checkpoint", ckpt, "-o", png, *args])
            wall = time.perf_counter() - t0
            acc, _ = load_accumulator(ckpt, dev)
            img = acc.image.cpu().numpy()
            rec = {"rc": rc, "iterations": acc.iterations, "wall_s": wall, "mean": float(img.mean()),
                   "lit_share": float((img.sum(-1) > 1e-3).mean()), "png_bytes": os.path.getsize(png)}
            if rc != 0 or not np.isfinite(img).all() or rec["lit_share"] == 0.0:
                raise AssertionError(f"{name}: CLI returned {rc}, or the image is not finite or black")
            return rec, acc

        MK.LAUNCHES = V.LAUNCHES = 0
        NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
        ref, acc = cli("reference", ["--device", "cuda", "--spp", "64"])
        ref_launches = dict(NE.LAUNCHES)
        big, _ = cli("big1000", ["--device", "cuda", "--spp", "131", "--scene", big_json])
        launches = {"megakernel": MK.LAUNCHES, "megakernel_vjp": V.LAUNCHES, **NE.LAUNCHES}
        plain, acc_plain = cli("reference_plain", ["--device", "cuda", "--kernel", "torch", "--spp", "64"])
    if ref_launches != {"nee_megakernel": 64, "primary_probe": 0}:
        raise AssertionError(f"reference scene: launches {ref_launches}, not one NEE launch per step")
    if launches["nee_megakernel"] != 64 + 102 or launches["primary_probe"] != 1 or launches["megakernel"]:
        raise AssertionError(f"physical main path launches {launches}")
    if (ref["iterations"], big["iterations"]) != (64, 131):
        raise AssertionError("the CLI did not render every sample")
    out["reference_800x600_b15_spp64"] = {**ref, "vs_plain_cli": lane_parity(
        "CLI kernel vs plain", (acc.color, acc.rng), (acc_plain.color, acc_plain.rng))}
    out["reference_800x600_b15_spp64_plain"] = plain
    out["big1000_800x600_b15_spp131"] = big
    out["launches"] = launches
    return out


def nee_times(dev, smi) -> tuple:
    """Phase 15.  Returns the phase's record and the kernels-line entries
    of the NEE kernel and the probe."""
    out = {"nvidia_smi": smi}
    for label, scene in (("config6_cornell8", SC.cornell_scene(dev)),
                         ("config8_tri_emitters", SC.tri_emitter_scene(dev))):
        cam, (w, h, spp, b) = world.initial_camera(dev), (512, 512, 16, 4)
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)
        tables, kinds = NE.nee_scene_tables(scene), _present_kinds(scene)
        live = int(NE.launch_nee(tables, rays, rng, b, spp, 1 in kinds, 2 in kinds, telemetry=True)[2].sum())
        kernel = cuda_times(lambda: NE.launch_nee(tables, rays, rng, b, spp, 1 in kinds, 2 in kinds), 20)
        out[f"{label}_512x512_spp16_b4"] = {
            "kernel": kernel, "live_share": live / (w * h * spp * b),
            "rays_per_s_suite_count": w * h * spp * b * 2 / (kernel["median_ms"] / 1e3),
            **nee_bound(tables, live, w * h)}

    # Config 4: 1920x1088 / 256 spp / 4 bounces on 1000 spheres.
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    w, h, spp, b = 1920, 1088, 256, 4
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)
    tables = NE.nee_scene_tables(scene)
    live = int(NE.launch_nee(tables, rays, rng, b, spp, False, False, telemetry=True)[2].sum())

    def presorted():
        t0, prim0 = NE.launch_probe(tables, rays)
        return NE.launch_nee(tables, rays, rng, b, spp, False, False, order=NE._presort_order(t0),
                             primary=(t0, prim0))

    raster = cuda_times(lambda: NE.launch_nee(tables, rays, rng, b, spp, False, False), 2)
    sort = cuda_times(presorted, 2)
    raster2 = cuda_times(lambda: NE.launch_nee(tables, rays, rng, b, spp, False, False), 2)
    probe = cuda_times(lambda: NE.launch_probe(tables, rays), 20)
    out["config4_big1000_1920x1088_spp256_b4"] = {
        "raster": raster, "presort": sort, "raster_again": raster2,
        "live_share": live / (w * h * spp * b),
        "rays_per_s_suite_count": w * h * spp * b * 2 / (min(raster["median_ms"], sort["median_ms"]) / 1e3),
        "presort_gate": {"spheres_min": NE.PRESORT_MIN_SPHERES, "spp_min": NE.PRESORT_MIN_SPP},
        **nee_bound(tables, live, w * h)}
    out["probe_config4_1920x1088"] = {"kernel": probe, **probe_bound(tables, rays)}

    # The serving shape, 800x600 / 15 bounces / 1 spp on the reference
    # scene: the kernel, its plain version and the Renderer step.
    scene, cam = world.main_scene(dev), world.initial_camera(dev)
    w, h, b = 800, 600, 15
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)
    tables, kinds = NE.nee_scene_tables(scene), _present_kinds(scene)
    live = int(NE.launch_nee(tables, rays, rng, b, 1, 1 in kinds, 2 in kinds, telemetry=True)[2].sum())
    kernel = cuda_times(lambda: NE.launch_nee(tables, rays, rng, b, 1, 1 in kinds, 2 in kinds), 50)
    plain = cuda_times(lambda: NE.trace_physical_nee_reference(scene, rays, rng, b, 1, kinds), 5)
    nee_b = nee_bound(tables, live, w * h)
    steps = {}
    for choice, reps in (("auto", 50), ("torch", 5)):
        renderer = Renderer(RenderConfig(algorithm="physical", kernel=choice, device="cuda"))
        acc = renderer.init_accumulator(seed=0)
        steps[choice] = cuda_times(lambda: renderer.step(scene, cam, acc, spp=1), reps)
    out["serving_800x600_b15_spp1"] = {"kernel": kernel, "plain": plain, "live_share": live / (w * h * b),
                                       "renderer_step_auto": steps["auto"],
                                       "renderer_step_torch": steps["torch"], **nee_b}

    # The probe at its main-path shape: 800x600 on the config-4 scene.
    scene4, cam4 = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    rays4 = primary_rays(cam4, 800, 600)
    tables4 = NE.nee_scene_tables(scene4)
    probe_main = cuda_times(lambda: NE.launch_probe(tables4, rays4), 50)
    probe_plain = cuda_times(lambda: nearest_t_prim(rays4.origin, rays4.direction, scene4, 0.0), 3)
    out["probe_800x600_big1000"] = {"kernel": probe_main, "plain": probe_plain, **probe_bound(tables4, rays4)}
    entries = {
        "nee_megakernel": {"ms": kernel["median_ms"], "plain_ms": plain["median_ms"],
                           "bound_ms": nee_b["bound_ms"], "bound_by": nee_b["bound_by"]},
        "primary_probe": {"ms": probe_main["median_ms"], "plain_ms": probe_plain["median_ms"],
                          **{k: out["probe_800x600_big1000"][k] for k in ("bound_ms", "bound_by")}},
    }
    return out, entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    # 1. Device.
    phase("device", name=name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. Build, from the sources in this checkout: one nvcc per source,
    # started together.
    builds = {"megakernel": MK, "megakernel_vjp": V, "nee_megakernel": NE}
    for mod in builds.values():
        if os.path.exists(mod.library_path()):
            os.unlink(mod.library_path())

    def timed_build(mod):
        t = time.perf_counter()
        return os.path.relpath(mod.build(), ROOT), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = dict(zip(builds, pool.map(timed_build, builds.values())))
    phase("build", seconds=time.perf_counter() - t0,
          libraries={k: {"library": lib, "seconds": sec} for k, (lib, sec) in done.items()})

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

    # 5. The serving path end to end, through the CLI.
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        png, ckpt = os.path.join(tmp, "render.png"), os.path.join(tmp, "state.npz")
        MK.LAUNCHES = V.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli_main([
            "--device", "cuda", "--width", "800", "--height", "600", "--bounces", "15",
            "--spp", "64", "--seed", "0", "--quiet", "--checkpoint", ckpt, "-o", png,
        ])
        wall = time.perf_counter() - t0
        serving = {"megakernel": MK.LAUNCHES, "megakernel_vjp": V.LAUNCHES}
        acc, _ = load_accumulator(ckpt, "cpu")
        png_bytes = os.path.getsize(png)
    img = acc.image.numpy()
    mean = float(img.mean())
    lit = float((img.sum(-1) > 1e-3).mean())
    phase("main_path", rc=rc, launches=serving, iterations=acc.iterations, wall_s=wall,
          mean=mean, lit_share=lit, png_bytes=png_bytes)
    if rc != 0 or acc.iterations != 64:
        raise AssertionError(f"CLI returned {rc} after {acc.iterations} samples")
    if serving["megakernel"] < 64:
        raise AssertionError(f"the main path launched the kernel {serving['megakernel']} times (< 64)")
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
    live = live_segments(rng512, kernel(rays512, rng512, 8, 64)()[1])
    one = {"kernel": cuda_times(kernel(rays800, rng800, 15, 1), 50),
           "plain": cuda_times(plain(rays800, rng800, 15, 1), 11)}
    # The live bounces of each shape by winning row, for the bounds (the
    # 512x512 inputs are phase 7's main-shape case too).
    mix800 = live_bounce_mix(tables, rays800, rng800, 15, 1, False)
    mix512 = live_bounce_mix(tables, rays512, rng512, 8, 64, False)
    fwd_bound = bound(FWD_BYTES_PER_PIXEL * 800 * 600 + table_bytes(tables),
                      bounce_ops(tables, mix800, False, backward=False))
    fwd_bound512 = bound(FWD_BYTES_PER_PIXEL * 512 * 512 + table_bytes(tables),
                         bounce_ops(tables, mix512, False, backward=False))
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
            "live_bounces_by_row": mix512,
            **fwd_bound512,
        },
        call_800x600_b15_spp1={**one, "live_bounces_by_row": mix800, **fwd_bound},
        kernel_800x600_b15_spp64=spp64,
        renderer_step_800x600_b15_spp1={"kernel_auto": steps["auto"], "kernel_torch": steps["torch"]},
    )

    # 7-10: the training path.
    grad_cases = backward_vs_plain(scenes, dev)
    main_shape = backward_main_shape(tables, rays512, rng512, mix512)
    grad_cases.append(main_shape["case"])
    bwd_max_abs_err = max(c["max_abs_err"] for c in grad_cases)
    phase("backward_vs_plain", max_abs_err=bwd_max_abs_err, cases=grad_cases,
          main_shape_512x512_spp64_b8={k: v for k, v in main_shape.items() if k != "case"})
    phase("backward_vs_jax_golden", cases=backward_vs_golden(golden, dev))
    training = training_path(dev)
    phase("training_path", **training)
    times = training_times(scenes, dev)
    phase("training_times", nvidia_smi=smi, **times)

    # 11-15: the physical/NEE path.
    nee_cases_ = nee_vs_plain(dev)
    nee_err = max(c["max_abs_err"] for c in nee_cases_)
    phase("nee_kernel_vs_plain", max_abs_err=nee_err, cases=nee_cases_)
    phase("nee_vs_jax_golden", cases=nee_vs_golden(dev))
    probe = probe_check(dev)
    phase("probe", **probe)
    physical = physical_main_path(dev)
    phase("physical_main_path", **physical)
    nee_record, nee_entries = nee_times(dev, smi)
    phase("nee_times", **nee_record)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel.py:558",
        "launches": serving["megakernel"] + training["launches"]["megakernel"],
        "max_abs_err": max_abs_err,
        "ms": one["kernel"]["median_ms"],
        "plain_ms": one["plain"]["median_ms"],
        **fwd_bound,
        "library_ms": None,
    }, {
        "name": "megakernel_vjp",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel_vjp.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel_vjp.py:63",
        "launches": serving["megakernel_vjp"] + training["launches"]["megakernel_vjp"],
        "max_abs_err": bwd_max_abs_err,
        "ms": main_shape["kernel"]["median_ms"],
        "plain_ms": main_shape["case"]["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }, {
        "name": "nee_megakernel",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee.py:431",
        "launches": physical["launches"]["nee_megakernel"],
        "max_abs_err": nee_err,
        **nee_entries["nee_megakernel"],
        "library_ms": None,
    }, {
        "name": "primary_probe",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee.py:395",
        "launches": physical["launches"]["primary_probe"],
        "max_abs_err": probe["max_abs_err"],
        **nee_entries["primary_probe"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
