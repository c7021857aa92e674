"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's six CUDA libraries from ``haskell_path_tracer_torch/csrc``
(one nvcc each, started together) and runs twenty-six phases, each
printing one line; any failure raises and the script exits non-zero
without printing a result:

  1. device: name, power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc of csrc/megakernel.cu, csrc/megakernel_vjp.cu,
     csrc/nee_megakernel.cu (the NEE kernel and the probe),
     csrc/nee_megakernel_vjp.cu (the NEE backward), csrc/sphere_fold.cu
     (the nearest-sphere and dual folds, + sphere_fold.cuh) and
     csrc/split.cu (deterministic
     splitting), timed, with what ptxas reported for the parity kernels,
     the NEE kernel's instances and the probe (registers, stack frame,
     spills per template instance; the NEE backward's instances too), and
     the registers, stack bytes and resident warps per SM of the NEE
     instances, the probe (on 1000 spheres and on 20000) and the NEE
     backward in both modes that config 4's and config 7's launches take;
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
  7. the gradient's recording forward bit-equal to the production one and
     its per-sample rng states equal to the plain version's, on the three
     scenes; the backward kernel against its plain version on the card
     (autograd of the plain trace), in both modes: through the autograd
     Function (one thread per (pixel, sample) from the recorded states at
     more than one sample, one thread per pixel at one sample) and the
     other mode's kernel launched on its own with the same cotangent, at
     128x96 / 4 bounces / 2 spp and a ragged 67x29 / 3 bounces / 1 spp on
     the three scenes, each seen by its camera pitched 0.3 rad further
     down, and at the training path's shapes on the reference scene seen by
     its own camera: 512x512 / 64 spp / 8 bounces and 3840x2160 / 1 spp / 4
     bounces, one kernel launch on the whole image against the plain
     backward over row tiles; the Function's forward must equal the forward
     kernel's output bit for bit, and the kernel must refuse 17 bounces in
     both modes;
  8. backward kernel against the JAX package's golden gradients;
  9. the training path end to end: `loss_and_grad` and an SGD update on the
     reference scene towards a target rendered with the emitters' light
     x1.5, 5 steps at 512x512 / 64 spp / 8 bounces (bench.py's shape) and
     2 at 3840x2160 / 1 spp / 4 bounces (benchmarks/suite.py config 5's);
     every step launches one forward (the recording instance at 64 spp)
     and one backward (per sample at 64 spp, per pixel at 1 spp), every
     gradient is finite, and the loss falls;
 10. training times: fwd+bwd segments/s at 512x512 / 64 spp / 8 bounces
     (counted as bench.py counts them), the backward kernel alone in both
     modes, ms per SGD step at both shapes, the plain backward at 128x96,
     and the registers,
     stack bytes and resident warps per SM of the parity kernels'
     instances that these launches take;
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
     presort against raster order, bit for bit; both again on the
     reference, triangle-emitter and box/triangle scenes and on 20000
     spheres at 320x180 (20 of the probe's table tiles);
 14. the physical serving path end to end: the CLI with `--variant
     physical` renders the reference scene at 800x600, 15 bounces, 64 spp
     (one NEE launch per step, lane parity with the same CLI run with
     `--kernel torch`), then the config-4 scene from a scene file at
     800x600 / 15 bounces / 131 spp, whose 30-sample batch takes the
     presort route (one probe launch);
 15. NEE times: the kernel at configs 6 and 8 (512x512 / 16 spp / 4
     bounces) and 4 (1920x1088 / 256 spp / 4 bounces, presort on and off,
     3 calls each) with the live share from the telemetry, the probe
     alone (and at 800x600, and on 20000 spheres at 320x180), the kernel and its plain version at the serving shape
     (800x600 / 15 / 1 spp), and `Renderer.step` at 1 spp; the warp
     efficiency (lane-mean live bounces over the warp's cost) at config 4,
     raster and presorted, and of the recording instance at config 7's
     1920x1088 / 8 / 4, raster and sorted: of the kernel's flat loop (a
     warp pays its longest lane's live bounces over all samples) and of a
     nested sample x bounce loop on the same paths (a warp pays, sample by
     sample, its longest path), from the telemetry and the recording
     instance's words;
 16. NEE backward against its plain version: `loss_and_grad(estimator=
     "physical", backend="cuda", light_idx)` in the residual mode (the
     default: the recording forward and the fold-free backward) and in the
     replay mode (the byte budget at 0) against backend="torch", and the
     kernel in both modes, raster and sorted order, against
     `backward_reference` (autograd of the plain trace, its cotangents
     mapped to the scene's leaves), the residual mode against the replay
     mode too, on Cornell, config 8's triangle emitters, glass, no emitter,
     1000 spheres, 4000 spheres (the residual mode's cotangent tiles too
     large for shared memory), a ragged 67x29, 15 bounces, and spp of 40
     at 15 bounces and 70 at 16 (several chunks of the replay mode, the
     last one short); the
     replay mode's ray cotangents bit-equal to the residual mode's in both
     frames, and zero on pixels whose paths all end at bounce 0; on config
     8's scene, whose two emitter triangles are coplanar and overlap, the
     vertex fields are reported, not held (see `TIED_FIELDS`); the Function's
     forward bit-equal to the NEE kernel's, and the sorted frame's to the
     raster one; the kernel refuses 17 bounces; a scene of more than 768
     emitters (`MANY_EMITTERS`), where the gradient takes the replay mode,
     `loss_and_grad` against backend="torch" and the kernel in both frames
     against the plain backward;
 17. the kernel route against the JAX package's gradients
     (tests/data/torch_port_nee_grad_golden.npz);
 18. the nearest-sphere and dual-fold kernels against their plain versions,
     bit for bit (t, prim, occ): 1000 spheres at 1920x1088 and 20000 at
     320x180 (config 4's scene), and synthetic tables of 1, 129, 3073 (past
     the old 48 KB) and 14529 spheres (past 227 KB) with duplicated rows
     (exact ties), at ray counts that are no multiple of rays per thread x
     block (the nearest fold at 2 and at 1 ray per thread), at eps 0 and at
     a distance one ray meets exactly, with dead lanes, every lane dead and
     every lane alive, and a table followed by its own copy (every tie to
     the first copy); `trace_physical(fused=True)` against the plain loop,
     and the `light_idx=None` gradient route, counted from 0, against
     backend="torch";
 19. the physical training path, counted from 0: SGD through
     `loss_and_grad(estimator="physical", light_idx)` on suite config 7's
     scene towards a target with the emitters' light halved, 5 steps at
     512x512 / 1 spp / 4 bounces and 2 at 1920x1088 / 8 / 4 in the
     residual mode, then 1 at 512x512 in the replay mode (the byte budget
     at 0, as a gradient above it runs); every step launches the NEE
     forward (its recording instance in the residual mode), the probe
     (sorted frame) and the backward once, the loss falls;
 20. gradient times at config 7's shapes: the backward kernel in both
     modes and the forward kernel's production and recording instances,
     in both frames, with their bounds; the SGD step in both frames in the
     residual mode and in the sorted frame in the replay mode; the
     residual backward with its cotangent tiles in shared and in device
     memory on 1000, 1600 and 3400 spheres, the two held against each
     other; the backward kernel in both modes (the residual mode with
     either tile placement) held against its plain versions at 512x512 /
     1 / 4 (both frames, the plain over row tiles: autograd of the plain
     trace, and of the word replay) and on a full-width strip of 1920x1088
     / 8 / 4 (the kernel launched on the whole image with the cotangent
     zero outside the strip), the replay mode's ray cotangents bit-equal to
     the residual mode's there, and timed with them at 512x512; the two folds
     at 1920x1088 x 1000 spheres and 320x180 x 20000, with their bounds and
     the registers, stack bytes and resident warps per SM of the instance
     each launch takes;
 21. the splitting kernel against its plain version (`trace_split_reference`)
     on the card: config 3's glass scene at 512x512 / 8 b / 4 spp, the
     reference scene at 800x600 / 15 / 1, a ragged 333x97, stack depths 1,
     2, 4 and 14 at 15 bounces, the mixed-kinds scene, 1000 and 4000
     spheres (tables in shared memory above 48 KB, and in device memory):
     every rng word equal and every radiance value bit-equal, or, on a
     scene without glass (the reference and the mixed-kinds scene, whose
     glossy sample differs from PyTorch's in the last bits), bit-equal to
     the forward kernel's, which shares the kernel's per-bounce code; on the
     reference scene against the forward kernel (rng equal, radiance
     within 1e-6); the forward and backward kernels against their plain
     versions on 1000, 2000 and 4000 spheres;
 22. the splitting kernel against the JAX package's Pallas kernel
     (tests/data/torch_port_split_golden.npz);
 23. the wavefront serving path, counted from 0: the CLI with `--variant
     wavefront --split` at 800x600 / 15 b / 64 spp on the reference scene
     and on config 3's glass scene from a scene file (one split launch per
     step), the glass image against the inline CLI's (mean within 6%,
     pixel correlation > 0.97); `--variant streams --stats` (the stats
     line, its histogram summing to the pixels); `render_batch_wavefront`
     on 1000 spheres (one nearest-fold launch per bounce, bit-equal to the
     plain chunked fold);
 24. splitting times: the kernel at suite config 3 (512x512 / 64 spp / 8 b,
     queue_factor 2; rays/s as suite.py counts them, W H spp b, and the
     processed segments), at 800x600 / 15 / 1 on the glass and reference
     scenes with `Renderer.step` and the plain version, with bounds, the
     registers, stack bytes and resident warps per SM of the instance each
     launch takes, and the warp efficiency of the nested and of the flat
     step loop (from the plain version's steps per sample and lane); the
     forward kernel at 800x600 / 15 / 1 on 1000 spheres;
 25. the NEE gradient's recording forward: the NEE kernel's recording
     instance bit-equal to its production instance in radiance and rng,
     raster and sorted, on the NEE gradient golden cases (cornell8, tri,
     glassy) and at config 7's two shapes; its residual words in the
     sorted frame the raster frame's in lane order; its words against the
     plain version's under lane parity on the golden cases and at
     512x512 / 1 / 4;
 26. the paths that launch the two folds at the shapes users run, timed:
     the `light_idx=None` physical SGD step on config 4's scene at config
     7's 512x512 / 1 / 4 and 1920x1088 / 8 / 4, spp nearest and spp x
     bounces dual folds per step, and the non-split wavefront `Renderer.step` on that scene at
     800x600 / 15 / 1, a nearest fold per bounce, with the launches counted
     from 0 and the SGD steps' peak device memory.

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

Gradient tolerance of the NEE backward (tests/test_pallas_nee_vjp.py), in
both modes and for the residual mode against the replay mode: loss rtol
1e-5 and, per SceneParams field, max|a - b| / max|b| below 5e-3; ray
cotangents per lane, off on at most 0.5% of lanes.  The dual-query route:
rtol 5e-4, atol 5e-6 (tests/test_grad.py).

The line before the last is a JSON object of the kernels with their
launches on the main paths (phases 5, 9, 14, 19, 23, 18's dual-query
route and 26's fold routes), their times, their plain versions' and their bounds at each path's
shape (the forward and the NEE kernel at 800x600 / 15 bounces / 1 spp, the
recording forward and both backward kernels at 512x512 / 64 spp / 8
bounces, with the parity kernels' and the NEE kernel's instances'
registers, stack bytes and resident warps per SM, the probe at 800x600 on the
config-4 scene with its registers, stack bytes and resident warps, the NEE kernel's recording instance and the NEE backward
in both modes at 512x512 / 1 / 4 on config 7's scene, the two folds at
1920x1088 on it with their registers, stack bytes and resident warps per
SM, the splitting kernel at 800x600 / 15 / 1 on config 3's
glass scene); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
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
sys.path.insert(0, os.path.join(ROOT, "tests"))  # fold_cases: phase 18's tables and rays

from haskell_path_tracer_torch.app.main import main as cli_main  # noqa: E402
from haskell_path_tracer_torch.diff import grad as G  # noqa: E402
from haskell_path_tracer_torch.models import convert as C  # noqa: E402
from haskell_path_tracer_torch.models import world  # noqa: E402
from haskell_path_tracer_torch.models.camera import primary_rays  # noqa: E402
from haskell_path_tracer_torch.models.objects import Camera, Rays, Spheres  # noqa: E402
from haskell_path_tracer_torch.ops import megakernel as MK  # noqa: E402
from haskell_path_tracer_torch.ops import megakernel_vjp as V  # noqa: E402
from haskell_path_tracer_torch.ops import nee as NE  # noqa: E402
from haskell_path_tracer_torch.ops import nee_vjp as NV  # noqa: E402
from haskell_path_tracer_torch.ops import sphere_fold as SF  # noqa: E402
from haskell_path_tracer_torch.ops import split as SP  # noqa: E402
from haskell_path_tracer_torch.render import integrator as RI  # noqa: E402
from haskell_path_tracer_torch.render import nee as RN  # noqa: E402
from haskell_path_tracer_torch.render import wavefront as WF  # noqa: E402
from haskell_path_tracer_torch.ops.intersect import (  # noqa: E402
    CHUNKED_THRESHOLD,
    EPSILON,
    INFINITE,
    nearest_t_prim,
    plain_sphere_fold,
    sphere_nearest_chunked,
)
from haskell_path_tracer_torch.models import scenes as SC  # noqa: E402
from haskell_path_tracer_torch.models.io import save_scene  # noqa: E402
from haskell_path_tracer_torch.render.nee import _present_kinds  # noqa: E402
from haskell_path_tracer_torch.ops.rng import gen_seeds, gen_vec  # noqa: E402
from haskell_path_tracer_torch.render.renderer import Renderer  # noqa: E402
from haskell_path_tracer_torch.utils.checkpoint import load_accumulator  # noqa: E402
from haskell_path_tracer_torch.utils.config import RenderConfig  # noqa: E402
from fold_cases import edge_rays, edge_spheres  # noqa: E402
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
LR = 1e-6  # SGD step of benchmarks/suite.py configs 5 and 7
LR_FIELDS = {f: LR for f in G.SceneParams._fields}

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
# The recorded rng of a pixel at the start of a sample (written by the
# recording forward, read by the per-sample backward).
STATE_BYTES = 16


def ptxas_summary(mod) -> dict:
    """What ptxas reported for the parity kernels of `mod`'s library
    (registers, stack frame, spill stores and loads), by kernel and template
    arguments: megakernel<dielectric, roulette, tables in smem, record>,
    megakernel_vjp<dielectric, tables in smem, tile in smem, per sample>."""
    out = {}
    for fn, rep in MK.ptxas_report(mod.library_path()).items():
        m = re.search(r"(megakernel(?:_vjp)?)I((?:Lb[01]E)+)E", fn)
        if m:
            out[f"{m.group(1)}<{','.join(re.findall(r'Lb([01])E', m.group(2)))}>"] = rep
    return out


def nee_ptxas_summary() -> dict:
    """What ptxas reported for the NEE kernel's instances, one thread per
    lane and persistent, <glossy, dielectric, record>, the probe, and the
    NEE backward's instances in the residual mode <glossy, dielectric,
    tiles in smem> and the replay mode <glossy, dielectric, tiles: 0 none,
    1 the light tile, 2 all three in smem> with its two halves' functions
    <glossy, dielectric> (their stack and spills)."""
    out = {}
    for lib in (NE.library_path(), NV.library_path()):
        for fn, rep in MK.ptxas_report(lib).items():
            m = re.search(r"(nee_(?:persistent_)?kernel|nee_vjp_(?:resid|replay)_kernel)I((?:Lb[01]E)+)"
                          r"(?:LN\w*?TilesE(\d)E)?E", fn)
            half = re.search(r"((?:record|reverse)_chunk)ILb([01])ELb([01])E", fn)
            if m:
                args = re.findall(r"Lb([01])E", m.group(2)) + ([m.group(3)] if m.group(3) else [])
                out[f"{m.group(1)}<{','.join(args)}>"] = rep
            elif half:
                out[f"{half.group(1)}<{half.group(2)},{half.group(3)}>"] = rep
            elif probe := re.search(r"probe_kernelILi(\d)E", fn):
                out[f"probe_kernel<{probe.group(1)}>"] = rep
    return out


def nee_kernel_resources(dev) -> dict:
    """Registers, stack bytes and resident warps per SM of the instances
    that config 4's and config 7's launches take (1000 spheres, matte): the
    production instance in raster order, the persistent one presorted, the
    recording one in the gradient's sorted frame (persistent), the probe
    (and on 20000 spheres, two tiles of shared memory), and the NEE
    backward in the replay and the residual mode."""
    tables = NE.nee_scene_tables(SC.big_scene(dev, 1000))
    keep = ("instance", "registers", "stack_bytes", "warps_per_sm", "threads", "blocks_per_sm")
    return {name: {k: r[k] for k in keep} for name, r in (
        ("nee_megakernel", NE.kernel_resources(tables)),
        ("nee_megakernel_presorted", NE.kernel_resources(tables, persistent=True)),
        ("nee_megakernel_record", NE.kernel_resources(tables, record=True, persistent=True)),
        ("primary_probe", NE.kernel_resources(tables, probe=True)),
        ("primary_probe_big20000",
         NE.kernel_resources(NE.nee_scene_tables(SC.big_scene(dev, 20000)), probe=True)),
        ("nee_megakernel_vjp", NV.kernel_resources(tables, residual=False)),
        ("nee_megakernel_vjp_residual", NV.kernel_resources(tables, residual=True)))}


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


def cuda_once(fn) -> dict:
    """One call of `fn` on CUDA events, with no warm-up, in ms."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return {"n": 1, "median_ms": start.elapsed_time(end)}


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


MODES = ("sample", "pixel")
# What the kernels line adds for the parity kernels (ops/megakernel.py:resources).
RESOURCE_KEYS = ("registers", "stack_bytes", "warps_per_sm")


def function_vs_plain(label, tables, has_dielectric, rays, rng, bounces, spp, seed, rows) -> list:
    """Both backward kernels, with loss = sum(radiance * wts), against the
    plain backward on the same inputs: the autograd Function, whose forward
    must be the forward kernel's output and which takes one thread per
    (pixel, sample) at spp > 1 (its forward the recording instance; the
    card's free memory holds every shape of this script) and one per pixel
    at one sample, and the other mode's kernel launched on its own with the
    same cotangent (the per-sample one from the rng at one sample).  The
    plain backward is timed on CUDA events (one call, over its tiles)."""
    geom, mat, counts = tables
    h, w = rng.shape[:2]
    wts = torch.as_tensor(
        np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32), device=rng.device)
    fwd = MK.launch_kernel(geom, mat, counts, rays, rng, bounces, spp, False, 3, has_dielectric)
    leaves = [t.clone().requires_grad_() for t in (geom, mat, rays.origin, rays.direction)]
    before = (MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES)
    radiance, rng_out = V.TraceInlineFusedDiff.apply(*leaves, rng, counts, bounces, spp,
                                                    has_dielectric)
    if not (torch.equal(radiance.detach(), fwd[0]) and torch.equal(rng_out, fwd[1])):
        raise AssertionError(f"{label}: the Function's forward is not the forward kernel's")
    function = torch.autograd.grad((radiance * wts).sum(), leaves)
    sample = spp > 1
    want_launches = (before[0] + sample, before[1] + 1, before[2] + sample)
    if (MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES) != want_launches:
        raise AssertionError(f"{label}: launches {before} -> "
                             f"{(MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES)}")
    if sample:
        got = {"sample": function,
               "pixel": V.launch_backward(*tables, rays, rng, wts, bounces, spp, has_dielectric)}
    else:
        got = {"pixel": function,
               "sample": V.launch_backward(*tables, rays, rng, wts, bounces, spp, has_dielectric,
                                           rng.view(h, w, 1, 4))}
    torch.cuda.reset_peak_memory_stats(rng.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_backward(tables, rays, rng, wts, bounces, spp, has_dielectric, rows)
    end.record()
    torch.cuda.synchronize()
    if not (want[1].abs().max() > 0):
        raise AssertionError(f"{label}: the material gradient is all zero")
    plain = {"plain_ms": start.elapsed_time(end),
             "peak_gib": torch.cuda.max_memory_allocated(rng.device) / 2**30}
    return [{**grad_errors(f"{label} {mode}", g, want, counts), "mode": mode,
             "through": "function" if (mode == "sample") == sample else "launch", **plain}
            for mode, g in got.items()]


def recording_vs_plain(scenes, dev) -> list:
    """Phase 7: the recording forward bit-equal to the production one, and
    its states equal to the plain version's (the rng at the start of every
    sample), on the three scenes."""
    out = []
    for name, (scene, cam) in scenes.items():
        w, h, bounces, spp = 96, 64, 6, 5
        tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 70 + len(out), dev)
        diel = scene.has_dielectric()
        rec = MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, diel, record=True)
        prod = MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, diel)
        want = MK.sample_states_reference(*tables, rays, rng, bounces, spp, diel)
        plain = MK.trace_tables_reference(*tables, rays, rng, bounces, spp, False, 3, diel)
        torch.cuda.synchronize()
        if not (torch.equal(rec[0], prod[0]) and torch.equal(rec[1], prod[1])):
            raise AssertionError(f"{name}: the recording forward is not the production one")
        states = (rec[2] == want).all(-1).double().mean().item()
        if states < RNG_MIN:
            raise AssertionError(f"{name}: recorded states equal on {states:.6f} (>= {RNG_MIN})")
        out.append({**check(f"record {name} {w}x{h} b{bounces} spp{spp}", rec[:2], plain),
                    "states_equal": states, "bit_equal_to_production": True})
    return out


def backward_vs_plain(scenes, dev) -> list:
    """Phase 7: the Function in both modes against the forward kernel and
    the plain backward, on the three scenes pitched at small shapes, and on
    the reference scene seen by its own camera at 3840x2160 / 1 spp / 4
    bounces (the plain backward over tiles of 540 rows).  The backward
    kernel refuses more bounces than its replay keeps, in both modes."""
    results = []
    for (w, h, bounces, spp) in [(128, 96, 4, 2), (67, 29, 3, 1)]:
        for name, (scene, cam) in scenes.items():
            rot = cam.rotation.tolist()
            pitched = Camera.create(cam.position.tolist(), [rot[0] - PITCH, rot[1], rot[2]], 90.0, dev)
            seed = len(results)
            tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
            results += function_vs_plain(
                f"{name} {w}x{h} b{bounces} spp{spp}", tables, scene.has_dielectric(),
                primary_rays(pitched, w, h), gen_seeds((h, w), seed, dev), bounces, spp, seed, h)
    scene, cam = scenes["main"]
    tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
    w, h = 3840, 2160
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)
    results += function_vs_plain(f"main {w}x{h} b4 spp1", tables, False, rays, rng, 4, 1, w, 540)
    before = V.LAUNCHES
    for samples in (None, rng.view(h, w, 1, 4)):
        try:
            V.launch_backward(*tables, rays, rng, torch.zeros_like(rays.origin), 17, 1, False, samples)
        except ValueError:
            pass
        else:
            raise AssertionError("the backward kernel took 17 bounces")
    if V.LAUNCHES != before:
        raise AssertionError("a refused backward launch was counted")
    return results


def backward_main_shape(tables, rays, rng, mix) -> dict:
    """Phase 7 at the training path's shape, 512x512 / 64 spp / 8 bounces:
    the check in both modes, the recording forward's and both backward
    kernels' times, the plain backward's (one sample at a time) and the
    bounds, on the same inputs."""
    bounces, spp = 8, 64
    cases = function_vs_plain("main 512x512 b8 spp64", tables, False, rays, rng, bounces, spp, 512,
                              512)
    wts = torch.as_tensor(
        np.random.default_rng(512).normal(size=(*rng.shape[:2], 3)).astype(np.float32), device=rng.device)
    states = MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, False, record=True)[2]
    pixels = rng.shape[0] * rng.shape[1]
    ops = bounce_ops(tables, mix, False, backward=True)
    base = BWD_BYTES_PER_PIXEL * pixels + 2 * table_bytes(tables)
    out = {"cases": cases, "ops": ops, "live_bounces": sum(mix),
           "record": {**cuda_times(lambda: MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3,
                                                            False, record=True), 30),
                      **bound(FWD_BYTES_PER_PIXEL * pixels + STATE_BYTES * pixels * spp
                              + table_bytes(tables), bounce_ops(tables, mix, False, backward=False))},
           "sample": {**cuda_times(lambda: V.launch_backward(*tables, rays, rng, wts, bounces, spp,
                                                             False, states), 20),
                      **bound(base + STATE_BYTES * pixels * spp, ops)},
           "pixel": {**cuda_times(lambda: V.launch_backward(*tables, rays, rng, wts, bounces, spp,
                                                            False), 20),
                     **bound(base, ops)}}
    # The plain version of the recording: the plain trace, sample by sample.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    MK.sample_states_reference(*tables, rays, rng, bounces, spp, False)
    end.record()
    torch.cuda.synchronize()
    out["record"]["plain_ms"] = start.elapsed_time(end)
    return out


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


def parity_launches() -> dict:
    """The parity kernels' launch counts: the forward's production and
    recording instances, the per-pixel and per-sample backward."""
    return {"megakernel": MK.LAUNCHES - MK.RECORD_LAUNCHES, "megakernel_record": MK.RECORD_LAUNCHES,
            "megakernel_vjp": V.LAUNCHES - V.SAMPLE_LAUNCHES,
            "megakernel_vjp_sample": V.SAMPLE_LAUNCHES}


def reset_parity_launches() -> None:
    MK.LAUNCHES = MK.RECORD_LAUNCHES = V.LAUNCHES = V.SAMPLE_LAUNCHES = 0


def training_path(dev) -> dict:
    """Phase 9: SGD on the reference scene towards a target rendered with
    the emitters' illuminance x1.5, through `loss_and_grad` on CUDA (the
    backward per sample at 64 spp, per pixel at 1 spp)."""
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
    reset_parity_launches()
    for (w, h, spp, bounces, steps), (rng, target) in zip(shapes, targets):
        label = f"{w}x{h}_spp{spp}_b{bounces}"
        # Launches per step: forward, recording forward, backward, per-sample
        # backward (one sample takes the per-pixel backward).
        sample = int(spp > 1)
        per_step = (1, sample, 1, sample)
        params, losses = params0, []
        t0 = time.perf_counter()
        for step in range(steps):
            before = (MK.LAUNCHES, MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES)
            loss, grads, params = sgd_step(params, scene, cam, target, rng, bounces, spp)
            after = (MK.LAUNCHES, MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES)
            if tuple(x - y for x, y in zip(after, before)) != per_step:
                raise AssertionError(f"{label} step {step}: launches {before} -> {after}, "
                                     f"not {per_step}")
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
    out["launches"] = parity_launches()
    return out


def kernel_resources(tables) -> dict:
    """Registers, stack bytes and resident warps per SM of the parity
    kernels' instances that the reference scene's launches take."""
    geom, _, counts = tables
    keep = ("instance", "registers", "stack_bytes", "warps_per_sm", "threads", "blocks_per_sm")
    return {name: {k: r[k] for k in keep} for name, r in (
        ("megakernel", MK.kernel_resources(geom, counts)),
        ("megakernel_record", MK.kernel_resources(geom, counts, record=True)),
        ("megakernel_vjp", V.kernel_resources(geom, counts)),
        ("megakernel_vjp_sample", V.kernel_resources(geom, counts, per_sample=True)))}


def training_times(scenes, dev) -> dict:
    """Phase 10: the fwd+bwd step at bench.py's shape, both backward
    kernels alone, ms per SGD step at both shapes, kernel vs plain backward
    at 128x96, and the kernels' resources."""
    scene, cam = world.main_scene(dev), world.initial_camera(dev)
    tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
    params = G.scene_to_params(scene)
    out = {"resources": kernel_resources(tables)}

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

    segments = w * h * spp * bounces
    live = live_segments(rng, MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, False)[1])
    ones = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(ones)
    states = MK.launch_kernel(*tables, rays, rng, bounces, spp, False, 3, False, record=True)[2]
    step = cuda_times(fwd_bwd, 20)
    rec = {"live_segment_share": live / segments, "step": step,
           "segments_per_s": segments / (step["median_ms"] / 1e3)}
    for mode in MODES:
        samples = states if mode == "sample" else None
        rec[mode] = {
            "backward_kernel": cuda_times(
                lambda: V.launch_backward(*tables, rays, rng, ones, bounces, spp, False, samples), 20),
            # The same work with a zero cotangent: every row cotangent is
            # then zero and the kernel skips its atomic adds, so the
            # difference is their cost.
            "backward_kernel_zero_cotangent": cuda_times(
                lambda: V.launch_backward(*tables, rays, rng, zeros, bounces, spp, False, samples), 20),
        }
    out["fwd_bwd_512x512_spp64_b8"] = rec
    del states

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
    states = MK.launch_kernel(*tables7, rays, rng, bounces, spp, False, 3, False, record=True)[2]
    out["compare_128x96_b4_spp2"] = {
        "kernel_sample": cuda_times(
            lambda: V.launch_backward(*tables7, rays, rng, wts, bounces, spp, False, states), 30),
        "kernel_pixel": cuda_times(
            lambda: V.launch_backward(*tables7, rays, rng, wts, bounces, spp, False), 30),
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


def warp_efficiency(steps, order=None) -> float:
    """The NEE kernel's warp efficiency under its flat loop, from the
    live-bounce telemetry [H, W] in the kernel's lane order (lane i is
    pixel order[i]): the lane-mean live bounces over the mean, over warps
    of 32 lanes, of the warp's cost, its longest lane's live bounces (a
    lane runs one live bounce per step, all its samples in one loop)."""
    lanes = steps.reshape(-1) if order is None else steps.reshape(-1)[order.long()]
    warps = lanes[:lanes.numel() // 32 * 32].double().reshape(-1, 32)
    return (warps.mean() / warps.amax(1).mean()).item()


def nested_warp_efficiency(words, spp, bounces) -> float:
    """What a nested sample x bounce loop would give on the same paths,
    from the recording instance's words [spp * bounces, lanes]: the
    lane-mean live bounces over the mean, over warps, of the sum over
    samples of the warp's longest path in that sample."""
    n = words.shape[1] // 32 * 32
    cost = torch.zeros(n // 32, dtype=torch.float64, device=words.device)
    live = 0.0
    for s in range(spp):
        # A path's live words lead its sample's words; what follows its
        # first dead word is not written.
        flags = (words[s * bounces:(s + 1) * bounces, :n] & NE.LIVE_BIT) != 0
        per_lane = torch.cumprod(flags.to(torch.int32), dim=0).sum(0).double()
        live += per_lane.sum().item()
        cost += per_lane.reshape(-1, 32).amax(1)
    return live / n / cost.mean().item()


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
        with plain_sphere_fold():
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


def probe_vs_plain(label, t0, prim0, t_ref, prim_ref) -> dict:
    """The probe's (t0, prim0) against the plain fold's: winners equal on at
    least PROBE_PRIM_MIN of the rays, t within PROBE_T_RTOL where both hit
    the same primitive, equal where both miss."""
    same = prim0 == prim_ref
    share = same.double().mean().item()
    hit = same & (t_ref < INFINITE)
    rel = ((t0 - t_ref).abs() / t_ref.abs())[hit].max().item() if hit.any() else 0.0
    if share < PROBE_PRIM_MIN or rel > PROBE_T_RTOL or not torch.equal(t0[~hit & same], t_ref[~hit & same]):
        raise AssertionError(f"probe, {label}: winners equal on {share:.6f}, t rel {rel}")
    return {"case": label, "prim_equal": share, "t_rel_err_max": rel,
            "max_abs_err": (t0 - t_ref)[hit].abs().max().item() if hit.any() else 0.0,
            "sky_share": (t_ref >= INFINITE).double().mean().item()}


def presort_identical(label, scene, rays, rng, bounces, spp) -> None:
    """The NEE kernel with the presort (probe, argsort, lane order, the
    persistent instance) against raster order, bit for bit."""
    raster = NE.trace_physical_nee(scene, rays, rng, bounces, spp, presort=False, telemetry=True)
    presorted = NE.trace_physical_nee(scene, rays, rng, bounces, spp, presort=True, telemetry=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(raster, presorted)):
        raise AssertionError(f"presort, {label}: a pixel's radiance, rng or telemetry changed")


# Phase 13's further scenes (nee_cases): planes, boxes and triangles after
# the spheres, and 20000 spheres, 20 of the probe's shared-memory tiles.
PRESORT_CASES = ("reference", "tri_emitters", "box_tri", "big20000")


def probe_check(dev) -> dict:
    """Phase 13: the probe against the plain fold on the config-4 scene at
    1920x1088 (the plain fold over row tiles), and the NEE kernel with the
    presort against raster order, bit for bit, at 1920x1088 / 2 spp / 4
    bounces; then both on PRESORT_CASES at their phase-11 shapes."""
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    rays, rng = primary_rays(cam, 1920, 1088), gen_seeds((1088, 1920), 7, dev)
    tables = NE.nee_scene_tables(scene)
    t0, prim0 = NE.launch_probe(tables, rays)
    with plain_sphere_fold():
        tiles = [nearest_t_prim(rays.origin[r:r + 136], rays.direction[r:r + 136], scene, 0.0)
                 for r in range(0, 1088, 136)]
    t_ref, prim_ref = torch.cat([t for t, _ in tiles]), torch.cat([p for _, p in tiles]).to(torch.int32)
    main = probe_vs_plain("big1000 1920x1088", t0, prim0, t_ref, prim_ref)
    presort_identical("big1000 1920x1088", scene, rays, rng, 4, 2)
    cases = []
    all_cases = nee_cases(dev)
    for label in PRESORT_CASES:
        scene, cam, w, h, bounces, spp = all_cases[label]
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 11, dev)
        tables = NE.nee_scene_tables(scene)
        t0, prim0 = NE.launch_probe(tables, rays)
        with plain_sphere_fold():
            t_ref, prim_ref = nearest_t_prim(rays.origin, rays.direction, scene, 0.0)
        case = probe_vs_plain(f"{label} {w}x{h}", t0, prim0, t_ref, prim_ref.to(torch.int32))
        presort_identical(case["case"], scene, rays, rng, bounces, spp)
        cases.append({**case, "presort_bit_identical": True, "primitives": list(tables.counts)})
    return {**{k: v for k, v in main.items() if k != "case"}, "presort_bit_identical": True,
            "max_abs_err": max([main["max_abs_err"]] + [c["max_abs_err"] for c in cases]),
            "cases": cases}


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
    steps = NE.launch_nee(tables, rays, rng, b, spp, False, False, telemetry=True)[2]
    live = int(steps.sum())
    t0, prim0 = NE.launch_probe(tables, rays)
    order = NE._presort_order(t0)
    efficiency = {}
    for frame, extra in (("raster", {}), ("presort", {"order": order, "primary": (t0, prim0)})):
        words = NE.launch_nee(tables, rays, rng, b, spp, False, False, record=True, **extra)[2]
        efficiency[frame] = {"flat_loop": warp_efficiency(steps, extra.get("order")),
                             "nested_loop": nested_warp_efficiency(words, spp, b)}
        del words

    def presorted():
        t0, prim0 = NE.launch_probe(tables, rays)
        return NE.launch_nee(tables, rays, rng, b, spp, False, False, order=NE._presort_order(t0),
                             primary=(t0, prim0))

    raster = cuda_times(lambda: NE.launch_nee(tables, rays, rng, b, spp, False, False), 3)
    sort = cuda_times(presorted, 3)
    raster2 = cuda_times(lambda: NE.launch_nee(tables, rays, rng, b, spp, False, False), 3)
    probe = cuda_times(lambda: NE.launch_probe(tables, rays), 20)
    out["config4_big1000_1920x1088_spp256_b4"] = {
        "raster": raster, "presort": sort, "raster_again": raster2,
        "live_share": live / (w * h * spp * b), "warp_efficiency": efficiency,
        "rays_per_s_suite_count": w * h * spp * b * 2 / (min(raster["median_ms"], sort["median_ms"]) / 1e3),
        "presort_gate": {"spheres_min": NE.PRESORT_MIN_SPHERES, "spp_min": NE.PRESORT_MIN_SPP},
        **nee_bound(tables, live, w * h)}
    out["probe_config4_1920x1088"] = {"kernel": probe, **probe_bound(tables, rays)}

    # Config 7's larger shape, 1920x1088 / 8 / 4, on the same scene: the
    # recording instance's warp efficiency in both frames.
    w, h, spp = 1920, 1088, 8
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 1, dev)
    t0, prim0 = NE.launch_probe(tables, rays)
    order = NE._presort_order(t0)
    efficiency = {}
    for frame, extra in (("raster", {}), ("sorted", {"order": order, "primary": (t0, prim0)})):
        steps, words = NE.launch_nee(tables, rays, rng, b, spp, False, False, telemetry=True, record=True,
                                     **extra)[2:]
        efficiency[frame] = {"flat_loop": warp_efficiency(steps, extra.get("order")),
                             "nested_loop": nested_warp_efficiency(words, spp, b)}
        del words
    out["config7_1920x1088_spp8_b4_record"] = {"warp_efficiency": efficiency,
                                               "live_share": int(steps.sum()) / (w * h * spp * b)}

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
    with plain_sphere_fold():
        probe_plain = cuda_times(lambda: nearest_t_prim(rays4.origin, rays4.direction, scene4, 0.0), 3)
    out["probe_800x600_big1000"] = {"kernel": probe_main, "plain": probe_plain, **probe_bound(tables4, rays4)}
    # And on 20000 spheres at 320x180 (20 tiles of the table).
    tables20k = NE.nee_scene_tables(SC.big_scene(dev, 20000))
    rays20k = primary_rays(cam4, 320, 180)
    out["probe_320x180_big20000"] = {"kernel": cuda_times(lambda: NE.launch_probe(tables20k, rays20k), 20),
                                     **probe_bound(tables20k, rays20k)}
    entries = {
        "nee_megakernel": {"ms": kernel["median_ms"], "plain_ms": plain["median_ms"],
                           "bound_ms": nee_b["bound_ms"], "bound_by": nee_b["bound_by"]},
        "primary_probe": {"ms": probe_main["median_ms"], "plain_ms": probe_plain["median_ms"],
                          **{k: out["probe_800x600_big1000"][k] for k in ("bound_ms", "bound_by")}},
    }
    return out, entries


# The physical/NEE gradient (phases 16-20).  Per SceneParams field a
# normalised error max|a - b| / max|b| below 5e-3, loss rtol 1e-5
# (tests/test_pallas_nee_vjp.py); the dual-query route against the plain
# one at rtol 5e-4, atol 5e-6 (tests/test_grad.py).
NEE_GRAD_TOL, LOSS_RTOL = 5e-3, 1e-5
FUSED_RTOL, FUSED_ATOL = 5e-4, 5e-6
NEE_GRAD_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_nee_grad_golden.npz")
# benchmarks/suite.py config 7: (width, height, spp, bounces, SGD steps here).
CONFIG7 = ((512, 512, 1, 4, 5), (1920, 1088, 8, 4, 2))
# The reverse of a live bounce, counted from csrc/nee_vjp.cuh as above for
# a matte sphere winner with a sphere-light sample (the config-7 scene's
# bounce; the other kinds cost about as much): the winner's distance and
# normal again (38), the light sample again (77), the NEE term's reverse
# (50), the cone's reverse (110), the cosine sample's (44), the normal's
# (32), the hit point's (15) and the distance's (44), with the throughput's
# (6).  The row sums' atomic adds are not counted.
NEE_REVERSE_OPS = 416
# Bytes per pixel of the backward: rays 24, rng 16 and the radiance
# cotangent 12 in, ray cotangents 24 out, and in the sorted frame the lane
# order and the probe's (t0, prim0), 12 more.  The tables are read and their
# cotangents written, 4 B per entry each.  The dual fold: 12 words in
# (shade point, two directions, t_light, light index, alive), 3 out.
NEE_BWD_BYTES_PER_PIXEL, SORTED_BYTES_PER_PIXEL, DUAL_BYTES_PER_RAY = 76, 12, 60


def field_errors(label, got, want, tol=NEE_GRAD_TOL, min_nonzero=1, tied=()) -> dict:
    """Per-field normalised errors of two {field: tensor} gradients; the
    fields in `tied` are reported under "tie_gap" and not held."""
    errs, gaps, nonzero = {}, {}, 0
    for f, w in want.items():
        if w.numel() == 0:
            continue
        g = got[f]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {f} is not finite")
        err = ((g - w).abs().max() / torch.clamp(w.abs().max(), min=1e-6)).item()
        (gaps if f in tied else errs)[f] = err
        nonzero += int(w.abs().max() > 0)
    bad = {f: e for f, e in errs.items() if e >= tol}
    if bad or nonzero < min_nonzero:
        raise AssertionError(f"{label}: normalised errors {bad}, {nonzero} nonzero fields")
    out = {"max_err": max(errs.values()), "worst_field": max(errs, key=errs.get),
           "nonzero_fields": nonzero}
    return {**out, "tie_gap": gaps} if tied else out


def lane_robust_error(label, got, want, tol=NEE_GRAD_TOL) -> float:
    """A ray cotangent held per lane, as lane_parity counts lanes: the share
    of lanes with max|a - b| / max|b| >= tol must stay within 0.5%."""
    lane = (got - want).abs().amax(-1) / torch.clamp(want.abs().max(), min=1e-6)
    off = (lane >= tol).double().mean().item()
    if off > LANE_MAX_DIVERGED:
        raise AssertionError(f"{label}: ray cotangent off on {off:.4%} of lanes")
    return lane.max().item()


# Config 8's two emitter triangles are coplanar and overlap, so a ray that
# meets their overlap meets both at the same t.  Autograd of the plain
# fold's min splits such a tie's cotangent between the two; the kernel, like
# the TPU kernel it replaces, recomputes the distance of the fold's winner,
# the first index, and gives it all to that one.  The vertex fields of that
# scene are reported (`tie_gap`), not held; every other field is.
TIED_FIELDS = {"tri_emitters": ("tri_v0", "tri_v1", "tri_v2")}


def nee_grad_cases(dev):
    """Phase 16's cases: (label, scene, camera, width, height, bounces, spp)."""
    ref, cam4 = world.initial_camera(dev), Camera.create(*CAM4, 90.0, dev)
    origin = Camera.create([0.0] * 3, [0.0] * 3, 90.0, dev)
    return [
        ("cornell8", SC.cornell_scene(dev), ref, 96, 64, 4, 2),
        ("tri_emitters", SC.tri_emitter_scene(dev), ref, 96, 64, 4, 2),
        ("glassy", SC.glassy_scene(dev), origin, 96, 64, 6, 2),
        ("zero_light", SC.zero_light_scene(dev), ref, 96, 64, 4, 2),
        ("big1000", SC.big_scene(dev, 1000), cam4, 64, 64, 4, 2),
        # Cotangent tiles (258 kB) above the card's opt-in shared memory:
        # the residual mode's global atomics.
        ("big4000", SC.big_scene(dev, 4000), cam4, 64, 64, 4, 2),
        # 1943 pixels: a ragged last block.
        ("cornell8_ragged", SC.cornell_scene(dev), ref, 67, 29, 3, 1),
        ("glassy_b15", SC.glassy_scene(dev), origin, 48, 32, 15, 1),
        # spp that is no multiple of the replay mode's chunk (34 samples at
        # 15 bounces, 32 at 16): chunks of 34 + 6 and of 32 + 32 + 6.
        ("glassy_b15_spp40", SC.glassy_scene(dev), origin, 16, 12, 15, 40),
        ("cornell8_b16_spp70", SC.cornell_scene(dev), ref, 16, 12, 16, 70),
    ]


@contextlib.contextmanager
def nv_settings(**settings):
    """Module constants of `ops/nee_vjp.py` set for the block
    (RESIDUAL_MAX_BYTES=0: the replay mode)."""
    saved = {k: getattr(NV, k) for k in settings}
    for k, v in settings.items():
        setattr(NV, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(NV, k, v)


# The residual mode's cotangent tiles in shared memory wherever they fit
# (RESIDUAL_TILE_MAX_BYTES above the card's opt-in limit; the launch takes
# them only within it) and in device memory.
TILE_PLACEMENTS = {"shared": {"RESIDUAL_TILE_MAX_BYTES": 1 << 30},
                   "device": {"RESIDUAL_TILE_MAX_BYTES": 0}}
# Phase 20's table sizes for the two placements: 1000, 1600 and 3400
# spheres, 64.7, 103.4 and 219.6 kB of tiles, at most 3, 2 and 1 resident
# blocks per SM of an H100 (228 KB) with the tiles.
TILE_SWEEP_SPHERES = (1000, 1600, 3400)


def nee_backward_vs_plain(dev) -> dict:
    """Phase 16: on every case, `loss_and_grad(backend="cuda", light_idx)`
    in the residual mode (the default) and in the replay mode (the byte
    budget set to 0) against backend="torch"; the backward kernel in raster
    and in sorted order, in both modes, against the plain backward
    (`backward_reference`, autograd of the plain trace, the kernel's table
    cotangents mapped to the scene's leaves by `table_grads_to_leaves`), and
    the residual mode against the replay mode; the Function's forward
    against the NEE kernel and the sorted frame's against the raster one,
    bit for bit.  The kernel refuses 17 bounces."""
    cases, max_abs, resid_max_abs, sky = [], 0.0, 0.0, 0
    for label, scene, cam, w, h, bounces, spp in nee_grad_cases(dev):
        li, kinds = NE.scene_light_indices(scene), _present_kinds(scene)
        glossy, diel = 1 in kinds, 2 in kinds
        tied = TIED_FIELDS.get(label, ())
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), len(cases) + 200, dev)
        params, target = G.scene_to_params(scene), torch.full((h, w, 3), 0.2, device=dev)
        with plain_sphere_fold():
            loss_t, g_t = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp,
                                          estimator="physical", backend="torch")
        rec = {"case": f"{label} {w}x{h} b{bounces} spp{spp}"}
        for mode, budget in (("residual", NV.RESIDUAL_MAX_BYTES), ("replay", 0)):
            before = (NV.LAUNCHES, NV.RESIDUAL_LAUNCHES, NE.RECORD_LAUNCHES)
            with nv_settings(RESIDUAL_MAX_BYTES=budget):
                loss_c, g_c = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces,
                                              spp=spp, estimator="physical", backend="cuda", light_idx=li)
            resid = int(mode == "residual")
            if (NV.LAUNCHES, NV.RESIDUAL_LAUNCHES, NE.RECORD_LAUNCHES) != (
                    before[0] + 1, before[1] + resid, before[2] + resid):
                raise AssertionError(f"{label}: loss_and_grad(cuda) in the {mode} mode did not launch "
                                     f"its forward and backward once")
            rel = abs(loss_c.item() - loss_t.item()) / abs(loss_t.item())
            if rel > LOSS_RTOL:
                raise AssertionError(f"{label} {mode}: loss {loss_c.item()} vs {loss_t.item()}")
            rec[f"loss_and_grad_{mode}"] = {
                "loss_rel_err": rel,
                **field_errors(f"{label} {mode}", g_c._asdict(), g_t._asdict(),
                               min_nonzero=3 if label == "zero_light" else 8, tied=tied)}

        wts = torch.as_tensor(np.random.default_rng(len(cases)).normal(size=(h, w, 3)).astype(np.float32),
                              device=dev)
        tables = NE.nee_scene_tables(scene, li)
        with plain_sphere_fold():
            want, w_o, w_d = NV.backward_reference(scene, rays, rng, wts, bounces, spp, kinds)
        t0, prim0 = NE.launch_probe(tables, rays)
        order = NE._presort_order(t0)
        for frame, extra in (("raster", {}), ("sorted", {"order": order, "primary": (t0, prim0)})):
            got = NV.launch_nee_backward(tables, rays, rng, wts, bounces, spp, glossy, diel, **extra)
            words = NE.launch_nee(tables, rays, rng, bounces, spp, glossy, diel, record=True, **extra)[2]
            resid = NV.launch_nee_backward(tables, rays, rng, wts, bounces, spp, glossy, diel,
                                           words=words, **extra)
            replay_rays_equal(f"{label} {frame}", got, resid)
            sky += int((t0 >= INFINITE).sum())
            if got[3][t0 >= INFINITE].any() or got[4][t0 >= INFINITE].any():
                raise AssertionError(f"{label} {frame}: a pixel whose paths all end at bounce 0 has a "
                                     f"nonzero ray cotangent")
            leaf = NV.table_grads_to_leaves(scene, li, *got[:3])
            leaf_r = NV.table_grads_to_leaves(scene, li, *resid[:3])
            rec[frame] = {
                "rays_bit_equal_to_residual": True,
                "vs_backward_reference": field_errors(f"{label} {frame}", leaf, want, tied=tied),
                "d_origin": lane_robust_error(f"{label} {frame} d_origin", got[3], w_o),
                "d_direction": lane_robust_error(f"{label} {frame} d_direction", got[4], w_d),
                "residual_vs_backward_reference": field_errors(f"{label} {frame} residual", leaf_r, want,
                                                               tied=tied),
                "residual_vs_replay": field_errors(f"{label} {frame} residual vs replay", leaf_r, leaf),
                "residual_d_origin": lane_robust_error(f"{label} {frame} residual d_origin", resid[3], w_o),
                "residual_d_direction": lane_robust_error(f"{label} {frame} residual d_direction",
                                                          resid[4], w_d),
            }
            max_abs = max(max_abs, *((leaf[f] - x).abs().max().item() for f, x in want.items()
                                     if x.numel() and f not in tied))
            resid_max_abs = max(resid_max_abs, *((leaf_r[f] - x).abs().max().item()
                                                 for f, x in want.items() if x.numel() and f not in tied))
        outs = [NV.trace_physical_nee_diff(scene, rays, rng, bounces, spp, li, kinds, sorted_lanes=s)
                for s in (False, True)]
        if not (torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])):
            raise AssertionError(f"{label}: the sorted frame changed a pixel's radiance or rng")
        fwd = NE.launch_nee(tables, rays, rng, bounces, spp, glossy, diel)
        if not (torch.equal(outs[0][0], fwd[0]) and torch.equal(outs[0][1], fwd[1])):
            raise AssertionError(f"{label}: the Function's forward is not the NEE kernel's")
        rec["sorted_forward_bit_identical"] = True
        cases.append(rec)
    before = NV.LAUNCHES
    try:
        NV.launch_nee_backward(tables, rays, rng, wts, 17, 1)
    except ValueError:
        pass
    else:
        raise AssertionError("the NEE backward kernel took 17 bounces")
    if NV.LAUNCHES != before:
        raise AssertionError("a refused NEE backward launch was counted")
    if sky == 0:
        raise AssertionError("no case has a pixel whose paths all end at bounce 0")
    emitters = many_emitters_check(dev)
    max_abs = max(max_abs, emitters.pop("max_abs_err"))
    return {"max_abs_err": max_abs, "residual_max_abs_err": resid_max_abs, "sky_pixels": sky,
            "cases": cases, "many_emitters": emitters}


def replay_rays_equal(label, replay, resid) -> None:
    """The replay mode's ray cotangents against the residual mode's on the
    same inputs, bit for bit: both reverse the same words (the replay mode
    records them with the recording forward's own loop) in the same sample
    order."""
    for k, name in ((3, "d_origin"), (4, "d_direction")):
        if not torch.equal(replay[k], resid[k]):
            off = (replay[k] != resid[k]).any(-1)
            raise AssertionError(f"{label}: the replay mode's {name} differs from the residual mode's on "
                                 f"{int(off.sum())} lanes, by up to {(replay[k] - resid[k]).abs().max().item()}")


# The replay mode's second way in: more emitters than the residual mode's
# light tile holds (768).  1000 spheres of config 4's layout, 90% of them
# emitters, at 64x64 / 2 spp / 4 bounces.
MANY_EMITTERS = (1000, 0.9, 64, 64, 2, 4)


def many_emitters_check(dev) -> dict:
    """Phase 16's scene of more than 768 emitters: `loss_and_grad(
    backend="cuda", light_idx)` launches the replay mode (no recording
    forward, no residual launch) and agrees with backend="torch"; the
    kernel in raster and sorted order against the plain backward."""
    n, share, w, h, spp, bounces = MANY_EMITTERS
    scene, cam = SC.big_scene(dev, n, emitter_share=share), Camera.create(*CAM4, 90.0, dev)
    li = NE.scene_light_indices(scene)
    if len(li) <= NV.RESIDUAL_LIGHT_TILE_MAX_BYTES // 64:
        raise AssertionError(f"the many-emitter scene has only {len(li)} emitters")
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 31, dev)
    params, target = G.scene_to_params(scene), torch.full((h, w, 3), 0.2, device=dev)
    with plain_sphere_fold():
        loss_t, g_t = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp,
                                      estimator="physical", backend="torch")
    before = (NV.LAUNCHES, NV.RESIDUAL_LAUNCHES, NE.RECORD_LAUNCHES)
    loss_c, g_c = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp,
                                  estimator="physical", backend="cuda", light_idx=li)
    if (NV.LAUNCHES, NV.RESIDUAL_LAUNCHES, NE.RECORD_LAUNCHES) != (before[0] + 1, *before[1:]):
        raise AssertionError("many emitters: loss_and_grad(cuda) did not launch the replay mode once")
    rel = abs(loss_c.item() - loss_t.item()) / abs(loss_t.item())
    if rel > LOSS_RTOL:
        raise AssertionError(f"many emitters: loss {loss_c.item()} vs {loss_t.item()}")
    label = f"{len(li)} emitters {w}x{h} b{bounces} spp{spp}"
    rec = {"case": label, "emitters": len(li), "loss_rel_err": rel,
           "loss_and_grad_replay": field_errors(f"{label} loss_and_grad", g_c._asdict(), g_t._asdict(),
                                                min_nonzero=4)}
    wts = torch.as_tensor(np.random.default_rng(31).normal(size=(h, w, 3)).astype(np.float32), device=dev)
    tables = NE.nee_scene_tables(scene, li)
    with plain_sphere_fold():
        want, w_o, w_d = NV.backward_reference(scene, rays, rng, wts, bounces, spp)
    t0, prim0 = NE.launch_probe(tables, rays)
    max_abs = 0.0
    for frame, extra in (("raster", {}), ("sorted", {"order": NE._presort_order(t0), "primary": (t0, prim0)})):
        got = NV.launch_nee_backward(tables, rays, rng, wts, bounces, spp, False, False, **extra)
        leaf = NV.table_grads_to_leaves(scene, li, *got[:3])
        rec[frame] = {"vs_backward_reference": field_errors(f"{label} {frame}", leaf, want, min_nonzero=4),
                      "d_origin": lane_robust_error(f"{label} {frame} d_origin", got[3], w_o),
                      "d_direction": lane_robust_error(f"{label} {frame} d_direction", got[4], w_d)}
        max_abs = max(max_abs, *((leaf[f] - x).abs().max().item() for f, x in want.items() if x.numel()))
    return {**rec, "max_abs_err": max_abs}


def nee_backward_vs_golden(dev) -> list:
    """Phase 17: the kernel route (`trace_physical_nee_diff` through
    `params_to_scene`) on the golden cases' inputs against `jax.vjp` of the
    JAX package's XLA estimator."""
    results = []
    with np.load(NEE_GRAD_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    for case in sorted({k.split("__")[0] for k in golden}):
        arr = {k[len(case) + 2:]: v for k, v in golden.items() if k.startswith(f"{case}__")}
        template = C.scene_from_numpy(
            {k[len("scene__"):]: v for k, v in arr.items() if k.startswith("scene__")}, dev)
        spp, bounces = arr["config"].tolist()
        rng = C.rng_from_numpy(arr["rng_in"], dev)
        o = torch.as_tensor(arr["origin"], device=dev).requires_grad_()
        d = torch.as_tensor(arr["direction"], device=dev).requires_grad_()
        leaves = [p.detach().requires_grad_() for p in G.scene_to_params(template)]
        scene = G.params_to_scene(G.SceneParams(*leaves), template)
        rad, _ = NV.trace_physical_nee_diff(scene, Rays(origin=o, direction=d), rng, bounces, spp,
                                            light_idx=tuple(arr["light_idx"].tolist()))
        wts = torch.as_tensor(arr["wts"], device=dev)
        grads = torch.autograd.grad((rad / spp * wts).sum(), [*leaves, o, d], allow_unused=True)
        got = {f: torch.zeros_like(x) if g is None else g
               for f, g, x in zip(G.SceneParams._fields, grads, leaves)}
        want = {f: torch.as_tensor(arr[f"d_{f}"], device=dev) for f in G.SceneParams._fields}
        label = f"golden {case} 32x16 b{bounces} spp{spp}"
        results.append({"case": label, **field_errors(label, got, want, min_nonzero=8),
                        "d_origin": lane_robust_error(label, grads[-2], torch.as_tensor(arr["d_origin"], device=dev)),
                        "d_direction": lane_robust_error(label, grads[-1],
                                                         torch.as_tensor(arr["d_direction"], device=dev))})
    return results


def dual_inputs(scene, light_idx, w, h, seed, dev):
    """The dual query's operands at the first bounce of (w, h) camera rays
    of suite config 4's camera: shade points at the primary hits (alive
    where there is one), BSDF directions in the normal's hemisphere, shadow
    rays towards a random emitter, ending at its surface."""
    rays = primary_rays(Camera.create(*CAM4, 90.0, dev), w, h)
    o, dirs = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    t, prim = nearest_t_prim(o, dirs, scene, 0.0)
    alive = t < INFINITE
    p = o + dirs * torch.where(alive, t, 0.0)[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = torch.nn.functional.normalize(torch.randn(p.shape, device=dev, generator=gen), dim=-1)
    d_bsdf = torch.where((n * dirs).sum(-1, keepdim=True) > 0, -n, n)
    li = torch.tensor(light_idx, device=dev)[torch.randint(len(light_idx), (len(p),), device=dev, generator=gen)]
    to_c = scene.spheres.pos[li] - p
    dist = to_c.norm(dim=-1)
    t_light = torch.clamp(dist - scene.spheres.radius[li], min=1e-3)
    return (p.contiguous(), d_bsdf.contiguous(), (to_c / dist[:, None]).contiguous(), t_light.contiguous(),
            li.to(torch.int32), alive.to(torch.int32))


def nearest_plain(scene, o, d, eps=0.0):
    """The nearest-sphere fold's plain version over tiles of 2^18 rays."""
    parts = [sphere_nearest_chunked(o[s:s + (1 << 18)], d[s:s + (1 << 18)], scene.spheres, eps)
             for s in range(0, len(o), 1 << 18)]
    return torch.cat([t for t, _ in parts]), torch.cat([p for _, p in parts]).to(torch.int32)


# Phase 18's synthetic fold cases: tables of 1, 129, 3073 (just past the 48
# KB that static shared memory held) and 14529 spheres (just past the 227 KB
# a block can hold), rows P // 2 and P - 1 repeating rows 1 and 0 (exact
# ties); ray counts that are no multiple of rays per thread x block (the
# nearest fold takes 2 rays per thread at the first two on an H100, 1 at
# the last).
FOLD_EDGE_SPHERES = (1, 129, 3073, 14529)
FOLD_EDGE_RAYS = (270413, 135213, 10007)


def fold_edge_checks(dev) -> dict:
    """The two fold kernels against their plain versions, bit for bit, on
    the synthetic tables: per table and ray count the nearest fold at eps 0
    and at a distance one ray meets exactly (t == eps), and the dual fold
    with 30% of its lanes dead; per table, the dual fold with every lane
    dead and every lane alive; and a table followed by its own copy (3074
    rows, the copies in different tiles), whose every tie goes to the first
    copy."""
    out = {}

    def held(label, got, want):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: the kernel differs from its plain version")
        return {"bit_equal": True, "hit_share": (want[0] < INFINITE).double().mean().item()}

    def dual_plain(pos, radius, args):
        return SF.sphere_dual_reference(*args, pos, radius)

    for P in FOLD_EDGE_SPHERES:
        pos, radius = edge_spheres(P, P, dev)
        table, spheres = SF.sphere_table(pos, radius), Spheres(pos=pos, radius=radius, material=None)
        rays = edge_rays(pos, radius, FOLD_EDGE_RAYS[0], P + 1)
        t0 = sphere_nearest_chunked(rays[0][:256], rays[1][:256], spheres)[0]
        edge_eps = float(t0[t0 < INFINITE].max()) if (t0 < INFINITE).any() else 0.0
        for n in FOLD_EDGE_RAYS:
            args = tuple(a[:n].contiguous() for a in rays)
            rec = {"instances": {k: SF.kernel_resources(k == "dual", n, P)["instance"]
                                 for k in ("nearest", "dual")}}
            for eps in (0.0, edge_eps):
                want = sphere_nearest_chunked(args[0], args[1], spheres, eps)
                rec[f"nearest_eps_{eps}"] = held(f"nearest fold, {P} spheres, {n} rays, eps {eps}",
                                                 SF.launch_nearest_fold(table, args[0], args[1], eps),
                                                 (want[0], want[1].to(torch.int32)))
            rec["dual"] = held(f"dual fold, {P} spheres, {n} rays", SF.launch_dual_fold(table, *args),
                               dual_plain(pos, radius, args))
            out[f"{P}_spheres_{n}_rays"] = rec
        for label, alive in (("all_dead", torch.zeros_like(rays[5])), ("all_alive", torch.ones_like(rays[5]))):
            args = rays[:5] + (alive,)
            got = SF.launch_dual_fold(table, *args)
            out[f"{P}_spheres_dual_{label}"] = held(f"dual fold, {P} spheres, {label}", got,
                                                    dual_plain(pos, radius, args))
            if label == "all_dead" and not ((got[0] == INFINITE).all() and (got[1] == 0).all()
                                            and not got[2].any()):
                raise AssertionError("dual fold: a dead lane is not (INFINITE, 0, False)")
    pos, radius = edge_spheres(1537, 7, dev)
    pos, radius = torch.cat([pos, pos]), torch.cat([radius, radius])
    table, spheres = SF.sphere_table(pos, radius), Spheres(pos=pos, radius=radius, material=None)
    rays = edge_rays(pos, radius, FOLD_EDGE_RAYS[0], 8)
    want = sphere_nearest_chunked(rays[0], rays[1], spheres, EPSILON)
    rec = {"nearest": held("nearest fold, doubled table", SF.launch_nearest_fold(
        table, rays[0], rays[1], EPSILON), (want[0], want[1].to(torch.int32))),
        "dual": held("dual fold, doubled table", SF.launch_dual_fold(table, *rays),
                     dual_plain(pos, radius, rays))}
    hit = want[0] < INFINITE
    if not hit.any() or (want[1][hit] >= 1537).any():
        raise AssertionError("doubled table: a tie went to the second copy")
    out["doubled_3074_spheres"] = rec
    return out


def fold_checks(dev) -> dict:
    """Phase 18: the nearest-sphere kernel (the camera rays, eps = 0, and
    the first bounce's BSDF rays, eps = EPSILON) and the dual-fold kernel
    against their plain versions at 1000 spheres (1920x1088 rays) and 20000
    (320x180), the dual fold with dead lanes; the dual-query trace against
    the plain one (lane parity); the gradient's dual-query route
    (`light_idx=None`), counted from 0, against backend="torch"."""
    out, max_abs, nearest_abs = {}, 0.0, 0.0
    for n_spheres, w, h in ((1000, 1920, 1088), (20000, 320, 180)):
        scene = SC.big_scene(dev, n_spheres)
        table = SF.sphere_table(scene.spheres.pos, scene.spheres.radius)
        rays = primary_rays(Camera.create(*CAM4, 90.0, dev), w, h)
        args = dual_inputs(scene, NE.scene_light_indices(scene), w, h, n_spheres, dev)
        live = args[5] != 0
        for label, o, d, eps in (("camera", rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3), 0.0),
                                 ("bounce", args[0][live].contiguous(), args[1][live].contiguous(),
                                  float(EPSILON))):
            got = SF.launch_nearest_fold(table, o, d, eps)
            want = nearest_plain(scene, o, d, eps)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"nearest fold at {n_spheres} spheres ({label} rays) differs "
                                     "from its plain version")
            hit = want[0] < INFINITE
            nearest_abs = max(nearest_abs, (got[0] - want[0])[hit].abs().max().item())
            out[f"nearest_vs_plain_{n_spheres}_spheres_{w}x{h}_{label}"] = {
                "bit_equal": True, "rays": len(o), "hit_share": hit.double().mean().item()}
        got = SF.launch_dual_fold(table, *args)
        want = [], [], []
        for s in range(0, len(args[0]), 1 << 18):
            part = SF.sphere_dual_reference(*(a[s:s + (1 << 18)] for a in args),
                                            scene.spheres.pos, scene.spheres.radius)
            for acc, x in zip(want, part):
                acc.append(x)
        want = [torch.cat(x) for x in want]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"dual fold at {n_spheres} spheres differs from its plain version")
        hit = want[0] < INFINITE
        max_abs = max(max_abs, (got[0] - want[0])[hit].abs().max().item())
        out[f"kernel_vs_plain_{n_spheres}_spheres_{w}x{h}"] = {
            "bit_equal": True, "alive_share": args[5].double().mean().item(),
            "hit_share": hit.double().mean().item(), "occluded_share": want[2].double().mean().item()}

    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    rays, rng = primary_rays(cam, 256, 144), gen_seeds((144, 256), 18, dev)
    fused = RN.trace_physical(scene, rays, rng, 4, fused=True)
    with plain_sphere_fold():
        plain = RN.trace_physical(scene, rays, rng, 4, fused=False)
    out["fused_trace_vs_plain_256x144_b4"] = lane_parity("fused trace", fused, plain)

    routes = []
    for label, scene, cam, w, h in (("big1000", SC.big_scene(dev, 1000), cam, 128, 72),
                                    ("cornell8", SC.cornell_scene(dev), world.initial_camera(dev), 96, 64)):
        bounces, spp = 4, 2
        rng = gen_seeds((h, w), 19, dev)
        params, target = G.scene_to_params(scene), torch.full((h, w, 3), 0.2, device=dev)
        NV.LAUNCHES = 0
        SF.LAUNCHES.update(nearest_fold=0, dual_fold=0)
        NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
        loss_c, g_c = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp,
                                      estimator="physical", backend="cuda")
        launches = {**SF.LAUNCHES, "nee_megakernel_vjp": NV.LAUNCHES, **NE.LAUNCHES}
        # One primary hit per sample: the nearest-sphere kernel's above
        # CHUNKED_THRESHOLD primitives, as in the JAX package.
        primary = spp if scene.num_primitives > CHUNKED_THRESHOLD else 0
        if launches != {"nearest_fold": primary, "dual_fold": spp * bounces, "nee_megakernel_vjp": 0,
                        "nee_megakernel": 0, "primary_probe": 0}:
            raise AssertionError(f"{label}: dual-query route launches {launches}")
        with plain_sphere_fold():
            loss_t, g_t = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp,
                                          estimator="physical", backend="torch")
        if abs(loss_c.item() - loss_t.item()) > LOSS_RTOL * abs(loss_t.item()):
            raise AssertionError(f"{label}: dual-query loss {loss_c.item()} vs {loss_t.item()}")
        for f in G.SceneParams._fields:
            a, b = getattr(g_c, f), getattr(g_t, f)
            if not torch.allclose(a, b, rtol=FUSED_RTOL, atol=FUSED_ATOL):
                raise AssertionError(f"{label}: dual-query gradient {f} off by {(a - b).abs().max().item()}")
        routes.append({"case": f"{label} {w}x{h} b{bounces} spp{spp}", "launches": launches,
                       "max_abs_grad_diff": max((getattr(g_c, f) - getattr(g_t, f)).abs().max().item()
                                                for f in G.SceneParams._fields if getattr(g_t, f).numel())})
    out["gradient_route_light_idx_none"] = routes
    out["launches"] = {k: routes[0]["launches"][k] for k in ("nearest_fold", "dual_fold")}
    out["edge_cases"] = fold_edge_checks(dev)
    return {"max_abs_err": max_abs, "nearest_max_abs_err": nearest_abs, **out}


# Fields that move geometry.  Phase 19's SGD leaves them: visibility is not
# differentiated, so a move of any size flips single pixels between an
# emitter and what lies behind it, and the loss jumps (1e-5 of the scale
# did it within 5 steps of a CPU run at 96x96).
GEOMETRY_FIELDS = ("sphere_pos", "sphere_radius", "plane_pos", "plane_normal", "box_lo", "box_hi",
                   "tri_v0", "tri_v1", "tri_v2")


def sgd_rates(params, grads) -> dict:
    """SGD step sizes of the material fields, set from the first gradient
    so that a field moves by at most 0.5% of its scale per step (the
    suite's fixed lr 1e-6 barely moves this loss)."""
    return {f: 5e-3 * (p.abs().max().item() + 1e-3) / g.abs().max().item()
            for f, p, g in zip(G.SceneParams._fields, params, grads)
            if f not in GEOMETRY_FIELDS and g.numel() and g.abs().max() > 0}


def sgd_update(params, grads, rates):
    return G.SceneParams(*(p - rates.get(f, 0.0) * g
                           for f, p, g in zip(G.SceneParams._fields, params, grads)))


def physical_training_path(dev) -> dict:
    """Phase 19, counted from 0: SGD through `loss_and_grad(estimator=
    "physical", light_idx=...)` on suite config 7's scene and camera towards
    a target rendered with the emitters' illuminance halved, 5 steps at
    512x512 / 1 spp / 4 bounces and 2 at 1920x1088 / 8 / 4, every one in
    the residual mode (the recording forward and the fold-free backward);
    then one more step at 512x512 / 1 / 4 with the byte budget at 0, the
    replay mode that a gradient above the budget takes."""
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    li, kinds = NE.scene_light_indices(scene), _present_kinds(scene)
    params0 = G.scene_to_params(scene)
    dimmer = G.params_to_scene(params0._replace(sphere_illum=params0.sphere_illum * 0.5), scene)
    targets = []
    with torch.no_grad():
        for w, h, spp, bounces, _ in CONFIG7:
            rng = gen_seeds((h, w), 1, dev)
            targets.append((rng, G.render_radiance(dimmer, cam, rng, w, h, bounces, spp, estimator="physical",
                                                   light_idx=li, kinds=kinds)))
    torch.cuda.synchronize()

    out = {}
    NV.LAUNCHES = NV.RESIDUAL_LAUNCHES = NE.RECORD_LAUNCHES = MK.LAUNCHES = V.LAUNCHES = 0
    SF.LAUNCHES.update(nearest_fold=0, dual_fold=0)
    NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
    runs = [(shape, data, NV.RESIDUAL_MAX_BYTES) for shape, data in zip(CONFIG7, targets)]
    runs.append(((*CONFIG7[0][:4], 1), targets[0], 0))
    for (w, h, spp, bounces, steps), (rng, target), budget in runs:
        resid = int(budget > 0)
        label = f"{w}x{h}_spp{spp}_b{bounces}" + ("" if resid else "_replay_mode")
        sort = NV.sorted_default(scene)
        params, losses, rates = params0, [], None
        t0 = time.perf_counter()
        for step in range(steps):
            counts = lambda: (NE.LAUNCHES["nee_megakernel"], NE.RECORD_LAUNCHES,  # noqa: E731
                              NE.LAUNCHES["primary_probe"], NV.LAUNCHES, NV.RESIDUAL_LAUNCHES)
            before = counts()
            with nv_settings(RESIDUAL_MAX_BYTES=budget):
                loss, grads = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces,
                                              spp=spp, estimator="physical", light_idx=li, kinds=kinds)
            after = counts()
            if tuple(a - b for a, b in zip(after, before)) != (1, resid, int(sort), 1, resid):
                raise AssertionError(f"{label} step {step}: launches {before} -> {after}")
            bad = [f for f, g in grads._asdict().items() if not torch.isfinite(g).all()]
            if bad or not torch.isfinite(loss):
                raise AssertionError(f"{label} step {step}: not finite: {bad}")
            losses.append(loss)
            rates = rates or sgd_rates(params, grads)
            params = sgd_update(params, grads, rates)
        with torch.no_grad():
            losses.append(G.image_loss(params, scene, cam, target, rng, bounces, spp, estimator="physical",
                                       light_idx=li, kinds=kinds))
        losses = [float(x) for x in losses]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss did not fall: {losses}")
        out[label] = {"losses": losses, "rates": rates, "sorted_frame": sort,
                      "wall_s": time.perf_counter() - t0}
    out["launches"] = {"nee_megakernel": NE.LAUNCHES["nee_megakernel"],
                       "nee_record": NE.RECORD_LAUNCHES,
                       "primary_probe": NE.LAUNCHES["primary_probe"],
                       "nee_megakernel_vjp": NV.LAUNCHES - NV.RESIDUAL_LAUNCHES,
                       "nee_megakernel_vjp_residual": NV.RESIDUAL_LAUNCHES,
                       **SF.LAUNCHES, "megakernel": MK.LAUNCHES, "megakernel_vjp": V.LAUNCHES}
    if any(out["launches"][k] for k in ("nearest_fold", "dual_fold", "megakernel", "megakernel_vjp")):
        raise AssertionError(f"physical training path launched other kernels: {out['launches']}")
    # The losses taken without a gradient run the production instance.
    if out["launches"]["nee_record"] != sum(r[0][4] for r in runs if r[2]):
        raise AssertionError(f"a forward without a gradient recorded residuals: {out['launches']}")
    return out


def nee_bwd_bound(tables, live, pixels, sorted_frame) -> dict:
    """The replay mode's least time: the forward's operations (without the
    primary fold in the sorted frame, which reads the probe's), the reverse
    per live bounce, and its bytes."""
    ops = nee_ops(tables, live, pixels) + live * NEE_REVERSE_OPS
    if sorted_frame:
        ops -= pixels * sum(n * f for n, f in zip(tables.counts, PRIMARY_FOLD_OPS))
    nbytes = pixels * (NEE_BWD_BYTES_PER_PIXEL + SORTED_BYTES_PER_PIXEL * sorted_frame)
    return {**bound(nbytes + 2 * nee_table_bytes(tables), ops), "ops": ops}


def nee_resid_bound(tables, live, words, pixels, sorted_frame) -> dict:
    """The residual mode's least time: per live bounce the reverse and the
    replay's least bounce work (NEE_BOUNCE_OPS; no fold, the primary one
    included); its bytes with the `words` residual words it must read (4 B
    each) and, in the sorted frame, the lane order (4 B per pixel; the
    probe's t0 and prim0 are not read)."""
    ops = live * (NEE_REVERSE_OPS + NEE_BOUNCE_OPS)
    nbytes = pixels * (NEE_BWD_BYTES_PER_PIXEL + 4 * sorted_frame) + 4 * words
    return {**bound(nbytes + 2 * nee_table_bytes(tables), ops), "ops": ops}


def nee_record_bound(tables, live, words, pixels, sorted_frame) -> dict:
    """The recording forward's least time: the NEE kernel's operations
    (without the primary fold in the sorted frame) and bytes, with the
    `words` residual words it writes (4 B each) and, in the sorted frame,
    the lane order and the probe's (t0, prim0) it reads."""
    ops = nee_ops(tables, live, pixels)
    if sorted_frame:
        ops -= pixels * sum(n * f for n, f in zip(tables.counts, PRIMARY_FOLD_OPS))
    nbytes = pixels * (NEE_BYTES_PER_PIXEL + SORTED_BYTES_PER_PIXEL * sorted_frame) + 4 * words
    return {**bound(nbytes + nee_table_bytes(tables), ops), "ops": ops}


def residual_tile_sweep(dev) -> dict:
    """Phase 20's tile placements: the residual backward in the sorted
    frame at config 7's two shapes on TILE_SWEEP_SPHERES spheres, its
    cotangent tiles in shared and in device memory (CUDA events, median of
    n), the two results held against each other per field and per lane."""
    cam, out = Camera.create(*CAM4, 90.0, dev), {}
    for n in TILE_SWEEP_SPHERES:
        scene = SC.big_scene(dev, n)
        li = NE.scene_light_indices(scene)
        tables = NE.nee_scene_tables(scene, li)
        rec = {"tile_bytes": 4 * (tables.fold.numel() + tables.payload.numel() + tables.lights.numel()),
               "tiles_in_smem_by_default": NV.residual_tiles_in_smem(tables)}
        for w, h, spp, bounces, _ in CONFIG7:
            rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 5, dev)
            wts = torch.as_tensor(np.random.default_rng(n).normal(size=(h, w, 3)).astype(np.float32),
                                  device=dev)
            t0, prim0 = NE.launch_probe(tables, rays)
            extra = {"order": NE._presort_order(t0), "primary": (t0, prim0)}
            words = NE.launch_nee(tables, rays, rng, bounces, spp, False, False, record=True, **extra)[2]
            shape, got = f"{w}x{h}_spp{spp}_b{bounces}", {}
            for placement, settings in TILE_PLACEMENTS.items():
                with nv_settings(**settings):
                    run = lambda: NV.launch_nee_backward(  # noqa: E731
                        tables, rays, rng, wts, bounces, spp, False, False, words=words, **extra)
                    got[placement] = run()
                    rec[f"{shape}_{placement}"] = cuda_times(run, 5 if w > 512 else 20)
            label = f"tile sweep {n} spheres {shape}"
            leaf = {k: NV.table_grads_to_leaves(scene, li, *g[:3]) for k, g in got.items()}
            rec[f"{shape}_shared_vs_device"] = {
                **field_errors(label, leaf["shared"], leaf["device"], min_nonzero=4),
                "d_origin": lane_robust_error(f"{label} d_origin", got["shared"][3], got["device"][3]),
                "d_direction": lane_robust_error(f"{label} d_direction", got["shared"][4], got["device"][4])}
            del words, got
        out[f"{n}_spheres"] = rec
    return out


def physical_training_times(dev, smi) -> tuple:
    """Phase 20, on CUDA events: at config 7's two shapes, the backward
    kernel in both modes and the forward kernel's production and recording
    instances, in raster and sorted order, with each one's bound; the whole
    SGD step in both frames in the residual mode and in the sorted frame in
    the replay mode (suite rays/s: W H spp b 2 per step, suite.py:477); the
    residual mode's tile placements (`residual_tile_sweep`); the backward
    kernel in both modes, the residual one with either tile placement,
    held against its plain versions at both shapes, and the three timed at
    512x512 / 1 / 4; the two folds at 1920x1088 x 1000 spheres.  Returns the
    record and the kernels-line entries."""
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    li, kinds = NE.scene_light_indices(scene), _present_kinds(scene)
    tables, params = NE.nee_scene_tables(scene, li), G.scene_to_params(scene)
    out = {"nvidia_smi": smi, "residual_tiles_in_smem": NV.residual_tiles_in_smem(tables)}
    for w, h, spp, bounces, _ in CONFIG7:
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 1, dev)
        wts = torch.as_tensor(np.random.default_rng(w).normal(size=(h, w, 3)).astype(np.float32), device=dev)
        live = int(NE.launch_nee(tables, rays, rng, bounces, spp, False, False, telemetry=True)[2].sum())
        t0, prim0 = NE.launch_probe(tables, rays)
        order, primary = NE._presort_order(t0), (t0, prim0)
        reps = 5 if w > 512 else 20
        rec = {"live_share": live / (w * h * spp * bounces),
               "residual_bytes": 4 * w * h * spp * bounces}
        for frame, extra in (("raster", {}), ("sorted", {"order": order, "primary": primary})):
            sort = frame == "sorted"
            words = NE.launch_nee(tables, rays, rng, bounces, spp, False, False, record=True, **extra)[2]
            nwords = int(NE.written_words(words, spp, bounces).sum())
            rec[f"backward_{frame}"] = {
                **cuda_times(lambda: NV.launch_nee_backward(tables, rays, rng, wts, bounces, spp, False, False,
                                                            **extra), 5 if w > 512 else 20),
                **nee_bwd_bound(tables, live, w * h, sort)}
            rec[f"backward_residual_{frame}"] = {
                **cuda_times(lambda: NV.launch_nee_backward(
                    tables, rays, rng, wts, bounces, spp, False, False, words=words, **extra), reps),
                **nee_resid_bound(tables, live, nwords, w * h, sort), "words_read": nwords,
                "tiles_in_smem": NV.residual_tiles_in_smem(tables)}
            rec[f"forward_{frame}"] = cuda_times(
                lambda: NE.launch_nee(tables, rays, rng, bounces, spp, False, False, **extra), reps)
            rec[f"forward_record_{frame}"] = {
                **cuda_times(lambda: NE.launch_nee(tables, rays, rng, bounces, spp, False, False, record=True,
                                                   **extra), reps),
                **nee_record_bound(tables, live, nwords, w * h, sort), "words_written": nwords}
            del words
        rec["probe_and_order"] = cuda_times(lambda: NE._presort_order(NE.launch_probe(tables, rays)[0]), 10)
        target = torch.zeros((h, w, 3), device=dev)
        gate = NV.sorted_default
        try:
            for frame, budget in (("raster", NV.RESIDUAL_MAX_BYTES), ("sorted", NV.RESIDUAL_MAX_BYTES),
                                  ("sorted_replay_mode", 0)):
                NV.sorted_default = lambda _scene, frame=frame: frame.startswith("sorted")
                with nv_settings(RESIDUAL_MAX_BYTES=budget):
                    step = cuda_times(lambda: sgd_update(params, G.loss_and_grad(
                        params, scene, cam, target, rng, num_bounces=bounces, spp=spp, estimator="physical",
                        light_idx=li, kinds=kinds)[1], LR_FIELDS), 3 if w > 512 else 30)
                rec[f"sgd_step_{frame}"] = {**step, "suite_rays_per_s": w * h * spp * bounces * 2
                                            / (step["median_ms"] / 1e3)}
        finally:
            NV.sorted_default = gate
        rec["sorted_default"] = NV.sorted_default(scene)
        rec["residual_default"] = NV.records_residuals(w * h, spp, bounces, tables.num_lights)
        out[f"config7_{w}x{h}_spp{spp}_b{bounces}"] = rec

    out["residual_tile_placement"] = residual_tile_sweep(dev)

    # The backward kernel held against its plain version at the main path's
    # shapes: 512x512 / 1 / 4 whole, in both frames (the plain over row
    # tiles, timed once), and a full-width strip of 1920x1088 / 8 / 4, the
    # kernel launched on the whole image with the cotangent zero outside
    # the strip.
    def plain_tiles(rays, rng, wts, spp, rows, words=None):
        """The plain backward over tiles of `rows` rows: autograd of the
        plain trace, or with `words` (raster frame) of the word replay."""
        leaf, d_o, d_d = None, [], []
        width = rays.origin.shape[1]
        for r in range(0, rays.origin.shape[0], rows):
            tile_words = None if words is None else words[:, r * width:(r + rows) * width]
            with plain_sphere_fold():
                g, g_o, g_d = NV.backward_reference(
                    scene, Rays(origin=rays.origin[r:r + rows], direction=rays.direction[r:r + rows]),
                    rng[r:r + rows], wts[r:r + rows], 4, spp, kinds, words=tile_words)
            leaf = g if leaf is None else {f: leaf[f] + g[f] for f in g}
            d_o.append(g_o)
            d_d.append(g_d)
        return leaf, torch.cat(d_o), torch.cat(d_d)

    def held(label, got, want, rows=slice(None)):
        leaf = NV.table_grads_to_leaves(scene, li, *got[:3])
        return {"vs_backward_reference": field_errors(label, leaf, want[0], min_nonzero=4),
                "d_origin": lane_robust_error(f"{label} d_origin", got[3][rows], want[1]),
                "d_direction": lane_robust_error(f"{label} d_direction", got[4][rows], want[2]),
                "max_abs_err": max((leaf[f] - x).abs().max().item() for f, x in want[0].items()
                                   if x.numel())}

    def timed_once(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        return result, {"n": 1, "median_ms": start.elapsed_time(end)}

    w, h, spp = 512, 512, 1
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 2, dev)
    wts = torch.as_tensor(np.random.default_rng(h).normal(size=(h, w, 3)).astype(np.float32), device=dev)
    live = int(NE.launch_nee(tables, rays, rng, 4, spp, False, False, telemetry=True)[2].sum())
    t0, prim0 = NE.launch_probe(tables, rays)
    frames = {"raster": {}, "sorted": {"order": NE._presort_order(t0), "primary": (t0, prim0)}}
    words = {f: NE.launch_nee(tables, rays, rng, 4, spp, False, False, record=True, **x)[2]
             for f, x in frames.items()}
    want, plain = timed_once(lambda: plain_tiles(rays, rng, wts, spp, 32))
    want_words, plain_words = timed_once(lambda: plain_tiles(rays, rng, wts, spp, 32, words["raster"]))
    with torch.no_grad():
        plain_record = timed_once(lambda: NE.trace_physical_nee_reference(
            scene, rays, rng, 4, spp, kinds, residuals=True))[1]
    sort = NV.sorted_default(scene)
    main = frames["sorted" if sort else "raster"]
    nwords = int(NE.written_words(words["raster"], spp, 4).sum())
    rec = {"plain": plain, "sorted_frame": sort, **nee_bwd_bound(tables, live, w * h, sort),
           "residual": {"plain": plain_words, **nee_resid_bound(tables, live, nwords, w * h, sort)},
           "record": {"plain": plain_record, **nee_record_bound(tables, live, nwords, w * h, sort)}}
    for frame, extra in frames.items():
        got = NV.launch_nee_backward(tables, rays, rng, wts, 4, spp, False, False, **extra)
        rec[f"held_{frame}"] = held(f"backward {w}x{h} {frame}", got, want)
        got_r = NV.launch_nee_backward(tables, rays, rng, wts, 4, spp, False, False, words=words[frame], **extra)
        replay_rays_equal(f"backward {w}x{h} {frame}", got, got_r)
        rec[f"held_{frame}"]["rays_bit_equal_to_residual"] = True
        rec["residual"][f"held_{frame}"] = held(f"residual backward {w}x{h} {frame}", got_r, want)
        rec["residual"][f"held_{frame}_vs_word_replay"] = held(
            f"residual backward {w}x{h} {frame} vs the plain word replay", got_r, want_words)
        with nv_settings(**TILE_PLACEMENTS["device"]):
            got_g = NV.launch_nee_backward(tables, rays, rng, wts, 4, spp, False, False, words=words[frame],
                                           **extra)
        rec["residual"][f"held_{frame}_tiles_in_device_memory"] = held(
            f"residual backward {w}x{h} {frame}, tiles in device memory", got_g, want)
        rec["residual"][f"held_{frame}_tiles_in_device_memory_vs_word_replay"] = held(
            f"residual backward {w}x{h} {frame}, tiles in device memory, vs the plain word replay", got_g,
            want_words)
    rec["kernel"] = cuda_times(lambda: NV.launch_nee_backward(
        tables, rays, rng, wts, 4, spp, False, False, **main), 20)
    rec["residual"]["kernel"] = cuda_times(lambda: NV.launch_nee_backward(
        tables, rays, rng, wts, 4, spp, False, False, words=words["sorted" if sort else "raster"], **main), 20)
    rec["record"]["kernel"] = cuda_times(lambda: NE.launch_nee(
        tables, rays, rng, 4, spp, False, False, record=True, **main), 20)
    out["backward_vs_plain_512x512_spp1_b4"] = rec

    w, h, spp, strip = 1920, 1088, 8, slice(512, 576)
    rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 3, dev)
    wts = torch.zeros((h, w, 3), device=dev)
    wts[strip] = torch.as_tensor(np.random.default_rng(w).normal(size=(64, w, 3)).astype(np.float32),
                                 device=dev)
    want = plain_tiles(Rays(origin=rays.origin[strip], direction=rays.direction[strip]), rng[strip],
                       wts[strip], spp, 16)
    t0, prim0 = NE.launch_probe(tables, rays)
    rec = {}
    for frame, extra in (("raster", {}), ("sorted", {"order": NE._presort_order(t0), "primary": (t0, prim0)})):
        words = NE.launch_nee(tables, rays, rng, 4, spp, False, False, record=True, **extra)[2]
        outs = {}
        for mode, kw, suffix, settings in (("", {}, "", {}), ("residual_", {"words": words}, "", {}),
                                           ("residual_", {"words": words}, "_tiles_in_device_memory",
                                            TILE_PLACEMENTS["device"])):
            with nv_settings(**settings):
                got = outs[mode + suffix] = NV.launch_nee_backward(tables, rays, rng, wts, 4, spp, False,
                                                                   False, **extra, **kw)
            outside = torch.cat([got[3][:strip.start], got[3][strip.stop:], got[4][:strip.start],
                                 got[4][strip.stop:]])
            if outside.abs().max() != 0:
                raise AssertionError(f"strip {mode}{frame}{suffix}: a ray cotangent outside the strip is not 0")
            rec[f"{mode}held_{frame}{suffix}"] = held(f"{mode}backward {w}x{h} strip {frame}{suffix}", got,
                                                      want, strip)
        replay_rays_equal(f"backward {w}x{h} strip {frame}", outs[""], outs["residual_"])
        rec[f"held_{frame}"]["rays_bit_equal_to_residual"] = True
        del words, outs
    out[f"backward_vs_plain_{w}x{h}_spp{spp}_b4_rows{strip.start}_{strip.stop}"] = strip_rec = rec

    # The two folds at 1920x1088 x 1000 spheres and 320x180 x 20000 (phase
    # 18's shapes): the nearest fold on the camera rays (the dual-query
    # trace's primary hit), the dual fold at the first bounce; with the
    # registers, stack bytes and resident warps per SM of the instance each
    # launch takes.
    for n_spheres, w, h in ((1000, 1920, 1088), (20000, 320, 180)):
        fscene = scene if n_spheres == 1000 else SC.big_scene(dev, n_spheres)
        rays = primary_rays(cam, w, h)
        o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
        table = SF.sphere_table(fscene.spheres.pos, fscene.spheres.radius)
        n, P = o.shape[0], fscene.spheres.count
        nearest_ops = n * P * PRIMARY_FOLD_OPS[0]
        out[f"nearest_fold_{w}x{h}_{P}_spheres"] = {
            "kernel": cuda_times(lambda: SF.launch_nearest_fold(table, o, d), 20),
            "plain": cuda_times(lambda: nearest_plain(fscene, o, d), 2),
            **bound(PROBE_BYTES_PER_RAY * n + 4 * table.numel(), nearest_ops), "ops": nearest_ops,
            "resources": SF.kernel_resources(False, n, P)}
        args = dual_inputs(fscene, NE.scene_light_indices(fscene), w, h, 20, dev)
        alive = int(args[5].sum())
        dual_ops = alive * P * DUAL_FOLD_OPS[0]
        out[f"dual_fold_{w}x{h}_{P}_spheres"] = {
            "kernel": cuda_times(lambda: SF.launch_dual_fold(table, *args), 20),
            "plain": cuda_times(lambda: [SF.sphere_dual_reference(*(a[s:s + (1 << 18)] for a in args),
                                                                   fscene.spheres.pos, fscene.spheres.radius)
                                         for s in range(0, n, 1 << 18)], 2),
            "alive_share": alive / n,
            **bound(DUAL_BYTES_PER_RAY * n + 4 * table.numel(), dual_ops), "ops": dual_ops,
            "resources": SF.kernel_resources(True, n, P)}
    main = out["backward_vs_plain_512x512_spp1_b4"]
    dual = out["dual_fold_1920x1088_1000_spheres"]
    nearest = out["nearest_fold_1920x1088_1000_spheres"]
    entries = {
        "nearest_fold": {"ms": nearest["kernel"]["median_ms"], "plain_ms": nearest["plain"]["median_ms"],
                         "bound_ms": nearest["bound_ms"], "bound_by": nearest["bound_by"],
                         **{k: nearest["resources"][k] for k in RESOURCE_KEYS}},
        "nee_megakernel_vjp": {"ms": main["kernel"]["median_ms"], "plain_ms": main["plain"]["median_ms"],
                               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                               "max_abs_err": max(r["max_abs_err"] for v in out.values()
                                                  if isinstance(v, dict)
                                                  for k, r in v.items() if k.startswith("held_"))},
        "nee_megakernel_vjp_residual": {
            "ms": main["residual"]["kernel"]["median_ms"], "plain_ms": main["residual"]["plain"]["median_ms"],
            "bound_ms": main["residual"]["bound_ms"], "bound_by": main["residual"]["bound_by"],
            "max_abs_err": max([r["max_abs_err"] for k, r in main["residual"].items() if k.startswith("held_")]
                               + [r["max_abs_err"] for k, r in strip_rec.items()
                                  if k.startswith("residual_held_")])},
        "nee_megakernel_record": {
            "ms": main["record"]["kernel"]["median_ms"], "plain_ms": main["record"]["plain"]["median_ms"],
            "bound_ms": main["record"]["bound_ms"], "bound_by": main["record"]["bound_by"]},
        "dual_fold": {"ms": dual["kernel"]["median_ms"], "plain_ms": dual["plain"]["median_ms"],
                      "bound_ms": dual["bound_ms"], "bound_by": dual["bound_by"],
                      **{k: dual["resources"][k] for k in RESOURCE_KEYS}},
    }
    return out, entries


def nee_residuals(dev) -> dict:
    """Phase 25: the NEE kernel's recording instance (the gradient's
    forward) against its production instance, radiance and rng bit for bit,
    in raster and sorted order, on the NEE gradient golden cases (cornell8,
    tri, glassy: `tests/data/torch_port_nee_grad_golden.npz`'s inputs) and
    at suite config 7's two shapes; its words in the sorted frame are the
    raster frame's in lane order; its words against the plain version's
    (`trace_physical_nee_reference(residuals=True)`) on every word it
    writes, under lane parity (a lane counts as off when its rng or any of
    its words differs), on the golden cases and at 512x512 / 1 / 4."""
    with np.load(NEE_GRAD_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    inputs = []
    for case in sorted({k.split("__")[0] for k in golden}):
        arr = {k[len(case) + 2:]: v for k, v in golden.items() if k.startswith(f"{case}__")}
        scene = C.scene_from_numpy({k[len("scene__"):]: v for k, v in arr.items() if k.startswith("scene__")},
                                   dev)
        spp, bounces = arr["config"].tolist()
        rays = Rays(origin=torch.as_tensor(arr["origin"], device=dev),
                    direction=torch.as_tensor(arr["direction"], device=dev))
        inputs.append((f"golden {case} 32x16 b{bounces} spp{spp}", scene, rays,
                       C.rng_from_numpy(arr["rng_in"], dev), bounces, spp, True))
    scene7, cam7 = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    for w, h, spp, bounces, _ in CONFIG7:
        inputs.append((f"config7 {w}x{h} b{bounces} spp{spp}", scene7, primary_rays(cam7, w, h),
                       gen_seeds((h, w), 4, dev), bounces, spp, w == 512))
    cases, max_abs = [], 0.0
    for label, scene, rays, rng, bounces, spp, vs_plain in inputs:
        kinds = _present_kinds(scene)
        glossy, diel = 1 in kinds, 2 in kinds
        tables = NE.nee_scene_tables(scene)
        t0, prim0 = NE.launch_probe(tables, rays)
        order = NE._presort_order(t0)
        words, outs = {}, {}
        for frame, extra in (("raster", {}), ("sorted", {"order": order, "primary": (t0, prim0)})):
            prod = NE.launch_nee(tables, rays, rng, bounces, spp, glossy, diel, **extra)
            *outs[frame], words[frame] = NE.launch_nee(tables, rays, rng, bounces, spp, glossy, diel,
                                                       record=True, **extra)
            if not (torch.equal(prod[0], outs[frame][0]) and torch.equal(prod[1], outs[frame][1])):
                raise AssertionError(f"{label} {frame}: the recording instance changed radiance or rng")
            del prod
        rad, rng_out = outs["raster"]
        lanes = order.long()
        written = NE.written_words(words["raster"], spp, bounces)[:, lanes]
        if not torch.equal(torch.where(written, words["raster"][:, lanes], 0),
                           torch.where(written, words["sorted"], 0)):
            raise AssertionError(f"{label}: the sorted frame's words are not the raster frame's in lane order")
        rec = {"case": label, "bit_identical_to_production": True, "words_written": int(written.sum())}
        if vs_plain:
            with plain_sphere_fold(), torch.no_grad():
                want = NE.trace_physical_nee_reference(scene, rays, rng, bounces, spp, kinds, residuals=True)
            rec.update(lane_parity(label, (rad, rng_out), want[:2]))
            plain_written = NE.written_words(want[2], spp, bounces)
            off = ((words["raster"] != want[2]) & plain_written).any(0)
            off |= ~(rng_out == want[1]).all(-1).reshape(-1)
            rec["lanes_off"] = off.double().mean().item()
            if rec["lanes_off"] > LANE_MAX_DIVERGED:
                raise AssertionError(f"{label}: words or rng off on {rec['lanes_off']:.4%} of lanes")
            max_abs = max(max_abs, rec["max_abs_err"])
        cases.append(rec)
        del words
    return {"max_abs_err": max_abs, "cases": cases}


def fold_route_steps(dev) -> dict:
    """The paths that launch the two folds at the shapes users run: the
    `light_idx=None` physical SGD step on config 4's scene at config 7's two
    shapes (backend auto: the dual-query route, spp nearest folds and spp x
    bounces dual folds per gradient), and the non-split wavefront
    `Renderer.step` on the same scene at 800x600 / 15 bounces / 1 spp (a
    nearest fold per bounce).  By label: the step, the spp it runs, and the
    folds' launches in one step, counted from 0."""
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    params = G.scene_to_params(scene)
    out = {}
    for w, h, spp, bounces, _ in CONFIG7:
        rng, target = gen_seeds((h, w), 1, dev), torch.zeros((h, w, 3), device=dev)

        def step(spp=spp, rng=rng, target=target, bounces=bounces):
            grads = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=bounces, spp=spp,
                                    estimator="physical")[1]
            return sgd_update(params, grads, LR_FIELDS)

        SF.LAUNCHES.update(nearest_fold=0, dual_fold=0)
        step()
        torch.cuda.synchronize()
        out[f"sgd_light_idx_none_{w}x{h}_b{bounces}"] = {
            "step": step, "spp": spp, "launches": dict(SF.LAUNCHES)}
    renderer = Renderer(RenderConfig(algorithm="wavefront", bounces=15, device="cuda"))
    acc = renderer.init_accumulator(seed=0)
    SF.LAUNCHES.update(nearest_fold=0, dual_fold=0)
    renderer.step(scene, cam, acc, spp=1)
    out["wavefront_step_1000_spheres_800x600_b15"] = {
        "step": lambda: renderer.step(scene, cam, acc, spp=1), "spp": 1, "launches": dict(SF.LAUNCHES)}
    return out


def fold_route_times(dev, smi) -> dict:
    """Phase 26: `fold_route_steps` timed on CUDA events, with their
    launches per step, which must be the routes' (spp nearest and spp x
    bounces dual folds per gradient; a nearest fold per bounce), and the
    peak device memory of the SGD steps."""
    out = {"nvidia_smi": smi}
    for label, r in fold_route_steps(dev).items():
        bounces = 15 if label.startswith("wavefront") else 4
        want = ({"nearest_fold": bounces, "dual_fold": 0} if label.startswith("wavefront")
                else {"nearest_fold": r["spp"], "dual_fold": r["spp"] * bounces})
        if r["launches"] != want:
            raise AssertionError(f"{label}: fold launches {r['launches']}, not {want}")
        torch.cuda.reset_peak_memory_stats()
        # The 1920x1088 step takes seconds: one call, warmed by the run
        # that counted its launches.
        timed = cuda_once(r["step"]) if "1920x1088" in label else cuda_times(r["step"], 20)
        out[label] = {**timed, "spp": r["spp"],
                      "launches_per_step": r["launches"],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out


# The wavefront integrator and deterministic splitting (phases 21-24).
SPLIT_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_split_golden.npz")
SPLIT_RNG_MIN = SPLIT_CLOSE_MIN = 0.99  # tests/test_pallas_split.py:59-68
ORIGIN_POSE = ([0.0] * 3, [0.0] * 3)  # suite config 3's camera
# benchmarks/suite.py config 3: width, height, spp, bounces, queue_factor.
CONFIG3 = (512, 512, 64, 8, 2.0)
# The splitting kernel's fp32 operations per processed segment, counted
# from csrc/bounce.cuh and csrc/split.cuh as above: the fold, the bounce
# and the winner's normal as the forward's; then matte (70) or glossy (84)
# as there, and at glass, in place of a sample, the Fresnel split
# (`dielectric_split`, 58) with the child's weight 1 - F, throughput and
# quadrance (12).  The child's origin is not counted (only pushed children
# need it).
SPLIT_SAMPLE_OPS = (70, 84, 70)
# The CLI's glass image against the inline CLI's (tests/test_split.py:124-153).
SPLIT_MEAN_RTOL, SPLIT_CORR_MIN = 0.06, 0.97


def split_ops(tables, per_row) -> int:
    """fp32 operations the splitting kernel needs for the processed
    segments `per_row` (by winning row, `trace_split_reference`'s
    telemetry)."""
    geom, mat, counts = tables
    kinds = [k for k, n in enumerate(counts) for _ in range(n)]
    brdfs = [int(b) for b in mat[:, 5].tolist()]
    ops = sum(per_row) * (sum(n * f for n, f in zip(counts, FOLD_OPS)) + BOUNCE_OPS)
    for n, kind, brdf in zip(per_row, kinds, brdfs):
        ops += n * (NORMAL_OPS[kind] + SPLIT_SAMPLE_OPS[brdf])
    return ops


def split_bound(tables, per_row, pixels) -> dict:
    ops = split_ops(tables, per_row)
    return {**bound(FWD_BYTES_PER_PIXEL * pixels + table_bytes(tables), ops), "ops": ops,
            "segments": sum(per_row)}


def strict_check(label, got, want) -> dict:
    """`check`'s lane contract, and whether every rng word and radiance
    value is equal."""
    rec = check(label, got, want)
    return {**rec, "rng_all_equal": bool(torch.equal(got[1], want[1])),
            "bit_equal": bool(torch.equal(got[0], want[0]))}


def split_warp_efficiency(steps) -> dict:
    """The splitting kernel's warp efficiency from the plain version's step
    counts [spp, H, W] (`trace_split_reference(telemetry=True)`, the
    nested loop's steps), lane i on pixel i, the last warp padded with
    idle lanes: the steps over 32 times the sum, over warps, of what a warp
    pays.  A nested sample x step loop pays, sample by sample, its longest
    lane's steps; a flat loop, its longest lane's steps over all
    samples."""
    spp = steps.shape[0]
    lanes = steps.reshape(spp, -1).double()
    lanes = torch.nn.functional.pad(lanes, (0, -lanes.shape[1] % 32)).reshape(spp, -1, 32)
    work = lanes.sum().item()
    return {"nested": work / (32 * lanes.amax(2).sum().item()),
            "flat": work / (32 * lanes.sum(0).amax(1).sum().item()),
            "steps_per_sample": work / steps[0].numel() / spp}


def split_vs_plain(dev, golden) -> dict:
    """Phase 21: the splitting kernel against `trace_split_reference` on the
    card: config 3's glass scene at 512x512 / 8 b / 4 spp, the reference
    scene at 800x600 / 15 / 1, a ragged 333x97, stack depths 1, 2, 4 and 14
    at 15 bounces, the mixed-kinds scene, 1000 spheres (64 KB of tables,
    in shared memory above the 48 KB default) and 4000 (256 KB, read from
    device memory), each bit-equal in rng and radiance (on a scene without
    glass the radiance may instead equal the forward kernel's bit for bit);
    the split-free witness against the forward kernel; and the forward and
    backward kernels against their plain versions on the large scenes."""
    origin, ref, cam4 = Camera.create(*ORIGIN_POSE, 90.0, dev), world.initial_camera(dev), \
        Camera.create(*CAM4, 90.0, dev)
    glass = SC.suite_glass_scene(dev)
    mixed = C.scene_from_numpy({k[len("mixed__scene__"):]: v for k, v in golden.items()
                                if k.startswith("mixed__scene__")}, dev)
    cases = [("glass", glass, origin, 512, 512, 8, 4, 2),
             ("reference", world.main_scene(dev), ref, 800, 600, 15, 1, 2),
             ("glass_ragged", glass, origin, 333, 97, 6, 2, 2),
             *((f"glass_stack{k}", glass, origin, 160, 120, 15, 1, k) for k in (1, 2, 4, 14)),
             ("mixed", mixed, origin, 256, 128, 5, 2, 2),
             ("big1000", SC.big_scene(dev, 1000), cam4, 160, 90, 4, 1, 2),
             ("big4000", SC.big_scene(dev, 4000), cam4, 64, 32, 3, 1, 2)]
    results = []
    for label, scene, cam, w, h, b, spp, sd in cases:
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 300 + len(results), dev)
        got = SP.trace_split_fused(scene, rays, rng, b, spp, sd)
        want = SP.trace_split_reference(scene, rays, rng, b, spp, sd)
        torch.cuda.synchronize()
        rec = strict_check(f"{label} {w}x{h} b{b} spp{spp} stack{sd}", got, want)
        if not rec["bit_equal"] and not (MK.scene_tables(scene)[1][:, 5] == 2.0).any():
            fwd = MK.trace_inline_fused(scene, rays, rng, b, spp, has_dielectric=False)
            rec["bit_equal_forward_kernel"] = bool(torch.equal(got[0], fwd[0])
                                                   and torch.equal(got[1], fwd[1]))
        if not rec["rng_all_equal"] or not (rec["bit_equal"] or rec.get("bit_equal_forward_kernel")):
            raise AssertionError(f"{rec['case']}: not bit-equal: {rec}")
        results.append({**rec, "segments": live_segments(rng, got[1]), "mean": want[0].mean().item()})
    out = {"max_abs_err": max(r["max_abs_err"] for r in results), "cases": results}

    # Witness: without glass the splitting kernel is the forward kernel.
    scene = world.main_scene(dev)
    rays, rng = primary_rays(ref, 800, 600), gen_seeds((600, 800), 320, dev)
    split = SP.trace_split_fused(scene, rays, rng, 15, 1, 2)
    inline = MK.trace_inline_fused(scene, rays, rng, 15, 1, has_dielectric=False)
    torch.cuda.synchronize()
    diff = (split[0] - inline[0]).abs().max().item()
    if not torch.equal(split[1], inline[1]) or not torch.allclose(split[0], inline[0], rtol=1e-6,
                                                                   atol=1e-6):
        raise AssertionError(f"split-free witness: rng or radiance (max {diff}) off the forward kernel")
    out["split_free_vs_forward_kernel_800x600_b15"] = {"rng_all_equal": True, "max_abs_err": diff}

    # Repair of the large tables: the forward and backward kernels on 1000,
    # 2000 and 4000 spheres (tables in shared memory; the backward's
    # cotangent tables in device memory from 2000; everything in device
    # memory at 4000).
    large = []
    for n, w, h in ((1000, 160, 90), (2000, 32, 16), (4000, 64, 32)):
        scene = SC.big_scene(dev, n)
        rays, rng = primary_rays(cam4, w, h), gen_seeds((h, w), n, dev)
        got = MK.trace_inline_fused(scene, rays, rng, 4, 1)
        want = MK.trace_inline_fused_reference(scene, rays, rng, 4, 1)
        torch.cuda.synchronize()
        fwd = strict_check(f"forward big{n} {w}x{h} b4", got, want)
        tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
        bwd = function_vs_plain(f"backward big{n} 16x16 b2", tables, False,
                                primary_rays(cam4, 16, 16), gen_seeds((16, 16), n + 1, dev), 2, 2, n, 16)
        large.append({"spheres": n, "table_bytes": table_bytes(tables), "forward": fwd, "backward": bwd})
    out["large_tables"] = large
    out["forward_max_abs_err"] = max(r["forward"]["max_abs_err"] for r in large)
    out["backward_max_abs_err"] = {
        m: max(c["max_abs_err"] for r in large for c in r["backward"] if c["mode"] == m)
        for m in MODES}
    return out


def split_vs_golden(dev) -> list:
    """Phase 22: the splitting kernel on the golden cases' inputs against the
    JAX package's Pallas kernel (interpret mode), under
    tests/test_pallas_split.py's contract."""
    results = []
    with np.load(SPLIT_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    for case in sorted({k.split("__")[0] for k in golden}):
        g = {k[len(case) + 2:]: v for k, v in golden.items() if k.startswith(f"{case}__")}
        scene = C.scene_from_numpy({k[len("scene__"):]: v for k, v in g.items()
                                    if k.startswith("scene__")}, dev)
        spp, bounces, sd = g["config"].tolist()
        rays = Rays(origin=torch.as_tensor(g["origin"], device=dev),
                    direction=torch.as_tensor(g["direction"], device=dev))
        got = SP.trace_split_fused(scene, rays, C.rng_from_numpy(g["rng_in"], dev), bounces, spp, sd)
        want = (torch.as_tensor(g["radiance"], device=dev), C.rng_from_numpy(g["rng_out"], dev))
        torch.cuda.synchronize()
        rng_match, close, lit_close, err = agreement(got[1], want[1], got[0], want[0])
        if rng_match < SPLIT_RNG_MIN or close < SPLIT_CLOSE_MIN:
            raise AssertionError(f"golden {case}: rng {rng_match}, close {close}")
        results.append({"case": f"golden {case} 128x8 b{bounces} spp{spp} stack{sd}", "rng": rng_match,
                        "close": close, "lit_close": lit_close, "max_abs_err": err})
    return results


def wavefront_main_path(dev) -> dict:
    """Phase 23, counted from 0: the CLI with `--variant wavefront --split`
    at 800x600 / 15 b / 64 spp on the reference scene and on config 3's
    glass scene from a scene file (one split launch per step), the glass
    image against the inline CLI's; `--variant streams --stats` on the
    reference scene; `render_batch_wavefront` on 1000 spheres (one
    nearest-fold launch per bounce, equal to the plain chunked fold's)."""
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        glass_json = os.path.join(tmp, "glass.json")
        save_scene(glass_json, SC.suite_glass_scene("cpu"), Camera.create(*ORIGIN_POSE, 90.0, "cpu"))

        def cli(name, args, spp=64):
            png, ckpt = os.path.join(tmp, f"{name}.png"), os.path.join(tmp, f"{name}.npz")
            SP.LAUNCHES["split_kernel"] = MK.LAUNCHES = 0
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli_main(["--device", "cuda", "--width", "800", "--height", "600", "--bounces", "15",
                               "--spp", str(spp), "--seed", "0", "--quiet", "--checkpoint", ckpt,
                               "-o", png, *args])
            wall = time.perf_counter() - t0
            acc, _ = load_accumulator(ckpt, dev)
            img = acc.image.cpu().numpy()
            rec = {"rc": rc, "iterations": acc.iterations, "wall_s": wall, "mean": float(img.mean()),
                   "lit_share": float((img.sum(-1) > 1e-3).mean()),
                   "launches": {"split_kernel": SP.LAUNCHES["split_kernel"], "megakernel": MK.LAUNCHES}}
            if rc != 0 or acc.iterations != spp or not np.isfinite(img).all() or rec["lit_share"] == 0.0:
                raise AssertionError(f"{name}: CLI returned {rc} after {acc.iterations} samples, or the "
                                     "image is not finite or black")
            return rec, img, err.getvalue()

        split_args = ["--variant", "wavefront", "--split"]
        ref, _, _ = cli("split_reference", split_args)
        glass, img_split, _ = cli("split_glass", split_args + ["--scene", glass_json])
        inline, img_inline, _ = cli("inline_glass", ["--scene", glass_json])
        stats_rec, _, err = cli("streams_stats", ["--variant", "streams", "--stats"], spp=8)
    for name, rec in (("reference", ref), ("glass", glass)):
        if rec["launches"] != {"split_kernel": 64, "megakernel": 0}:
            raise AssertionError(f"split CLI on the {name} scene launched {rec['launches']}, not one "
                                 "split launch per step")
    mean_rel = float(abs(img_split.mean() - img_inline.mean()) / abs(img_inline.mean()))
    corr = float(np.corrcoef(img_split.reshape(-1), img_inline.reshape(-1))[0, 1])
    if mean_rel >= SPLIT_MEAN_RTOL or corr <= SPLIT_CORR_MIN:
        raise AssertionError(f"split glass image vs inline: mean off by {mean_rel}, correlation {corr}")
    lines = [json.loads(l) for l in err.splitlines() if l.startswith("{")]
    stats = [r for r in lines if r.get("event") == "wavefront_stats"]
    if len(stats) != 1 or sum(stats[0]["depth_histogram"]) != 800 * 600 \
            or stats[0]["occupancy"][0] != 800 * 600 or stats[0]["capacity"] != 800 * 600:
        raise AssertionError(f"streams --stats: {stats}")
    out["split_reference_800x600_b15_spp64"] = ref
    out["split_glass_800x600_b15_spp64"] = {**glass, "vs_inline_cli": {
        "inline": inline, "mean_rel_err": mean_rel, "pixel_correlation": corr}}
    out["streams_stats_800x600_b15_spp8"] = {**stats_rec, "stats": {
        k: v for k, v in stats[0].items() if k not in ("event", "t")}}

    # The wavefront's nearest hit on 1000 spheres: the nearest-sphere kernel
    # once per bounce, bit for bit the plain chunked fold's result.
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    acc = RI.make_accumulator(160, 90, 23, dev)
    SF.LAUNCHES["nearest_fold"] = 0
    got = WF.render_batch_wavefront(scene, cam, acc, 2, num_bounces=4)
    torch.cuda.synchronize()
    launches = SF.LAUNCHES["nearest_fold"]
    with plain_sphere_fold():
        want = WF.render_batch_wavefront(scene, cam, acc, 2, num_bounces=4)
    if launches != 2 * 4 or SF.LAUNCHES["nearest_fold"] != launches:
        raise AssertionError(f"wavefront on 1000 spheres: {launches} nearest-fold launches, not 8")
    if not (torch.equal(got.rng, want.rng) and torch.equal(got.color, want.color)):
        raise AssertionError("wavefront on 1000 spheres: the kernel's fold changed a pixel")
    out["wavefront_big1000_160x90_b4_spp2"] = {"nearest_fold_launches": launches, "bit_equal": True,
                                               "mean": want.color.mean().item()}
    out["launches"] = {"split_kernel": ref["launches"]["split_kernel"] + glass["launches"]["split_kernel"],
                       "nearest_fold": launches}
    return out


def split_times(dev, smi) -> tuple:
    """Phase 24, on CUDA events: the splitting kernel at suite config 3
    (rays/s as suite.py:278 counts them, W H spp b) with its processed
    segments, and at the CLI shape (800x600 / 15 / 1) on the glass and the
    reference scenes, with `Renderer.step` and the plain version there,
    each with its bound, the resources of the instance it takes and the
    warp efficiency of the nested and the flat step loop on its paths; the
    forward kernel at 800x600 / 15 / 1 on 1000 spheres through the
    large-table path.  Returns the record and the kernels-line entry."""
    out = {"nvidia_smi": smi}
    glass, origin = SC.suite_glass_scene(dev), Camera.create(*ORIGIN_POSE, 90.0, dev)
    tables = (*MK.scene_tables(glass), MK.primitive_counts(glass))
    w, h, spp, b, qf = CONFIG3
    sd = SP.clamp_stack_depth(b, round(qf))
    rays, rng = primary_rays(origin, w, h), gen_seeds((h, w), 0, dev)
    kernel = cuda_times(lambda: SP.launch_split(*tables, rays, rng, b, spp, sd), 10)
    segments = live_segments(rng, SP.launch_split(*tables, rays, rng, b, spp, sd)[1])
    t0 = time.perf_counter()
    _, _, per_row, steps = SP.trace_split_reference(glass, rays, rng, b, spp, sd, telemetry=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    nominal = w * h * spp * b
    out["config3_glass_512x512_spp64_b8"] = {
        "kernel": kernel, "rays_per_s_suite_count": nominal / (kernel["median_ms"] / 1e3),
        "kernel_segments": segments, "segment_share_of_nominal": segments / nominal,
        "segment_share_of_capacity": segments / (w * h * spp * b * (1 + sd)),
        "plain": {"n": 1, "wall_s": plain_s}, **split_bound(tables, per_row.tolist(), w * h),
        "warp_efficiency": split_warp_efficiency(steps),
        "resources": SP.kernel_resources(tables[0], tables[2], sd, spp)}

    entries = {}
    for label, scene, cam in (("glass", glass, origin),
                              ("reference", world.main_scene(dev), world.initial_camera(dev))):
        tab = (*MK.scene_tables(scene), MK.primitive_counts(scene))
        rays, rng = primary_rays(cam, 800, 600), gen_seeds((600, 800), 0, dev)
        kernel = cuda_times(lambda: SP.launch_split(*tab, rays, rng, 15, 1, 2), 50)
        plain = cuda_times(lambda: SP.trace_split_reference(scene, rays, rng, 15, 1, 2), 3)
        _, _, per_row, steps = SP.trace_split_reference(scene, rays, rng, 15, 1, 2, telemetry=True)
        renderer = Renderer(RenderConfig(algorithm="wavefront", split=True, queue_factor=2.0, device="cuda"))
        acc = renderer.init_accumulator(seed=0)
        step = cuda_times(lambda: renderer.step(scene, cam, acc, spp=1), 50)
        rec = {"kernel": kernel, "plain": plain, "renderer_step": step, "segments": live_segments(
            rng, SP.launch_split(*tab, rays, rng, 15, 1, 2)[1]),
            **split_bound(tab, per_row.tolist(), 800 * 600),
            "warp_efficiency": split_warp_efficiency(steps),
            "resources": SP.kernel_resources(tab[0], tab[2], 2, 1)}
        out[f"cli_shape_{label}_800x600_b15_spp1"] = rec
        if label == "glass":
            entries["split_kernel"] = {"ms": kernel["median_ms"], "plain_ms": plain["median_ms"],
                                       "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                                       **{k: rec["resources"][k] for k in RESOURCE_KEYS}}

    # The forward kernel on 1000 spheres (64 KB of tables, shared memory
    # opted in above 48 KB) at the serving shape.
    scene, cam = SC.big_scene(dev, 1000), Camera.create(*CAM4, 90.0, dev)
    tab = (*MK.scene_tables(scene), MK.primitive_counts(scene))
    rays, rng = primary_rays(cam, 800, 600), gen_seeds((600, 800), 0, dev)
    kernel = cuda_times(lambda: MK.launch_kernel(*tab, rays, rng, 15, 1, False, 3, False), 20)
    mix = live_bounce_mix(tab, rays, rng, 15, 1, False)
    out["forward_big1000_800x600_b15_spp1"] = {
        "kernel": kernel, "live_share": sum(mix) / (800 * 600 * 15),
        **bound(FWD_BYTES_PER_PIXEL * 800 * 600 + table_bytes(tab), bounce_ops(tab, mix, False, False))}
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
    builds = {"megakernel": MK, "megakernel_vjp": V, "nee_megakernel": NE,
              "nee_megakernel_vjp": NV, "sphere_fold": SF, "split": SP}
    for mod in builds.values():
        if os.path.exists(mod.library_path()):
            os.unlink(mod.library_path())

    def timed_build(mod):
        t = time.perf_counter()
        return os.path.relpath(mod.build(), ROOT), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = dict(zip(builds, pool.map(timed_build, builds.values())))
    build_s = time.perf_counter() - t0
    nee_res = nee_kernel_resources(dev)
    phase("build", seconds=build_s,
          libraries={k: {"library": lib, "seconds": sec} for k, (lib, sec) in done.items()},
          ptxas={"megakernel": ptxas_summary(MK), "megakernel_vjp": ptxas_summary(V),
                 "nee_megakernel": nee_ptxas_summary()},
          nee_resources=nee_res)

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
        reset_parity_launches()
        t0 = time.perf_counter()
        rc = cli_main([
            "--device", "cuda", "--width", "800", "--height", "600", "--bounces", "15",
            "--spp", "64", "--seed", "0", "--quiet", "--checkpoint", ckpt, "-o", png,
        ])
        wall = time.perf_counter() - t0
        serving = parity_launches()
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
    one = {"kernel": cuda_times(kernel(rays800, rng800, 15, 1), 200),
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
    recorded = recording_vs_plain(scenes, dev)
    grad_cases = backward_vs_plain(scenes, dev)
    main_shape = backward_main_shape(tables, rays512, rng512, mix512)
    grad_cases += main_shape["cases"]
    bwd_err = {m: max(c["max_abs_err"] for c in grad_cases if c["mode"] == m) for m in MODES}
    phase("backward_vs_plain", max_abs_err=bwd_err, recording=recorded, cases=grad_cases,
          main_shape_512x512_spp64_b8={k: v for k, v in main_shape.items() if k != "cases"})
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

    # 16-20: the physical/NEE gradient.
    nee_bwd = nee_backward_vs_plain(dev)
    phase("nee_backward_vs_plain", **nee_bwd)
    phase("nee_backward_vs_jax_golden", cases=nee_backward_vs_golden(dev))
    folds = fold_checks(dev)
    phase("folds", **folds)
    physical_training = physical_training_path(dev)
    phase("physical_training_path", **physical_training)
    grad_record, grad_entries = physical_training_times(dev, smi)
    phase("physical_training_times", **grad_record)

    # 21-24: the wavefront integrator and deterministic splitting.
    split_rec = split_vs_plain(dev, golden)
    phase("split_vs_plain", **split_rec)
    phase("split_vs_jax_golden", cases=split_vs_golden(dev))
    wavefront = wavefront_main_path(dev)
    phase("wavefront_main_path", **wavefront)
    split_record, split_entries = split_times(dev, smi)
    phase("split_times", **split_record)

    # 25: the NEE gradient's residual mode, its recording forward.
    residuals = nee_residuals(dev)
    phase("nee_residuals", **residuals)

    # 26: the paths that launch the two folds, timed.
    route_times = fold_route_times(dev, smi)
    phase("fold_route_times", **route_times)
    route_launches = {k: sum(r["launches_per_step"][k] for r in route_times.values() if isinstance(r, dict))
                      for k in ("nearest_fold", "dual_fold")}

    print(smi)
    res = times["resources"]
    main_plain_ms = main_shape["cases"][0]["plain_ms"]
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel.py:558",
        "launches": serving["megakernel"] + training["launches"]["megakernel"],
        "max_abs_err": max(max_abs_err, split_rec["forward_max_abs_err"]),
        "ms": one["kernel"]["median_ms"],
        "plain_ms": one["plain"]["median_ms"],
        **fwd_bound,
        "library_ms": None,
        **{k: res["megakernel"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "megakernel_record",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel_vjp.py:370",
        "launches": serving["megakernel_record"] + training["launches"]["megakernel_record"],
        "max_abs_err": max(c["max_abs_err"] for c in recorded),
        "ms": main_shape["record"]["median_ms"],
        "plain_ms": main_shape["record"]["plain_ms"],
        "bound_ms": main_shape["record"]["bound_ms"],
        "bound_by": main_shape["record"]["bound_by"],
        "library_ms": None,
        **{k: res["megakernel_record"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "megakernel_vjp",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel_vjp.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel_vjp.py:63",
        "launches": serving["megakernel_vjp"] + training["launches"]["megakernel_vjp"],
        "max_abs_err": max(bwd_err["pixel"], split_rec["backward_max_abs_err"]["pixel"]),
        "ms": main_shape["pixel"]["median_ms"],
        "plain_ms": main_plain_ms,
        "bound_ms": main_shape["pixel"]["bound_ms"],
        "bound_by": main_shape["pixel"]["bound_by"],
        "library_ms": None,
        **{k: res["megakernel_vjp"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "megakernel_vjp_sample",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/megakernel_vjp.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_megakernel_vjp.py:63",
        "launches": serving["megakernel_vjp_sample"] + training["launches"]["megakernel_vjp_sample"],
        "max_abs_err": max(bwd_err["sample"], split_rec["backward_max_abs_err"]["sample"]),
        "ms": main_shape["sample"]["median_ms"],
        "plain_ms": main_plain_ms,
        "bound_ms": main_shape["sample"]["bound_ms"],
        "bound_by": main_shape["sample"]["bound_by"],
        "library_ms": None,
        **{k: res["megakernel_vjp_sample"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "nee_megakernel",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee.py:431",
        "launches": physical["launches"]["nee_megakernel"],
        "max_abs_err": nee_err,
        **nee_entries["nee_megakernel"],
        "library_ms": None,
        **{k: nee_res["nee_megakernel"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "primary_probe",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee.py:395",
        "launches": physical["launches"]["primary_probe"],
        "max_abs_err": probe["max_abs_err"],
        **nee_entries["primary_probe"],
        "library_ms": None,
        **{k: nee_res["primary_probe"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "nee_megakernel_record",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee.py:431",
        "launches": physical_training["launches"]["nee_record"],
        "max_abs_err": residuals["max_abs_err"],
        **grad_entries["nee_megakernel_record"],
        "library_ms": None,
        **{k: nee_res["nee_megakernel_record"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "nee_megakernel_vjp",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel_vjp.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee_vjp.py:445",
        "launches": physical_training["launches"]["nee_megakernel_vjp"],
        **grad_entries["nee_megakernel_vjp"],
        "max_abs_err": max(nee_bwd["max_abs_err"], grad_entries["nee_megakernel_vjp"]["max_abs_err"]),
        "library_ms": None,
        **{k: nee_res["nee_megakernel_vjp"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "nee_megakernel_vjp_residual",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/nee_megakernel_vjp.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_nee_vjp.py:445",
        "launches": physical_training["launches"]["nee_megakernel_vjp_residual"],
        **grad_entries["nee_megakernel_vjp_residual"],
        "max_abs_err": max(nee_bwd["residual_max_abs_err"],
                           grad_entries["nee_megakernel_vjp_residual"]["max_abs_err"]),
        "library_ms": None,
        **{k: nee_res["nee_megakernel_vjp_residual"][k] for k in RESOURCE_KEYS},
    }, {
        "name": "dual_fold",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/sphere_fold.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_intersect.py:186",
        "launches": folds["launches"]["dual_fold"] + route_launches["dual_fold"],
        "max_abs_err": folds["max_abs_err"],
        **grad_entries["dual_fold"],
        "library_ms": None,
    }, {
        "name": "nearest_fold",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/sphere_fold.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_intersect.py:35",
        "launches": (folds["launches"]["nearest_fold"] + wavefront["launches"]["nearest_fold"]
                     + route_launches["nearest_fold"]),
        "max_abs_err": folds["nearest_max_abs_err"],
        **grad_entries["nearest_fold"],
        "library_ms": None,
    }, {
        "name": "split_kernel",
        "route": "cuda",
        "source": "haskell_path_tracer_torch/csrc/split.cu",
        "replaces": "haskell_path_tracer_tpu/ops/pallas_split.py:81",
        "launches": wavefront["launches"]["split_kernel"],
        "max_abs_err": split_rec["max_abs_err"],
        **split_entries["split_kernel"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
