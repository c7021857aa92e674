"""Progressive frames: one user waits for each frame and reads its image.

A unit is `Renderer.render(scene, camera, spp, seed)` with a seed of its
own, then `Renderer.image(acc)` to the host.  The check takes, once the
window has closed, a sample drawn from the run's seed of pixels whose
primary ray hits, each from a frame of the window drawn from the seed,
and holds the program's colour, rng and iterations there against the
plain reference's frame (`reference/progressive.py:frame_lanes`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import core as C
from ..reference import progressive as R
from . import common

# Per-channel tolerance of a colour summed over n samples: the per-sample
# lane contract of the NEE and parity kernels against their plain loops
# (1e-4 + 1e-3 |ref|), summed.
ATOL_PER_SAMPLE, RTOL = 1e-4, 1e-3


def setup(ctx: common.Context) -> None:
    from haskell_path_tracer_torch.render.renderer import Renderer
    from haskell_path_tracer_torch.utils.config import RenderConfig

    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    st["scene"] = common.program_scene(ctx.arrays, ctx.device)
    st["camera"] = common.program_camera(cfg["camera"], ctx.device)
    st["renderer"] = Renderer(RenderConfig(
        width=cfg["width"], height=cfg["height"], algorithm=cfg["algorithm"],
        bounces=cfg["bounces"], reseed_interval=tr["reseed_interval"], device=str(ctx.device)))
    pixels = cfg["width"] * cfg["height"]
    g = np.random.default_rng(common.derive(ctx.seed, "gather"))
    gather = np.sort(g.choice(pixels, min(tr["candidate_pixels"], pixels), replace=False))
    st["gather_np"] = gather
    st["gather"] = torch.as_tensor(gather, device=ctx.device)
    st["kept"] = []
    # Warm-up: one whole frame, so every kernel this traffic launches is
    # built and loaded before the window.
    frame(ctx, common.derive(ctx.seed, "warm-up"))
    st["kept"].clear()


def frame(ctx: common.Context, seed: int) -> bool:
    """One frame; keeps the sampled pixels' state; True if its image is
    finite."""
    st = ctx.state
    with ctx.span("ptbench.render"):
        acc = st["renderer"].render(st["scene"], st["camera"], ctx.traffic["spp"], seed)
    with ctx.span("ptbench.image"):
        image = st["renderer"].image(acc)
    g = st["gather"]
    st["kept"].append((seed, acc.color.reshape(-1, 3)[g], acc.rng.reshape(-1, 4)[g],
                       acc.iterations))
    return bool(np.isfinite(image).all())


def unit(ctx: common.Context, i: int) -> dict:
    return {"failed": not frame(ctx, common.derive(ctx.seed, "frame", i))}


def end_to_end(ctx: common.Context, units: list, window_s: float) -> dict:
    cfg = ctx.config
    paths = len(units) * cfg["width"] * cfg["height"] * ctx.traffic["spp"]
    return {"render_paths_per_s": (paths / window_s, "paths/s")}


def release(ctx: common.Context) -> None:
    for key in ("renderer", "scene", "camera"):
        ctx.state.pop(key, None)


def lanes(ctx: common.Context) -> tuple:
    """The checked lanes, drawn from the seed once the window has closed:
    (indices into the gathered pixels, the frame of each), among the
    gathered pixels whose primary ray hits."""
    st = ctx.state
    if "lanes" not in st:
        scene = C.scene_from_arrays(ctx.arrays, ctx.device)
        o_all, d_all = common.reference_rays(ctx)
        st["rays"] = (o_all[st["gather"]], d_all[st["gather"]])
        t0, _ = C.nearest(*st["rays"], scene, 0.0)
        candidates = np.nonzero((t0 < C.INFINITE).cpu().numpy())[0]
        g = np.random.default_rng(common.derive(ctx.seed, "check"))
        picked = np.sort(g.choice(candidates, min(ctx.traffic["checked_pixels"], len(candidates)),
                                  replace=False))
        st["lanes"] = (picked, g.integers(0, len(st["kept"]), len(picked)))
    return st["lanes"]


def produced(ctx: common.Context) -> tuple:
    """The program's (colour, rng, iterations of every frame) at the lanes."""
    kept = ctx.state["kept"]
    picked, frames = lanes(ctx)
    colour = torch.stack([k[1] for k in kept])[frames, picked]
    rng = torch.stack([k[2] for k in kept])[frames, picked]
    return colour, rng, [k[3] for k in kept]


def expected(ctx: common.Context, dtype=torch.float32) -> tuple:
    """The reference's (colour, rng, iterations) at the lanes; a `dtype`
    below float32 gives the control."""
    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    picked, frames = lanes(ctx)
    at = torch.as_tensor(picked, device=ctx.device)
    o, d = st["rays"]
    colour, rng, iterations = R.frame_lanes(
        cfg["estimator"], C.scene_from_arrays(ctx.arrays, ctx.device), o[at], d[at],
        [st["kept"][f][0] for f in frames], st["gather_np"][picked],
        (cfg["height"], cfg["width"]), tr["spp"], cfg["bounces"], tr["reseed_interval"], dtype)
    return colour.float(), rng, [iterations] * len(st["kept"])


def compare(got: tuple, want: tuple) -> list:
    """[(name, value)]: the share of lanes whose rng differs, the share whose
    rng agrees and whose colour does not, and the frames whose iterations
    differ."""
    colour, rng, iterations = got
    ref_colour, ref_rng, ref_iterations = want
    match = (rng == ref_rng).all(dim=-1)
    tol = ATOL_PER_SAMPLE * ref_iterations[0] + RTOL * ref_colour.abs()
    off = ((colour - ref_colour).abs() > tol).any(dim=-1) | ~torch.isfinite(colour).all(-1)
    n = max(len(match), 1)
    return [("rng_diverged", 1.0 - match.double().sum().item() / n),
            ("colour_off", (off & match).double().sum().item() / n),
            ("frames_short", float(sum(a != b for a, b in zip(iterations, ref_iterations))))]


def check(ctx: common.Context) -> list:
    return compare(produced(ctx), expected(ctx))


def control(ctx: common.Context, dtype) -> list:
    """The numbers of the reference in `dtype` put in the program's place."""
    return compare(expected(ctx, dtype), expected(ctx))
