"""SGD steps of inverse rendering: a training loop waits for each loss.

A unit is `loss_and_grad(params, scene, camera, target, rng, ...)`, then
p - rate g on every field (one rate per field), then the loss read to the
host.  The steps run in episodes of `rng_pool` steps, each from the first
state: step i's rng is grid i mod `rng_pool` of a pool drawn on the
device from the seed, and a step whose i is a multiple of it starts again
from the first state.  Over hundreds of steps the states wander (a lane's
decisions switch at knife edges, the kernels' sums are not bit for bit
the same from run to run), and the work of a step with them: on an H100
one run of a seed read steps 28% faster than another run of the same seed.  In
episodes every run does the same work.  The target is the program's
render of the scene with its materials perturbed as the traffic says.
Set-up builds the training state once, runs its first `warm_steps` steps
through `unit` (the warm-up, unchecked) and hands that same state to the
window.  The step sizes, one per field, are set from the first gradient
(`reference/progressive.py:sgd_rates`).

The check reads `checked_steps` consecutive steps of the window from the
start of an episode drawn from the seed among its first `checked_within`
steps: the state before each (a copy, once per run) and each loss.  At the
program's state before each checked step the plain reference computes the
loss and the gradient on the same target perturbation and rng grid (its
own target from the same arrays), sets its own rates from the first of
them and predicts the change over the checked steps.  It compares each
step's loss, the first checked gradient as the update applied it
((p_k - p_k+1) / rate, leaf by leaf) and the change over the checked
steps, by the worst leaf.  Two independent trajectories part after one
step however close their gradients are, so the reference follows the
program's states; each checked update is what the comparison checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import core as C
from ..reference import progressive as R
from . import common


def perturbed(ctx: common.Context) -> dict:
    """The target scene's arrays: each field of the traffic's "target"
    list scaled, or jittered by a factor in [1 - j, 1 + j] drawn from the
    seed and clipped to [0, 1]."""
    out = dict(ctx.arrays)
    g = np.random.default_rng(common.derive(ctx.seed, "target"))
    for item in ctx.traffic["target"]:
        a = np.asarray(out[item["field"]], np.float32)
        if "scale" in item:
            a = a * np.float32(item["scale"])
        else:
            j = item["jitter"]
            a = np.clip(a * g.uniform(1 - j, 1 + j, a.shape), 0.0, 1.0).astype(np.float32)
        out[item["field"]] = a
    return out


def kwargs(ctx: common.Context, scene) -> dict:
    """`loss_and_grad`'s keywords: the configuration's estimator, and its
    emitters' indices where it keeps them (`light_idx`)."""
    kw = dict(num_bounces=ctx.config["bounces"], spp=ctx.traffic["spp"],
              estimator=ctx.config["estimator"])
    if ctx.config.get("light_idx"):
        from haskell_path_tracer_torch import scene_light_indices

        kw["light_idx"] = scene_light_indices(scene)
    return kw


def setup(ctx: common.Context) -> None:
    import haskell_path_tracer_torch as hpt

    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    scene = common.program_scene(ctx.arrays, ctx.device)
    camera = common.program_camera(cfg["camera"], ctx.device)
    kw = kwargs(ctx, scene)
    g = np.random.default_rng(common.derive(ctx.seed, "checked"))
    pool = tr["rng_pool"]
    first = pool * int(g.integers(1, tr["checked_within"] // pool + 1))
    st.update(scene=scene, camera=camera, kw=kw, rates=None, losses=[], snapshots=[],
              checked=range(first, first + tr["checked_steps"]), next=0)
    st["pool"] = common.rng_states(ctx, tr["rng_pool"], "pool")
    st["target_rng"] = common.rng_states(ctx, 1, "target rng")[0]
    target_scene = common.program_scene(perturbed(ctx), ctx.device)
    with torch.no_grad():
        st["target"] = hpt.render_radiance(
            target_scene, camera, st["target_rng"], cfg["width"], cfg["height"],
            cfg["bounces"], tr["spp"], estimator=kw["estimator"], light_idx=kw.get("light_idx"))
    st["params"] = st["start"] = hpt.scene_to_params(scene)
    for i in range(tr["warm_steps"]):
        step(ctx, i)


def step(ctx: common.Context, i: int) -> float:
    import haskell_path_tracer_torch as hpt

    st = ctx.state
    if i and i % len(st["pool"]) == 0:
        st["params"] = st["start"]
    checked = i in st["checked"]
    if checked and not st["snapshots"]:
        st["snapshots"].append([p.clone() for p in st["params"]])
    rng = st["pool"][i % len(st["pool"])]
    with ctx.span("ptbench.step"):
        loss, grads = hpt.loss_and_grad(st["params"], st["scene"], st["camera"], st["target"],
                                        rng, **st["kw"])
        if st["rates"] is None:
            rates = R.sgd_rates(dict(zip(grads._fields, st["params"])), grads._asdict(),
                                ctx.traffic["lr_fraction"])
            st["rates"] = [rates[f] for f in grads._fields]
        st["params"] = type(grads)(*(p - r * g for p, r, g in
                                     zip(st["params"], st["rates"], grads)))
    with ctx.span("ptbench.loss_read"):
        value = loss.item()
    if checked:
        st["snapshots"].append([p.clone() for p in st["params"]])
        st["losses"].append(value)
    st["next"] = i + 1
    return value


def unit(ctx: common.Context, i: int) -> dict:
    value = step(ctx, ctx.traffic["warm_steps"] + i)
    return {"failed": not np.isfinite(value)}


def finish(ctx: common.Context) -> None:
    """The checked steps that the window did not reach."""
    st = ctx.state
    while st["next"] < st["checked"].stop:
        step(ctx, st["next"])


def end_to_end(ctx: common.Context, units: list, window_s: float) -> dict:
    lat = sorted(u["latency_s"] for u in units)
    p95 = float(np.percentile(np.asarray(lat), 95))
    return {"sgd_step_ms": (window_s / len(units) * 1e3, "ms"),
            "sgd_step_ms_p95": (p95 * 1e3, "ms")}


def release(ctx: common.Context) -> None:
    st = ctx.state
    st["target_rng"] = st["target_rng"].clone()
    st["checked_rng"] = st["pool"][[i % len(st["pool"]) for i in st["checked"]]].clone()
    for key in ("scene", "camera", "params", "start", "target", "pool"):
        st.pop(key, None)


def leaf_gaps(got: dict, want: dict, leaves) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖."""
    norms = {k: want[k].double().norm().item() for k in leaves}
    median = float(np.median(list(norms.values())))
    return worst(abs(got[k].double().norm().item() - norms[k]) / max(norms[k], median, 1e-30)
                 for k in leaves)


def states(ctx: common.Context) -> list:
    """The program's states before and after each checked step, as
    leaves."""
    fields = _param_fields()
    return [{f: v for f, v in zip(fields, snap) if f in C.FIELDS}
            for snap in ctx.state["snapshots"]]


def produced(ctx: common.Context) -> tuple:
    """The program's (losses of the checked steps, the first checked
    gradient as the update applied it, the change over the checked
    steps), by field."""
    st = ctx.state
    p = states(ctx)
    rates = dict(zip(_param_fields(), st["rates"]))
    grad = {f: (p[0][f] - p[1][f]) / rates[f] if rates[f] else torch.zeros_like(p[0][f])
            for f in C.FIELDS}
    return list(st["losses"]), grad, {f: p[-1][f] - p[0][f] for f in C.FIELDS}


class Reference:
    """The plain reference of the checked steps, in `dtype`: its own target
    (the same arrays, perturbation and rng grid as the program's), and the
    loss and gradient at any state."""

    def __init__(self, ctx: common.Context, dtype=torch.float32):
        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.dtype = ctx, dtype
        self.rays = common.reference_rays(ctx)
        self.kinds = {k: torch.as_tensor(ctx.arrays[k], device=ctx.device) for k in C.KINDS}
        # The emitters stay those of the first state, as the program's
        # `light_idx` keeps them, though an update moves every sphere's
        # illuminance off 0.
        self.kinds["lights"] = torch.as_tensor(np.nonzero(ctx.arrays["sphere_illum"] > 0)[0],
                                               device=ctx.device)
        scene = C.scene_of_params(leaves_of(ctx, perturbed(ctx)), self.kinds)
        target = R.render_sum(cfg["estimator"], scene, *self.rays,
                              ctx.state["target_rng"].reshape(-1, 4), tr["spp"], cfg["bounces"],
                              dtype=dtype) / tr["spp"]
        self.target = target.float().reshape(cfg["height"], cfg["width"], 3)

    def step(self, leaves: dict, j: int) -> tuple:
        """(loss, gradient by leaf) at `leaves` on the rng grid of checked
        step j."""
        ctx = self.ctx
        loss, g = R.loss_and_grad(ctx.config["estimator"], leaves, self.kinds, *self.rays,
                                  ctx.state["checked_rng"][j], self.target, ctx.traffic["spp"],
                                  ctx.config["bounces"], self.dtype)
        return loss.item(), {k: v.float() for k, v in g.items()}


def expected(ctx: common.Context, path: list | None = None) -> tuple:
    """The reference's (losses, first gradient, change) along `path` (the
    program's states when None): at each state but the last its loss and
    gradient, the change its own rates predict."""
    path = states(ctx) if path is None else path
    ref = Reference(ctx)
    losses, grads = zip(*(ref.step(leaves, j) for j, leaves in enumerate(path[:-1])))
    rates = R.sgd_rates(path[0], grads[0], ctx.traffic["lr_fraction"])
    change = {k: -sum(rates[k] * g[k] for g in grads) for k in C.FIELDS}
    return list(losses), grads[0], change


def own_steps(ctx: common.Context, dtype) -> tuple:
    """The reference in `dtype` put in the program's place over the checked
    steps, from the program's state before them: its states, and its
    (losses, first gradient, change)."""
    ref = Reference(ctx, dtype)
    path, losses, rates, grad0 = [states(ctx)[0]], [], None, None
    for j in range(ctx.traffic["checked_steps"]):
        loss, grads = ref.step(path[-1], j)
        if rates is None:
            rates, grad0 = R.sgd_rates(path[0], grads, ctx.traffic["lr_fraction"]), grads
        losses.append(loss)
        path.append(R.sgd(path[-1], grads, rates))
    return path, (losses, grad0, {k: path[-1][k] - path[0][k] for k in C.FIELDS})


def leaves_of(ctx: common.Context, arrays: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(arrays[k], np.float32), device=ctx.device)
            for k in C.FIELDS}


def compare(got: tuple, want: tuple) -> list:
    """[(name, value)]: the worst relative gap of a checked step's loss, and
    the worst leaf's gap of the first gradient's norm and of the change's
    norm; the change leaves out the leaves whose reference gradient is
    under a thousandth of the median leaf's."""
    losses, grad, change = got
    ref_losses, ref_grad, ref_change = want
    fields = [f for f in C.FIELDS if ref_grad[f].numel()]
    norms = {f: ref_grad[f].double().norm().item() for f in fields}
    median = float(np.median(list(norms.values())))
    moving = [f for f in fields if norms[f] >= 1e-3 * median]
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses)]
    if len(losses) != len(ref_losses):
        gaps.append(float("inf"))
    return [("loss_gap", worst(gaps)),
            ("grad_gap", leaf_gaps(grad, ref_grad, fields)),
            ("change_gap", leaf_gaps(change, ref_change, moving))]


def worst(values) -> float:
    """The largest value; infinite where one is not a number."""
    values = list(values)
    return float("inf") if any(not np.isfinite(v) for v in values) else max(values)


def check(ctx: common.Context) -> list:
    got, want = produced(ctx), expected(ctx)
    ctx.state["compared"] = (got, want)
    return compare(got, want)


def details(ctx: common.Context) -> dict:
    """Per leaf, the norms of the last check's first gradient and change,
    the program's beside the reference's, and the losses (for readings)."""
    (losses, grad, change), (ref_losses, ref_grad, ref_change) = ctx.state["compared"]
    def norms(a, b):
        return {k: [a[k].double().norm().item(), b[k].double().norm().item()] for k in C.FIELDS}
    return {"losses": [losses, ref_losses], "grad": norms(grad, ref_grad),
            "change": norms(change, ref_change)}


def control(ctx: common.Context, dtype) -> list:
    """The numbers of the reference in `dtype` put in the program's place."""
    path, got = own_steps(ctx, dtype)
    return compare(got, expected(ctx, path))


def _param_fields():
    from haskell_path_tracer_torch.diff.grad import SceneParams

    return SceneParams._fields
