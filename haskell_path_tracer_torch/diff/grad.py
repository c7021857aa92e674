"""Differentiable rendering: pixel gradients with respect to scene
parameters, for inverse rendering.

Counterpart of the parity half of ``haskell_path_tracer_tpu/diff/grad.py``,
with the same semantics:

  * decisions are detached — hit masks, the nearest primitive, the BRDF
    branch and the rng draws carry no gradient, so shading is
    differentiated along fixed paths;
  * gradients flow through intersection distances, normals, BRDF weights,
    throughput products and emission: every continuous scene leaf
    (`SceneParams`), with the plane normal renormalised in
    `params_to_scene`;
  * the rng state is a constant of each gradient evaluation, so the loss
    is a deterministic function of the parameters.

`render_radiance` differentiates one of two estimators.  The inline parity
trace (``estimator="parity"``) runs through one of two backends:
``"cuda"``, the forward and backward megakernels (`ops/megakernel_vjp.py`,
one launch of each per gradient), or ``"torch"``, the plain integrator with
each bounce checkpointed.  The physical/NEE estimator
(``estimator="physical"``, the JAX package's `diff/grad.py:111-158`) runs
through `_physical_radiance`'s routes: the NEE megakernel and its backward
(`ops/nee_vjp.py`), the dual-query loop (`ops/sphere_fold.py`), or the
plain loop.  ``"auto"`` takes ``"cuda"`` exactly when the tensors live on a
CUDA device and, for the physical estimator, a CUDA route takes the scene.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.camera import primary_rays
from ..models.objects import Boxes, Camera, Materials, Planes, Scene, Spheres, Triangles
from ..ops.megakernel_vjp import trace_inline_fused_diff
from ..ops.nee_vjp import trace_physical_nee_diff
from ..render.integrator import trace_inline
from ..render.nee import trace_physical
from ..utils.metrics import span

BACKENDS = ("auto", "torch", "cuda")


def _physical_route(scene: Scene, light_idx) -> str | None:
    """The CUDA route that takes `scene`: "nee" (the NEE megakernel and its
    backward: an emitter tuple, no boxes, a sphere), "fused" (the
    dual-query loop: spheres and planes only), or None."""
    if light_idx is not None and not scene.boxes.count and scene.spheres.count:
        return "nee"
    if not scene.boxes.count and not scene.triangles.count and scene.spheres.count:
        return "fused"
    return None


def _physical_radiance(scene: Scene, rays, rng_state, num_bounces, spp, backend, light_idx,
                       kinds):
    """The physical estimator's routes (`render_radiance`)."""
    route = _physical_route(scene, light_idx)
    if backend == "auto":
        backend = "cuda" if rng_state.is_cuda and route is not None else "torch"
    if backend == "cuda":
        if route is None:
            raise ValueError(
                "backend='cuda' takes the physical gradient of scenes without boxes (with "
                "light_idx) or of spheres and planes; use backend='torch' for this scene")
        if not rng_state.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors")
        if route == "nee":
            rad_sum, _ = trace_physical_nee_diff(
                scene, rays, rng_state, num_bounces=num_bounces, spp=spp, light_idx=light_idx,
                kinds=kinds)
            return rad_sum / spp
    radiances = []
    rng = rng_state
    for _ in range(spp):
        radiance, rng = trace_physical(scene, rays, rng, num_bounces, nee=True,
                                       fused=backend == "cuda", kinds=kinds)
        radiances.append(radiance)
    return torch.stack(radiances).mean(dim=0)


def render_radiance(
    scene: Scene,
    camera: Camera,
    rng_state: torch.Tensor,
    width: int,
    height: int,
    num_bounces: int = 4,
    spp: int = 1,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    estimator: str = "parity",
    light_idx: tuple | None = None,
    kinds=None,
    row_offset: int = 0,
    full_height: int | None = None,
) -> torch.Tensor:
    """Differentiable expected-radiance image [H, W, 3]: the mean of `spp`
    samples, each advancing the rng.  `row_offset` / `full_height` render
    the row block [row_offset, row_offset + height) of an image of
    `full_height` rows (`primary_rays`; the row-sharded gradient,
    `parallel/shard.py`), on every route.  `has_dielectric` (None: read the
    scene's kinds) elides the parity CUDA kernels' glass block; the torch
    backend always runs it.

    `estimator="physical"` differentiates the corrected-BRDF + NEE
    estimator (`render/nee.py`).  backend="torch" averages `spp` plain
    traces (`trace_physical(fused=False)`) under autograd.  backend="cuda"
    takes, when `light_idx` (the emitter tuple,
    `ops/nee.py:scene_light_indices`) is given on a scene without boxes and
    with a sphere, the fast route: the NEE megakernel forward and its
    backward kernel, one launch each per gradient (`trace_physical_nee_diff`);
    otherwise, on a scene of spheres and planes, `spp` dual-query traces
    (`trace_physical(fused=True)`) under autograd; any other scene raises.
    `kinds` elides absent BRDF branches (read from the scene when None).

    Frozen emitters: `light_idx` fixes the set of emitters for the whole
    optimisation — the kernel samples exactly those, while the plain
    routes read the emitters from `illuminance > 0` at every call.  If an
    optimisation drives an emitter's illuminance across zero, the routes
    part: the kernel keeps sampling an emitter that has gone dark (which
    adds nothing) and never samples one that has lit up (its light still
    arrives by BSDF pickup off specular chains, but matte NEE towards it is
    lost).  Recompute `scene_light_indices` whenever the emitter set may
    have changed."""
    if estimator not in ("parity", "physical"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, expected one of {BACKENDS}")
    rays = primary_rays(camera, width, height, row_offset, full_height)
    if estimator == "physical":
        return _physical_radiance(scene, rays, rng_state, num_bounces, spp, backend, light_idx,
                                  kinds)
    if backend == "auto":
        backend = "cuda" if rng_state.is_cuda else "torch"

    if backend == "cuda":
        if not rng_state.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors")
        rad_sum, _ = trace_inline_fused_diff(
            scene, rays, rng_state, num_bounces=num_bounces, spp=spp,
            has_dielectric=has_dielectric,
        )
        return rad_sum / spp

    radiances = []
    rng = rng_state
    for _ in range(spp):
        radiance, rng = trace_inline(
            scene, rays, rng, num_bounces, differentiable=True
        )
        radiances.append(radiance)
    return torch.stack(radiances).mean(dim=0)


class SceneParams(NamedTuple):
    """Every continuous (differentiable) leaf of a Scene, in the JAX
    package's order.  Only the integer BRDF kind tags stay in the
    template.  The plane normal is stored raw and renormalised inside
    `params_to_scene`, so an SGD update cannot make it non-unit."""

    sphere_pos: torch.Tensor
    sphere_radius: torch.Tensor
    sphere_color: torch.Tensor
    sphere_illum: torch.Tensor
    sphere_param: torch.Tensor
    plane_pos: torch.Tensor
    plane_normal: torch.Tensor
    plane_color: torch.Tensor
    plane_illum: torch.Tensor
    plane_param: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    box_color: torch.Tensor
    box_illum: torch.Tensor
    box_param: torch.Tensor
    tri_v0: torch.Tensor
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_color: torch.Tensor
    tri_illum: torch.Tensor
    tri_param: torch.Tensor


def scene_to_params(scene: Scene) -> SceneParams:
    sp, pl, bx, tr = scene.spheres, scene.planes, scene.boxes, scene.triangles
    return SceneParams(
        sphere_pos=sp.pos,
        sphere_radius=sp.radius,
        sphere_color=sp.material.color,
        sphere_illum=sp.material.illuminance,
        sphere_param=sp.material.brdf_param,
        plane_pos=pl.pos,
        plane_normal=pl.normal,
        plane_color=pl.material.color,
        plane_illum=pl.material.illuminance,
        plane_param=pl.material.brdf_param,
        box_lo=bx.lo,
        box_hi=bx.hi,
        box_color=bx.material.color,
        box_illum=bx.material.illuminance,
        box_param=bx.material.brdf_param,
        tri_v0=tr.v0,
        tri_v1=tr.v1,
        tri_v2=tr.v2,
        tri_color=tr.material.color,
        tri_illum=tr.material.illuminance,
        tri_param=tr.material.brdf_param,
    )


def params_to_scene(params: SceneParams, template: Scene) -> Scene:
    """Rebuild a Scene from the params and the template's BRDF kind tags;
    the plane normal is renormalised."""

    def materials(color, illum, param, part):
        return Materials(
            color=color, illuminance=illum,
            brdf_kind=part.material.brdf_kind, brdf_param=param,
        )

    p = params
    norm = torch.sqrt(
        torch.clamp((p.plane_normal**2).sum(dim=-1, keepdim=True), min=1e-12)
    )
    return Scene(
        spheres=Spheres(
            pos=p.sphere_pos, radius=p.sphere_radius,
            material=materials(p.sphere_color, p.sphere_illum, p.sphere_param,
                               template.spheres),
        ),
        planes=Planes(
            pos=p.plane_pos, normal=p.plane_normal / norm,
            material=materials(p.plane_color, p.plane_illum, p.plane_param,
                               template.planes),
        ),
        boxes=Boxes(
            lo=p.box_lo, hi=p.box_hi,
            material=materials(p.box_color, p.box_illum, p.box_param,
                               template.boxes),
        ),
        triangles=Triangles(
            v0=p.tri_v0, v1=p.tri_v1, v2=p.tri_v2,
            material=materials(p.tri_color, p.tri_illum, p.tri_param,
                               template.triangles),
        ),
    )


def image_loss(
    params: SceneParams,
    template: Scene,
    camera: Camera,
    target: torch.Tensor,
    rng_state: torch.Tensor,
    num_bounces: int = 4,
    spp: int = 1,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    estimator: str = "parity",
    light_idx: tuple | None = None,
    kinds=None,
) -> torch.Tensor:
    """Mean squared error between the rendered radiance image and a target
    [H, W, 3]: the inverse-rendering objective (arguments as in
    `render_radiance`)."""
    scene = params_to_scene(params, template)
    h, w = target.shape[:2]
    img = render_radiance(
        scene, camera, rng_state, w, h, num_bounces, spp, backend,
        has_dielectric, estimator, light_idx, kinds,
    )
    return ((img - target) ** 2).mean()


def loss_and_grad(params, template, camera, target, rng_state, **kw):
    """(loss, SceneParams of gradients) of `image_loss`; a leaf the loss
    does not reach gets a zero gradient.  The loss runs in span
    "hpt.grad.forward" (the scene's rebuild, the rays, the tables, the
    forward launches, the MSE), the gradient in span "hpt.grad.backward"
    (autograd with its backward launches)."""
    leaves = [t.detach().requires_grad_() for t in params]
    with torch.enable_grad():
        with span("hpt.grad.forward"):
            loss = image_loss(
                SceneParams(*leaves), template, camera, target, rng_state, **kw
            )
        with span("hpt.grad.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), SceneParams(
        *(torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves))
    )
