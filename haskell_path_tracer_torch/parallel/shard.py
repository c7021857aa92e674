"""Rendering and the inverse-rendering step on each rank's row block.

Counterpart of ``haskell_path_tracer_tpu/parallel/shard.py``.  Each rank
holds its tile's rows of the accumulator (`place_accumulator`), renders
them with `row_offset = tile * block_h` against the full image's height,
and runs the same kernels the unsharded `Renderer` runs on its device:

  * forward rendering (`render_sharded`) needs no collective: the scene is
    replicated, so shadow rays and split children stay on the rank;
  * the sample axis renders the same block with independent rng streams,
    averaged over the tile row (`render_radiance_sharded`);
  * the gradient step differentiates each block's share of the loss and
    reduces the gradients over the whole mesh (`train_step_sharded`).

The JAX package's arrays are global, so its results are whole images;
here each rank returns its block, and `gather_accumulator` assembles the
image where it is wanted.  Collectives (`mesh.py`) never run on a group of
one rank.
"""

from __future__ import annotations

import torch

from ..diff import grad as G
from ..models.objects import Accumulator, Camera, Scene
from ..ops import nee as nee_ops
from ..render import integrator, wavefront
from ..render import nee as render_nee
from . import mesh as M

ALGORITHMS = ("inline", "physical", "wavefront", "split")


def place_accumulator(acc: Accumulator, mesh: M.Mesh) -> Accumulator:
    """This rank's rows of a whole-image accumulator (the same on every
    rank), on the mesh's device."""
    height = acc.color.shape[0]
    if height % mesh.n_tile:
        raise ValueError(f"{height} rows do not split into {mesh.n_tile} tiles")
    block = height // mesh.n_tile
    rows = slice(mesh.tile * block, (mesh.tile + 1) * block)
    return Accumulator(color=acc.color[rows].to(mesh.device).contiguous(),
                       rng=acc.rng[rows].to(mesh.device).contiguous(),
                       iterations=acc.iterations)


def gather_accumulator(acc_block: Accumulator, mesh: M.Mesh) -> Accumulator:
    """The whole-image accumulator from every tile's block (an all-gather
    over this rank's tile group), on every rank."""
    return Accumulator(color=M.all_gather_rows(acc_block.color, mesh.tile_group),
                       rng=M.all_gather_rows(acc_block.rng, mesh.tile_group),
                       iterations=acc_block.iterations)


def render_sharded(
    scene: Scene,
    camera: Camera,
    acc_block: Accumulator,
    spp: int,
    mesh: M.Mesh,
    num_bounces: int = 15,
    russian_roulette: bool = False,
    algorithm: str = "inline",
    nee: bool = True,
    queue_factor: float = 2.0,
) -> Accumulator:
    """`spp` more samples of this rank's row block, with no collective.

    `algorithm`: "inline" (the parity megakernel on a CUDA device),
    "physical" (the NEE megakernel; `nee` as there), "wavefront"
    or "split" (the splitting kernel).  Each takes the route
    `Renderer.step` takes for the same accumulator device, with
    `row_offset = tile * block_h` of an image of `block_h * n_tile` rows;
    the BRDF kinds and the emitters are read from the scene, the same on
    every rank."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    block_h = acc_block.color.shape[0]
    place = dict(row_offset=mesh.tile * block_h, full_height=block_h * mesh.n_tile)
    if algorithm == "physical":
        return render_nee.render_batch_physical(
            scene, camera, acc_block, spp, num_bounces, nee=nee,
            kinds=render_nee._present_kinds(scene), light_idx=nee_ops.scene_light_indices(scene),
            **place)
    if algorithm == "wavefront":
        return wavefront.render_batch_wavefront(scene, camera, acc_block, spp, num_bounces,
                                                russian_roulette, **place)
    if algorithm == "split":
        return wavefront.render_batch_split_auto(scene, camera, acc_block, spp, num_bounces,
                                                 queue_factor=queue_factor, **place)
    return integrator.render_batch_auto(scene, camera, acc_block, spp, num_bounces,
                                        russian_roulette, has_dielectric=scene.has_dielectric(),
                                        **place)


def render_radiance_sharded(
    scene: Scene,
    camera: Camera,
    rng_block: torch.Tensor,
    mesh: M.Mesh,
    width: int,
    height: int,
    num_bounces: int = 4,
    spp_per_shard: int = 1,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    estimator: str = "parity",
    light_idx: tuple | None = None,
    kinds=None,
) -> torch.Tensor:
    """Expected radiance with tiles and samples sharded: this rank's block
    [height // n_tile, width, 3] of the mean over the sample axis.

    `rng_block` is this rank's [height // n_tile, width, 4] states: its
    tile's rows of its sample's stream.  Each rank renders
    `spp_per_shard` samples of its block (`diff/grad.py:render_radiance`,
    its routes and arguments); the mean over the tile row is an
    all-reduce.  The result is detached: the sharded gradient is
    `train_step_sharded`'s."""
    if height % mesh.n_tile or rng_block.shape[:2] != (height // mesh.n_tile, width):
        raise ValueError(f"rng block {tuple(rng_block.shape)} is not a row block of "
                         f"{height}x{width} over {mesh.n_tile} tiles")
    block_h = height // mesh.n_tile
    local = G.render_radiance(
        scene, camera, rng_block, width, block_h, num_bounces, spp_per_shard, backend,
        has_dielectric, estimator, light_idx, kinds, row_offset=mesh.tile * block_h,
        full_height=height,
    ).detach()
    if mesh.sample_group is None:
        return local
    return M.all_reduce_sum(local.clone(), mesh.sample_group) / float(mesh.n_sample)


def loss_and_grad_sharded(
    params: G.SceneParams,
    template: Scene,
    camera: Camera,
    target_block: torch.Tensor,
    rng_block: torch.Tensor,
    mesh: M.Mesh,
    num_bounces: int = 4,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    estimator: str = "parity",
    light_idx: tuple | None = None,
    kinds=None,
):
    """(loss, SceneParams of gradients) of the whole image, the same on
    every rank.

    Each rank renders its block at one sample (`render_radiance` with its
    row offset) and differentiates its share of the squared error, divided
    by the whole image's size; the gradients and the loss go into one flat
    buffer, summed over the mesh by one all-reduce and divided by n_sample
    (a sum over the tile axis, a mean over the sample axis)."""
    block_h, width = target_block.shape[:2]
    full_height = block_h * mesh.n_tile
    denom = float(full_height * width * target_block.shape[2])
    leaves = [t.detach().requires_grad_() for t in params]
    with torch.enable_grad():
        scene = G.params_to_scene(G.SceneParams(*leaves), template)
        rad = G.render_radiance(
            scene, camera, rng_block, width, block_h, num_bounces, 1, backend, has_dielectric,
            estimator, light_idx, kinds, row_offset=mesh.tile * block_h, full_height=full_height,
        )
        loss = ((rad - target_block) ** 2).sum() / denom
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    if mesh.world_group is not None:
        flat = M.all_reduce_sum(flat, mesh.world_group)
        if mesh.n_sample > 1:
            flat = flat / float(mesh.n_sample)
    out, start = [], 0
    for t in leaves:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return flat[-1], G.SceneParams(*out)


def train_step_sharded(
    params: G.SceneParams,
    template: Scene,
    camera: Camera,
    target_block: torch.Tensor,
    rng_block: torch.Tensor,
    mesh: M.Mesh,
    num_bounces: int = 4,
    lr: float = 1e-2,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    estimator: str = "parity",
    light_idx: tuple | None = None,
    kinds=None,
):
    """One SGD step of inverse rendering with rays and gradients sharded:
    `target_block` and `rng_block` are this rank's rows, `params` the same
    on every rank.  Returns (new params, loss), the same on every rank.

    `estimator="physical"` trains the NEE estimator; with `light_idx` on a
    CUDA device each block runs the NEE megakernel and its backward
    (`render_radiance`'s routes)."""
    loss, grads = loss_and_grad_sharded(
        params, template, camera, target_block, rng_block, mesh, num_bounces, backend,
        has_dielectric, estimator, light_idx, kinds)
    new = G.SceneParams(*(p.detach() - lr * g for p, g in zip(params, grads)))
    return new, loss
