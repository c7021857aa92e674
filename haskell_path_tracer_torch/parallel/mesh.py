"""A (tile, sample) mesh over the ranks of a `torch.distributed` group.

Counterpart of ``haskell_path_tracer_tpu/parallel/mesh.py``.  There a mesh
is a 2-D array of devices and `shard_map` runs one program over it; here
every rank is one process with one device, and the mesh is the layout of
``np.arange(world).reshape(n_tile, n_sample)``: rank r holds tile
``r // n_sample`` (a block of image rows) and sample ``r % n_sample`` (an
independent rng stream of that block).

  * Forward rendering needs no collective: a rank traces its rows with the
    scene replicated (`shard.py:render_sharded`).
  * The sample axis is reduced over the ranks that share a tile (its tile
    row, `sample_group`): the mean radiance of `render_radiance_sharded`.
  * The tile axis is reduced over the ranks that share a sample index (its
    sample column, `tile_group`): the full image of `gather_accumulator`.
  * The gradient step sums over tiles and averages over samples: one
    all-reduce over the whole group, divided by n_sample.

A world of one process with no process group is a valid 1x1 mesh with no
collectives; so is any axis of length 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh, its device, and the groups it
    reduces over (None where the group would hold this rank alone)."""

    n_tile: int
    n_sample: int
    rank: int
    device: torch.device
    # The ranks of this rank's sample column (one rank per tile).
    tile_group: object = None
    # The ranks of this rank's tile row (one rank per sample).
    sample_group: object = None
    # Every rank, when there is more than one.
    world_group: object = None

    @property
    def tile(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample(self) -> int:
        return self.rank % self.n_sample


def _default_device() -> torch.device:
    """The process's current CUDA device (the port's default), or a raise
    when there is none: the caller names "cpu" to run there."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh needs a CUDA GPU unless device='cpu' is given")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_tile: int | None = None, n_sample: int = 1, device=None) -> Mesh:
    """The (tile, sample) mesh over every rank of the default group (every
    rank calls it, in the same order as its other group creations).
    `n_tile` defaults to all ranks on the tile axis."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_tile is None:
        n_tile = world // n_sample
    if n_tile < 1 or n_sample < 1 or n_tile * n_sample != world:
        raise ValueError(f"mesh {n_tile}x{n_sample} != {world} ranks")
    groups = {}
    if world > 1:
        # new_group is collective: every rank creates every group.
        layout = [[t * n_sample + s for s in range(n_sample)] for t in range(n_tile)]
        for name, members in [("sample_group", row) for row in layout] + [
                ("tile_group", list(col)) for col in zip(*layout)]:
            if len(members) > 1:
                group = dist.new_group(members)
                if rank in members:
                    groups[name] = group
        groups["world_group"] = dist.group.WORLD
    return Mesh(n_tile=n_tile, n_sample=n_sample, rank=rank,
                device=torch.device(device) if device is not None else _default_device(),
                **groups)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group` (unchanged when the group is None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """`t` of every rank of `group`, in rank order, concatenated along
    dim 0 (`t` itself when the group is None)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """`t` of the group's first rank, on every rank, in place."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t

