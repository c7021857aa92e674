"""Starting the process group, and moving host data onto the ranks.

Counterpart of ``haskell_path_tracer_tpu/parallel/multihost.py``.  JAX
starts one process per host and addresses every chip from it; the port
starts one process per device (`torchrun`, or any launcher that gives each
process its rank), so a rank's data is its own row block and "global"
arrays are the blocks of all ranks together.  Host data must be the same
on every rank (deterministic seeding gives that for accumulators).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as M


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
) -> bool:
    """Join the default process group if the run has more than one process
    (or `init_method` names one); returns whether it did.

    Omitted arguments come from torchrun's environment: WORLD_SIZE, RANK,
    MASTER_ADDR and MASTER_PORT (``tcp://MASTER_ADDR:MASTER_PORT``), and
    LOCAL_RANK for the CUDA device the process takes.  The backend is NCCL
    for `device="cuda"` and gloo for "cpu" unless `backend` names one; a
    backend or device that is missing raises: no other is taken in its
    place."""
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return False
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if init_method is None:
        try:
            init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        except KeyError as e:
            raise RuntimeError(f"initialize_distributed: {e.args[0]} is not set") from e
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend not in available or not available[backend]():
        raise RuntimeError(f"the {backend!r} backend is not available in this torch build")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') needs a CUDA GPU")
        local_rank = int(env.get("LOCAL_RANK", rank))
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} but {torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def local_row_block(full_height: int, n_tile: int):
    """This rank's rows [start, stop) under tile sharding: tile
    `rank // n_sample` of `n_tile` equal blocks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world % n_tile or full_height % n_tile:
        raise ValueError(f"{full_height} rows, {world} ranks: not divisible by {n_tile} tiles")
    per = full_height // n_tile
    tile = rank // (world // n_tile)
    return tile * per, (tile + 1) * per


def host_to_global(x, mesh: M.Mesh) -> torch.Tensor:
    """This rank's row block of a host array (numpy or tensor, the same on
    every rank), on the mesh's device.  uint32 words (rng states) come as
    the int32 tensors that hold their bit patterns."""
    start, stop = local_row_block(x.shape[0], mesh.n_tile)
    block = x[start:stop]
    if isinstance(block, np.ndarray):
        if block.dtype == np.uint32:
            block = block.view(np.int32)
        block = torch.as_tensor(np.ascontiguousarray(block))
    return block.to(mesh.device).contiguous()


def replicate_tree(tree, mesh: M.Mesh):
    """Every tensor of `tree` (a Scene, Camera, SceneParams, or dicts,
    lists and tuples of them) as rank 0 holds it, on every rank, on the
    mesh's device; what is not a tensor is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return M.broadcast(tree.to(mesh.device, copy=True).contiguous(), mesh.world_group)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate_tree(getattr(tree, f.name), mesh) for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate_tree(v, mesh) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_tree(v, mesh) for v in tree)
    if isinstance(tree, dict):
        return {k: replicate_tree(tree[k], mesh) for k in sorted(tree)}
    return tree
