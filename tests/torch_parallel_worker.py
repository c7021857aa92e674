"""One rank of the port's row-sharded paths on the CPU, for
tests/test_torch_parallel.py, which starts four of these as a 2x2 (tile,
sample) mesh on gloo and holds what they write against the JAX package's
sharded functions:

    python tests/torch_parallel_worker.py RANK WORLD INIT_METHOD DIR

reads DIR/inputs.npz (scenes, camera, rng states and targets, made by the
test from seeds) and writes DIR/out_RANK.npz: the four algorithms'
`render_sharded` gathered to whole images, `render_radiance_sharded`
gathered, `train_step_sharded` (parity and physical, backend torch), this
rank's `local_row_block` and `host_to_global` block, and a scene after
`replicate_tree` (rank 0's; the other ranks start from a perturbed copy).
Imports torch and the port only.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from haskell_path_tracer_torch.diff import grad as G  # noqa: E402
from haskell_path_tracer_torch.models import convert as C  # noqa: E402
from haskell_path_tracer_torch.models.objects import Accumulator  # noqa: E402
from haskell_path_tracer_torch.parallel import mesh as M  # noqa: E402
from haskell_path_tracer_torch.parallel import multihost as MH  # noqa: E402
from haskell_path_tracer_torch.parallel import shard as S  # noqa: E402

ALGORITHM_SCENES = {"inline": "main", "physical": "main", "wavefront": "main", "split": "glass"}


def _scene(z, name, shift=0.0):
    """A scene of the inputs, its float arrays moved by `shift`."""
    prefix = f"{name}__"
    arrays = {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}
    return C.scene_from_numpy(
        {k: v + shift if v.dtype == np.float32 else v for k, v in arrays.items()}, "cpu")


def main(rank: int, world: int, init_method: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    assert MH.initialize_distributed(init_method, world, rank, device="cpu")
    mesh = M.make_mesh(n_tile=2, n_sample=world // 2, device="cpu")
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        z = {k: z[k] for k in z.files}
    w, h, bounces, spp = (int(v) for v in z["config"])
    lr = float(z["lr"])
    cam = C.camera_from_numpy({"position": z["cam__position"], "rotation": z["cam__rotation"],
                               "fov": z["cam__fov"]}, "cpu")
    out = {"tile": mesh.tile, "sample": mesh.sample}

    for algo, scene_name in ALGORITHM_SCENES.items():
        scene = _scene(z, scene_name)
        acc = Accumulator(color=torch.zeros(h, w, 3), rng=C.rng_from_numpy(z[f"rng__{algo}"], "cpu"),
                          iterations=0)
        block = S.render_sharded(scene, cam, S.place_accumulator(acc, mesh), spp, mesh,
                                 num_bounces=bounces, algorithm=algo, queue_factor=2.0)
        whole = S.gather_accumulator(block, mesh)
        out[f"render__{algo}__color"] = whole.color.numpy()
        out[f"render__{algo}__rng"] = C.rng_to_numpy(whole.rng)
        out[f"render__{algo}__iterations"] = whole.iterations

    scene = _scene(z, "main")
    rng_block = MH.host_to_global(z["rad_rngs"][mesh.sample], mesh)
    rad = S.render_radiance_sharded(scene, cam, rng_block, mesh, w, h, num_bounces=bounces)
    out["radiance"] = M.all_gather_rows(rad, mesh.tile_group).numpy()

    target = MH.host_to_global(z["target"], mesh)
    rng_block = MH.host_to_global(z["train_rng"], mesh)
    for est in ("parity", "physical"):
        new, loss = S.train_step_sharded(G.scene_to_params(scene), scene, cam, target, rng_block,
                                         mesh, num_bounces=bounces, lr=lr, backend="torch",
                                         estimator=est)
        out[f"train__{est}__loss"] = loss.numpy()
        for f, v in zip(G.SceneParams._fields, new):
            out[f"train__{est}__{f}"] = v.numpy()

    out["row_block"] = np.array(MH.local_row_block(h, mesh.n_tile))
    out["host_block"] = MH.host_to_global(z["target"], mesh).numpy()
    mine = scene if rank == 0 else _scene(z, "main", shift=1.0)
    for k, v in C.scene_to_numpy(MH.replicate_tree(mine, mesh)).items():
        out[f"replicated__{k}"] = v
    np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
