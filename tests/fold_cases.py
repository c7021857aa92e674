"""The sphere folds' synthetic tables and rays, made from a seed with
numpy: `chip_smoke.py` phase 18 holds the CUDA folds against their plain
versions on them, and `tests/test_torch_sphere_fold_host.py` the host build
of the same per-ray code."""

import numpy as np
import torch


def edge_spheres(num, seed, dev):
    """`num` spheres in [-4, 4]^3, radii 0.3-1.2, from 7 on with rows
    num // 2 and num - 1 repeating rows 1 and 0."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4.0, 4.0, (num, 3)).astype(np.float32)
    radius = rng.uniform(0.3, 1.2, num).astype(np.float32)
    if num >= 7:
        pos[num // 2], radius[num // 2] = pos[1], radius[1]
        pos[num - 1], radius[num - 1] = pos[0], radius[0]
    return torch.as_tensor(pos, device=dev), torch.as_tensor(radius, device=dev)


def edge_rays(pos, radius, n, seed, dead_share=0.3):
    """n rays from [-6, 6]^3, two in three aimed near a sphere, with the
    dual query's operands: shadow rays towards a random sphere ending at
    its surface, that sphere excluded, `dead_share` of the lanes dead."""
    rng = np.random.default_rng(seed)
    p, dev = pos.cpu().numpy(), pos.device
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    aim = p[rng.integers(0, len(p), n)] + rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    d = np.where((np.arange(n) % 3 != 0)[:, None], aim - o, rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    li = rng.integers(0, len(p), n)
    to_c = p[li] - o
    dist = np.linalg.norm(to_c, axis=-1)
    t_light = np.maximum(dist - radius.cpu().numpy()[li], 1e-3).astype(np.float32)
    alive = (rng.uniform(size=n) >= dead_share).astype(np.int32)
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                 for x in (o, d, (to_c / dist[:, None]).astype(np.float32), t_light,
                           li.astype(np.int32), alive))
