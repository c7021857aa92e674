"""The port's row-sharded execution (`parallel/`) on the CPU, and the row
blocks of `diff/grad.py:render_radiance` it rests on.

  * `render_radiance(row_offset, full_height)` on a block, with its
    cotangent, equals those rows and that gradient of the whole image, bit
    for bit, on each route that runs on the CPU.
  * World 1: a process with no group, and a gloo group of one rank in this
    process, render and train exactly as the unsharded functions do.
  * One spawn of four gloo ranks (`tests/torch_parallel_worker.py`, a 2x2
    (tile, sample) mesh) runs every multi-rank check, held against the
    JAX package's sharded functions on four of its virtual CPU devices:
    rng bit-equal and radiance within each family's tolerance (parity
    inline: `lane_agreement`'s 99.5% / 99%; wavefront: 1e-6; split: 1e-4
    against the compiled JAX loop; physical: `assert_lane_parity`), the
    train step's loss within rtol 1e-5 and each updated field within the
    family's normalised bound (parity 1e-2, physical 5e-3) of its update.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.diff import grad as JG
from haskell_path_tracer_tpu.models.objects import (
    BRDF_DIELECTRIC,
    BRDF_MATTE,
    Scene as JaxScene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer_tpu.ops.rng import gen_seeds as jax_gen_seeds
from haskell_path_tracer_tpu.parallel import mesh as JM
from haskell_path_tracer_tpu.parallel import shard as JS

import haskell_path_tracer_torch as hpt
from haskell_path_tracer_torch.diff import grad as G
from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.parallel import mesh as M
from haskell_path_tracer_torch.parallel import multihost as MH
from haskell_path_tracer_torch.parallel import shard as S
from haskell_path_tracer_torch.render import integrator as tint
from haskell_path_tracer_torch.render import nee as tnee
from haskell_path_tracer_torch.render import wavefront as twf

from test_pallas_nee import assert_lane_parity
from torch_port_fixtures import lane_agreement

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
W, H, BOUNCES, SPP, LR = 16, 8, 2, 2, 0.1
SEEDS = {"inline": 4, "physical": 13, "wavefront": 6, "split": 8}


def jax_glass_scene():
    """tests/test_sharding.py's glass scene for the split algorithm."""
    s = make_spheres([[0.0, 0.0, -4.0]], [1.4],
                     make_materials([([0.97, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, 1.5)]))
    p = make_planes([[0.0, 0.0, -9.0], [0.0, -3.0, 0.0]], [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
                    make_materials([([1.0, 0.9, 0.7], 3.0, BRDF_MATTE, 1.0),
                                    ([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2)]))
    return JaxScene(spheres=s, planes=p)


# --- render_radiance's row blocks --------------------------------------------

R0, BLOCK_H, FULL_H = 4, 4, 12


def _block_and_whole(scene, radiance):
    """(whole image, its gradients, block, its gradients) of `radiance(scene,
    rng, height, row_offset, full_height)` under a cotangent that is zero
    outside rows [R0, R0 + BLOCK_H)."""
    rng = gen_seeds((FULL_H, W), 3, "cpu")
    cot = torch.as_tensor(np.random.default_rng(0).normal(size=(FULL_H, W, 3)).astype(np.float32))
    cot[:R0] = 0
    cot[R0 + BLOCK_H:] = 0
    out = []
    for rows, kw in ((slice(None), {}), (slice(R0, R0 + BLOCK_H),
                                         dict(row_offset=R0, full_height=FULL_H))):
        leaves = [t.detach().clone().requires_grad_() for t in G.scene_to_params(scene)]
        s = G.params_to_scene(G.SceneParams(*leaves), scene)
        r = rng[rows]
        rad = radiance(s, r, r.shape[0], **kw)
        grads = torch.autograd.grad((rad * cot[rows]).sum(), leaves, allow_unused=True)
        out += [rad.detach(), grads]
    return out


def _dual_query(s, rng, h, row_offset=0, full_height=None):
    """The dual-query trace (`trace_physical(fused=True)`, the route
    `render_radiance` takes without `light_idx` on a CUDA scene of spheres
    and planes) on the rays `render_radiance` builds, over two samples."""
    rays = primary_rays(hpt.initial_camera("cpu"), W, h, row_offset, full_height)
    rad1, rng = tnee.trace_physical(s, rays, rng, BOUNCES, fused=True)
    rad2, _ = tnee.trace_physical(s, rays, rng, BOUNCES, fused=True)
    return torch.stack([rad1, rad2]).mean(dim=0)


ROUTES = {
    "parity_torch": lambda s, rng, h, **kw: G.render_radiance(
        s, hpt.initial_camera("cpu"), rng, W, h, BOUNCES, 2, backend="torch", **kw),
    "physical_torch": lambda s, rng, h, **kw: G.render_radiance(
        s, hpt.initial_camera("cpu"), rng, W, h, BOUNCES, 2, backend="torch",
        estimator="physical", **kw),
    "dual_query": _dual_query,
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_render_radiance_row_block_is_the_whole_images_rows(route):
    whole, g_whole, block, g_block = _block_and_whole(hpt.main_scene("cpu"), ROUTES[route])
    assert torch.equal(block, whole[R0:R0 + BLOCK_H])
    assert whole.abs().max() > 0
    for f, a, b in zip(G.SceneParams._fields, g_whole, g_block):
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    # The default (no offset) is the image render_radiance always built.
    rng = gen_seeds((FULL_H, W), 3, "cpu")
    assert torch.equal(
        G.render_radiance(hpt.main_scene("cpu"), hpt.initial_camera("cpu"), rng, W, FULL_H,
                          BOUNCES, 1, backend="torch"),
        G.render_radiance(hpt.main_scene("cpu"), hpt.initial_camera("cpu"), rng, W, FULL_H,
                          BOUNCES, 1, backend="torch", row_offset=0, full_height=FULL_H))


# --- world 1 ---------------------------------------------------------------

def _unsharded(algo, scene, cam, acc):
    if algo == "physical":
        return tnee.render_batch_physical(scene, cam, acc, SPP, BOUNCES)
    if algo == "wavefront":
        return twf.render_batch_wavefront(scene, cam, acc, SPP, BOUNCES)
    if algo == "split":
        return twf.render_batch_split_auto(scene, cam, acc, SPP, BOUNCES, queue_factor=2.0)
    return tint.render_batch_auto(scene, cam, acc, SPP, BOUNCES)


def _world_one_checks(mesh):
    assert (mesh.n_tile, mesh.n_sample, mesh.tile, mesh.sample) == (1, 1, 0, 0)
    assert mesh.tile_group is None and mesh.sample_group is None and mesh.world_group is None
    scene, cam = hpt.main_scene("cpu"), hpt.initial_camera("cpu")
    for algo, seed in SEEDS.items():
        acc = tint.make_accumulator(W, H, seed, "cpu")
        got = S.gather_accumulator(S.render_sharded(scene, cam, S.place_accumulator(acc, mesh),
                                                    SPP, mesh, BOUNCES, algorithm=algo), mesh)
        want = _unsharded(algo, scene, cam, acc)
        assert torch.equal(got.color, want.color) and torch.equal(got.rng, want.rng), algo
        assert got.iterations == SPP
    params, rng = G.scene_to_params(scene), gen_seeds((H, W), 9, "cpu")
    target = torch.full((H, W, 3), 0.1)
    new, loss = S.train_step_sharded(params, scene, cam, target, rng, mesh, BOUNCES, lr=LR,
                                     backend="torch")
    want_loss, grads = G.loss_and_grad(params, scene, cam, target, rng, num_bounces=BOUNCES,
                                       backend="torch")
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-6)
    for f, p, g, n in zip(G.SceneParams._fields, params, grads, new):
        np.testing.assert_allclose(n.numpy(), (p - LR * g).numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=f)


def test_world_of_one_process_without_a_group():
    assert not dist.is_initialized()
    assert MH.initialize_distributed(world_size=1) is False
    assert MH.local_row_block(H, 1) == (0, H)
    _world_one_checks(M.make_mesh(device="cpu"))
    with pytest.raises(ValueError, match="mesh 2x1"):
        M.make_mesh(n_tile=2, device="cpu")


def test_world_of_one_gloo_rank(tmp_path):
    assert MH.initialize_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        _world_one_checks(M.make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_refuses_what_is_missing(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="'mpi' backend is not available"):
        MH.initialize_distributed(f"file://{tmp_path}/s", 1, 0, device="cpu", backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            MH.initialize_distributed(f"file://{tmp_path}/s", 1, 0, device="cuda",
                                      backend="gloo")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR is not set"):
        MH.initialize_distributed(device="cpu")
    assert not dist.is_initialized()


# --- four gloo ranks against the JAX package's virtual mesh ---------------

def _inputs(path):
    """The inputs both sides render, from seeds: scenes, camera, rng states
    and the target."""
    arrays = {"config": np.array([W, H, BOUNCES, SPP]), "lr": np.float32(LR),
              "target": np.full((H, W, 3), 0.1, np.float32),
              "train_rng": np.asarray(jax_gen_seeds((H, W), seed=9)),
              "rad_rngs": np.stack([np.asarray(jax_gen_seeds((H, W), seed=s)) for s in (0, 1)])}
    for name, scene in (("main", J.main_scene()), ("glass", jax_glass_scene())):
        arrays.update({f"{name}__{k}": v for k, v in C.scene_to_numpy(scene).items()})
    arrays.update({f"cam__{k}": v for k, v in C.camera_to_numpy(J.initial_camera()).items()})
    for algo, seed in SEEDS.items():
        arrays[f"rng__{algo}"] = np.asarray(J.make_accumulator(W, H, seed=seed).rng)
    np.savez(path, **arrays)
    return arrays


def _jax_side(inp):
    """The JAX package's sharded functions on a 2x2 mesh of four virtual CPU
    devices.  `shard_map` outside jit runs op by op, so each function is
    jitted; tracing holds the interpreter, so the functions are lowered in
    turn, slowest first, and compiled in threads while the next lowers."""
    mesh = JM.make_mesh(n_tile=2, n_sample=2, devices=jax.devices()[:4])
    cam = J.initial_camera()
    scenes = {"main": J.main_scene(), "glass": jax_glass_scene()}
    params = JG.scene_to_params(scenes["main"])
    train = (jnp.asarray(inp["target"]), jnp.asarray(inp["train_rng"]))
    calls = {f"train_{est}": (lambda target, rng, est=est: JS.train_step_sharded(
        params, scenes["main"], cam, target, rng, mesh, num_bounces=BOUNCES, lr=LR,
        estimator=est), train) for est in ("physical", "parity")}
    for algo, seed in SEEDS.items():
        calls[algo] = (lambda acc, algo=algo: JS.render_sharded(
            scenes["glass" if algo == "split" else "main"], cam, acc, SPP, mesh,
            num_bounces=BOUNCES, algorithm=algo, queue_factor=2.0),
            (JS.place_accumulator(J.make_accumulator(W, H, seed=seed), mesh),))
    calls["radiance"] = (lambda rngs: JS.render_radiance_sharded(
        scenes["main"], cam, rngs, mesh, W, H, num_bounces=BOUNCES),
        (jnp.asarray(inp["rad_rngs"]),))
    with ThreadPoolExecutor(len(calls)) as pool:
        compiled = {name: pool.submit(jax.jit(fn).lower(*args).compile)
                    for name, (fn, args) in calls.items()}
        res = {name: compiled[name].result()(*args) for name, (_, args) in calls.items()}
    out = {algo: (np.asarray(res[algo].color), np.asarray(res[algo].rng), int(res[algo].iterations))
           for algo in SEEDS}
    out["radiance"] = np.asarray(res["radiance"])
    for est in ("parity", "physical"):
        new, loss = res[f"train_{est}"]
        out[f"train_{est}"] = (float(loss), C.params_to_numpy(new), C.params_to_numpy(params))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Starts the four ranks, computes the JAX side while they run, and
    returns (JAX results, each rank's outputs, inputs)."""
    d = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs(os.path.join(d, "inputs.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    worker = os.path.join(HERE, "torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "4", f"file://{d}/store", d],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        jax_out = _jax_side(inp)
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(4):
        with np.load(os.path.join(d, f"out_{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return jax_out, outs, inp


@pytest.mark.parametrize("algo", list(SEEDS))
def test_render_sharded_matches_jax(four_ranks, algo):
    jax_out, outs, _ = four_ranks
    jcolor, jrng, jits = jax_out[algo]
    color, rng = outs[0][f"render__{algo}__color"], outs[0][f"render__{algo}__rng"]
    for o in outs[1:]:  # every rank gathered the same image
        np.testing.assert_array_equal(o[f"render__{algo}__color"], color)
        np.testing.assert_array_equal(o[f"render__{algo}__rng"], rng)
    assert int(outs[0][f"render__{algo}__iterations"]) == jits == SPP
    if algo == "physical":
        assert_lane_parity(jrng, rng, jcolor, color)
        return
    np.testing.assert_array_equal(rng, jrng)
    if algo == "inline":
        rng_match, close, lit_close = lane_agreement(rng, jrng, color, jcolor)
        assert rng_match == 1.0 and close >= 0.99 and lit_close >= 0.99
    else:
        tol = 1e-6 if algo == "wavefront" else 1e-4
        np.testing.assert_allclose(color, jcolor, rtol=tol, atol=tol)
    assert np.abs(color).max() > 0


def test_render_radiance_sharded_matches_jax(four_ranks):
    """The sample axis' mean: the JAX package's, and the mean of the two
    streams rendered on one process."""
    jax_out, outs, inp = four_ranks
    for o in outs:
        np.testing.assert_allclose(o["radiance"], jax_out["radiance"], rtol=1e-5, atol=1e-5)
    scene, cam = hpt.main_scene("cpu"), hpt.initial_camera("cpu")
    single = [G.render_radiance(scene, cam, C.rng_from_numpy(r, "cpu"), W, H, BOUNCES)
              for r in inp["rad_rngs"]]
    np.testing.assert_allclose(outs[0]["radiance"], ((single[0] + single[1]) / 2).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("est,bound", [("parity", 1e-2), ("physical", 5e-3)])
def test_train_step_sharded_matches_jax(four_ranks, est, bound):
    jax_out, outs, _ = four_ranks
    jloss, jnew, jold = jax_out[f"train_{est}"]
    for o in outs:
        np.testing.assert_allclose(float(o[f"train__{est}__loss"]), jloss, rtol=1e-5)
        for f in G.SceneParams._fields:
            step = jnew[f].astype(np.float64) - jold[f]
            got = o[f"train__{est}__{f}"].astype(np.float64) - jold[f]
            if step.size and np.abs(step).max() > 0:
                err = np.abs(got - step).max() / np.abs(step).max()
                assert err < bound, (f, err)
            else:
                assert np.abs(got).max(initial=0.0) == 0.0, f


def test_row_blocks_host_to_global_and_replicate_tree(four_ranks):
    _, outs, inp = four_ranks
    main = C.scene_to_numpy(J.main_scene())
    for r, o in enumerate(outs):
        tile, sample = r // 2, r % 2
        assert (int(o["tile"]), int(o["sample"])) == (tile, sample)
        start, stop = o["row_block"].tolist()
        assert (start, stop) == (tile * H // 2, (tile + 1) * H // 2)
        np.testing.assert_array_equal(o["host_block"], inp["target"][start:stop])
        for k, v in main.items():
            np.testing.assert_array_equal(o[f"replicated__{k}"], v)
