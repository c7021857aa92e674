"""Shared inputs for the PyTorch port's tests: the scenes both packages
render, built with the JAX package and carried across as numpy arrays.

Also writes the golden files that `chip_smoke.py` holds the CUDA kernels
against on a machine without JAX:

    JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py [nee | nee_grad | split]

regenerates ``tests/data/torch_port_nee_golden.npz`` (seconds) with `nee`,
``tests/data/torch_port_nee_grad_golden.npz`` (seconds) with `nee_grad`,
``tests/data/torch_port_split_golden.npz`` (seconds) with `split`, and all
four, ``tests/data/torch_port_golden.npz`` (minutes) too, without an
argument.  The split file holds, for each splitting case, the JAX
package's inputs (scene arrays, primary rays, initial rng) and the outputs
of its Pallas splitting kernel, `trace_split_pallas` in interpret mode, at
128x8.  The NEE gradient file holds, for cornell8, tri and glassy at
32x16, 2 spp and 3 bounces, the inputs, a radiance cotangent `wts` and
`jax.vjp` of the JAX package's XLA estimator for every `SceneParams` field
and the rays (`jax_nee_grad_trace`).  The NEE file holds,
for each NEE case, the JAX package's inputs (scene arrays, primary rays,
initial rng, the emitters' index tuple) and the outputs of its XLA
estimator, `render_batch_physical(fused=False)`'s loop of
`trace_physical`, at 128x16, 2 spp and 3 bounces (the estimator
tests/test_pallas_nee.py ties to the Pallas NEE kernel).  The parity file holds, for each golden case,
the JAX package's inputs (scene arrays, primary rays, initial rng) and
outputs (`trace_inline_pallas` in interpret mode) at 128x16; and for each
gradient case, the inputs, a radiance cotangent `wts` and the four
cotangents (tables, ray origin, ray direction) of `jax.grad` through the
differentiable kernel of `trace_inline_pallas_diff` in interpret mode, at
32x16.  The gradient cases run 2 bounces: the JAX package's interpret-mode
backward compiles in time that doubles with each bounce (about 30 s at 2,
110 s at 4 for the reference scene).
"""

from __future__ import annotations

import os

import numpy as np
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays
from haskell_path_tracer_tpu.models.objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Camera as JaxCamera,
    Rays as JaxRays,
    Scene as JaxScene,
)
from haskell_path_tracer_tpu.ops.pallas_megakernel import trace_inline_pallas

from haskell_path_tracer_torch.models import convert as C
from haskell_path_tracer_torch.models.objects import Rays

W, H = 128, 16
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden.npz")

# name -> (scene, spp, bounces, russian_roulette, accumulator seed)
CASES = {
    "main": ("main", 2, 6, False, 2),
    "mixed": ("mixed", 2, 6, False, 11),
    "glass": ("glass", 2, 6, False, 5),
    "roulette": ("glass", 2, 6, True, 7),
}
GOLDEN_CASES = ("main", "mixed", "glass")

GRAD_W, GRAD_H = 32, 16
# name -> (scene, spp, bounces, seed of the rng and of the cotangent wts)
GRAD_CASES = {
    "main": ("main", 2, 2, 21),
    "mixed": ("mixed", 2, 2, 22),
    "glass": ("glass", 2, 2, 23),
}
GRAD_OUTPUTS = ("d_geom", "d_mat", "d_origin", "d_direction")


def jax_mixed_scene():
    """All four primitive kinds, with an emissive triangle and a glossy box
    (the mixed-kinds scene of tests/test_pallas.py)."""
    spheres = J.make_spheres(
        [[0.0, 0.5, -9.0], [3.0, 4.0, -8.0]],
        [1.0, 0.8],
        J.make_materials(
            [
                ([0.9, 0.3, 0.3], 0.0, BRDF_MATTE, 1.2),
                ([1.0, 1.0, 0.9], 80.0, BRDF_MATTE, 1.0),
            ]
        ),
    )
    planes = J.make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        J.make_materials([([0.4, 0.7, 0.4], 0.0, BRDF_MATTE, 1.5)]),
    )
    boxes = J.make_boxes(
        [[-3.5, -3.0, -8.0]],
        [[-1.5, -0.5, -6.0]],
        J.make_materials([([0.3, 0.3, 0.9], 0.0, BRDF_GLOSSY, 0.9)]),
    )
    tris = J.make_triangles(
        [[1.0, -3.0, -6.0]],
        [[4.0, -3.0, -6.5]],
        [[2.5, 0.5, -7.0]],
        J.make_materials([([0.9, 0.8, 0.2], 5.0, BRDF_MATTE, 1.0)]),
    )
    return JaxScene(spheres=spheres, planes=planes, boxes=boxes, triangles=tris)


def jax_glass_scene():
    """The reference scene with its large red sphere turned to glass (IOR
    1.5), the small mirror sphere to water (IOR 1.33) and a softly emissive
    ceiling, so that most paths carry light and the comparison of
    radiance is not a comparison of zeros."""
    s = J.main_scene()
    m = s.spheres.material
    kinds = np.asarray(m.brdf_kind).copy()
    params = np.asarray(m.brdf_param).copy()
    kinds[0], params[0] = BRDF_DIELECTRIC, 1.5
    kinds[2], params[2] = BRDF_DIELECTRIC, 1.33
    mat = J.make_materials(
        [
            (np.asarray(m.color[i]), float(m.illuminance[i]), int(kinds[i]), float(params[i]))
            for i in range(m.count)
        ]
    )
    spheres = J.make_spheres(s.spheres.pos, s.spheres.radius, mat)
    pm = s.planes.material
    planes = J.make_planes(
        s.planes.pos,
        s.planes.normal,
        J.make_materials(
            [
                (np.asarray(pm.color[0]), 0.0, int(pm.brdf_kind[0]), float(pm.brdf_param[0])),
                (np.asarray(pm.color[1]), 2.0, int(pm.brdf_kind[1]), float(pm.brdf_param[1])),
            ]
        ),
    )
    return JaxScene(spheres=spheres, planes=planes)


def jax_scene(name):
    """(scene, camera) of the JAX package for a scene name."""
    if name == "main":
        return J.main_scene(), J.initial_camera()
    if name == "mixed":
        return jax_mixed_scene(), JaxCamera.create([0.0] * 3, [0.0] * 3, 90.0)
    if name == "glass":
        return jax_glass_scene(), J.initial_camera()
    raise KeyError(name)


def torch_scene(jscene, device="cpu"):
    return C.scene_from_numpy(C.scene_to_numpy(jscene), device)


def torch_camera(jcamera, device="cpu"):
    return C.camera_from_numpy(C.camera_to_numpy(jcamera), device)


def case_inputs(case):
    """numpy inputs of a case: scene arrays, rays and the initial rng."""
    scene_name, spp, bounces, rr, seed = CASES[case]
    jscene, jcam = jax_scene(scene_name)
    rays = jax_primary_rays(jcam, W, H)
    return {
        "scene": C.scene_to_numpy(jscene),
        "origin": np.asarray(rays.origin, np.float32),
        "direction": np.asarray(rays.direction, np.float32),
        "rng_in": np.asarray(J.make_accumulator(W, H, seed=seed).rng),
        "spp": spp,
        "bounces": bounces,
        "russian_roulette": rr,
    }


def jax_trace(case):
    """Inputs of a case plus the JAX kernel's outputs (interpret mode)."""
    inp = case_inputs(case)
    radiance, rng_out = trace_inline_pallas(
        jax_scene(CASES[case][0])[0],
        JaxRays(origin=inp["origin"], direction=inp["direction"]),
        inp["rng_in"], num_bounces=inp["bounces"],
        spp=inp["spp"], russian_roulette=inp["russian_roulette"],
        interpret=True,
    )
    inp["radiance"] = np.asarray(radiance)
    inp["rng_out"] = np.asarray(rng_out)
    return inp


def grad_case_inputs(case):
    """numpy inputs of a gradient case: scene arrays, rays, rng and `wts`,
    the cotangent of the radiance sum."""
    scene_name, spp, bounces, seed = GRAD_CASES[case]
    jscene, jcam = jax_scene(scene_name)
    rays = jax_primary_rays(jcam, GRAD_W, GRAD_H)
    return {
        "scene": C.scene_to_numpy(jscene),
        "origin": np.asarray(rays.origin, np.float32),
        "direction": np.asarray(rays.direction, np.float32),
        "rng_in": np.asarray(J.make_accumulator(GRAD_W, GRAD_H, seed=seed).rng),
        "wts": np.random.default_rng(seed).normal(size=(GRAD_H, GRAD_W, 3)).astype(np.float32),
        "spp": spp,
        "bounces": bounces,
    }


def has_dielectric(scene_arrays) -> bool:
    return any(
        (np.asarray(v) == BRDF_DIELECTRIC).any()
        for k, v in scene_arrays.items() if k.endswith("material.brdf_kind")
    )


def jax_grad_trace(case):
    """Inputs of a gradient case plus the table-level cotangents of
    sum(radiance * wts) from `jax.grad` through the custom VJP that
    `trace_inline_pallas_diff` builds (interpret mode)."""
    import jax
    import jax.numpy as jnp
    from haskell_path_tracer_tpu.ops.pallas_megakernel import _scene_tables
    from haskell_path_tracer_tpu.ops.pallas_megakernel_vjp import _make_diff_fn

    inp = grad_case_inputs(case)
    jscene = jax_scene(GRAD_CASES[case][0])[0]
    geom, mat = _scene_tables(jscene)
    f = _make_diff_fn(
        inp["spp"], inp["bounces"], jscene.spheres.count, 8, 16,
        has_dielectric(inp["scene"]), True,
        num_boxes=jscene.boxes.count, num_triangles=jscene.triangles.count,
    )

    def loss(g, m, o, d):
        return jnp.sum(f(g, m, o, d, inp["rng_in"])[0] * inp["wts"])

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(geom, mat, inp["origin"], inp["direction"])
    for k, g in zip(GRAD_OUTPUTS, grads):
        inp[k] = np.asarray(g, np.float32)
    return inp


def torch_rays(inp, device="cpu"):
    return Rays(
        origin=torch.tensor(inp["origin"], device=device),
        direction=torch.tensor(inp["direction"], device=device),
    )


def golden_arrays(traces, grad_traces):
    """Flatten {case: jax_trace(case)} and {case: jax_grad_trace(case)}
    into the golden file's arrays."""
    out = {}
    for case in GRAD_CASES:
        t = grad_traces[case]
        for k, v in t["scene"].items():
            out[f"grad_{case}__scene__{k}"] = v
        for k in ("origin", "direction", "rng_in", "wts", *GRAD_OUTPUTS):
            out[f"grad_{case}__{k}"] = t[k]
        out[f"grad_{case}__config"] = np.array([t["spp"], t["bounces"]], np.int32)
    for case in GOLDEN_CASES:
        t = traces[case]
        for k, v in t["scene"].items():
            out[f"{case}__scene__{k}"] = v
        for k in ("origin", "direction", "rng_in", "radiance", "rng_out"):
            out[f"{case}__{k}"] = t[k]
        out[f"{case}__config"] = np.array(
            [t["spp"], t["bounces"], int(t["russian_roulette"])], np.int32
        )
    return out


NEE_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "torch_port_nee_golden.npz")
NEE_SPP, NEE_BOUNCES = 2, 3
# name -> accumulator seed; the scenes are tests/test_pallas_nee.py's.
NEE_CASES = {"cornell8": 31, "tri": 32, "box_tri": 33}


def jax_nee_scene(name):
    """(scene, camera) of the JAX package for an NEE scene name: the scenes
    of tests/test_pallas_nee.py with the cameras its tests use."""
    import test_pallas_nee as T

    origin_cam = JaxCamera.create([0.0] * 3, [0.0] * 3, 90.0)
    return {
        "cornell8": lambda: (T.cornell8(), J.initial_camera()),
        "glassy": lambda: (T.glassy(), origin_cam),
        "big200": lambda: (T.big(200), JaxCamera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0)),
        "zero_light": lambda: (T.zero_light(), J.initial_camera()),
        "tri": lambda: (T.tri_scene(), J.initial_camera()),
        "box_tri": lambda: (T.box_tri_scene(), origin_cam),
    }[name]()


def jax_nee_trace(case):
    """A NEE case's inputs and the JAX package's XLA estimator's outputs:
    `spp` calls of `trace_physical(fused=False)` on the stored rays, the rng
    threaded through, radiance summed — `render_batch_physical(fused=False)`
    with its primary rays taken out of the compiled loop, so that the
    stored rays are the ones traced (tests/test_pallas_nee.py:run_pair).
    One jitted sample, compiled once per case."""
    import jax

    from haskell_path_tracer_tpu.ops.pallas_nee import scene_light_indices
    from haskell_path_tracer_tpu.render.nee import trace_physical

    jscene, jcam = jax_nee_scene(case)
    rays = jax_primary_rays(jcam, W, H)
    rng = J.make_accumulator(W, H, seed=NEE_CASES[case]).rng
    sample = jax.jit(lambda r: trace_physical(jscene, rays, r, num_bounces=NEE_BOUNCES, fused=False))
    radiance, rng_out = 0.0, rng
    for _ in range(NEE_SPP):
        rad, rng_out = sample(rng_out)
        radiance = radiance + rad
    return {
        "scene": C.scene_to_numpy(jscene),
        "origin": np.asarray(rays.origin, np.float32),
        "direction": np.asarray(rays.direction, np.float32),
        "rng_in": np.asarray(rng),
        "light_idx": np.asarray(scene_light_indices(jscene), np.int32),
        "radiance": np.asarray(radiance, np.float32),
        "rng_out": np.asarray(rng_out),
    }


def nee_golden_arrays(traces):
    """Flatten {case: jax_nee_trace(case)} into the NEE golden file's arrays."""
    out = {}
    for case, t in traces.items():
        for k, v in t["scene"].items():
            out[f"{case}__scene__{k}"] = v
        for k in ("origin", "direction", "rng_in", "light_idx", "radiance", "rng_out"):
            out[f"{case}__{k}"] = t[k]
        out[f"{case}__config"] = np.array([NEE_SPP, NEE_BOUNCES], np.int32)
    return out


NEE_GRAD_GOLDEN_PATH = os.path.join(
    os.path.dirname(__file__), "data", "torch_port_nee_grad_golden.npz")
NEE_GRAD_W, NEE_GRAD_H, NEE_GRAD_SPP, NEE_GRAD_BOUNCES = 32, 16, 2, 3
# name -> seed of the rng and of the cotangent wts, for the NEE gradient
# cases; the golden file holds the first three.  At these seeds every lane
# of the port's plain forward agrees with the JAX package's
# (`assert_lane_parity`'s radiance tolerance): a lane whose path parts on a
# last-bit difference of sin/cos moves a sum of gradients more than the
# 5e-3 they are held to.
NEE_GRAD_CASES = {"cornell8": 46, "tri": 42, "glassy": 43, "zero_light": 44, "big200": 45}
NEE_GRAD_GOLDEN_CASES = ("cornell8", "tri", "glassy")
# The MSE objective's constant target (tests/test_pallas_nee_vjp.py).
NEE_GRAD_TARGET = 0.2


def jax_nee_grad_trace(case):
    """A NEE gradient case: its inputs, the radiance image of the JAX
    package's XLA estimator (`render_radiance(estimator="physical",
    backend="xla")`: the mean of `spp` traces of `trace_physical(fused=
    False)`, the rng threaded through) on the stored rays, and `jax.vjp`
    of that image with respect to every `SceneParams` field and the rays,
    pulled back from two cotangents: `wts` (the golden file's: the
    gradient of sum(image * wts)) and that of the MSE against the constant
    target NEE_GRAD_TARGET (`image_loss`'s objective, key prefix `mse_`).
    One compile per case."""
    import jax
    import jax.numpy as jnp

    from haskell_path_tracer_tpu.diff import grad as JG
    from haskell_path_tracer_tpu.ops.pallas_nee import scene_light_indices
    from haskell_path_tracer_tpu.render.nee import trace_physical

    jscene, jcam = jax_nee_scene(case)
    seed = NEE_GRAD_CASES[case]
    rays = jax_primary_rays(jcam, NEE_GRAD_W, NEE_GRAD_H)
    rng = J.make_accumulator(NEE_GRAD_W, NEE_GRAD_H, seed=seed).rng
    shape = (NEE_GRAD_H, NEE_GRAD_W, 3)
    wts = np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    def image(p, o, d):
        s = JG.params_to_scene(p, jscene)

        def body(rr, _):
            radiance, rr = trace_physical(s, JaxRays(origin=o, direction=d), rr,
                                          NEE_GRAD_BOUNCES, nee=True, fused=False)
            return rr, radiance

        _, radiances = jax.lax.scan(body, rng, None, length=NEE_GRAD_SPP)
        return jnp.mean(radiances, axis=0)

    @jax.jit
    def image_and_pullbacks(p, o, d):
        img, vjp = jax.vjp(image, p, o, d)
        mse_cot = 2.0 * (img - NEE_GRAD_TARGET) / img.size
        return img, vjp(wts), vjp(mse_cot)

    img, *pullbacks = image_and_pullbacks(
        JG.scene_to_params(jscene), rays.origin, rays.direction)
    img = np.asarray(img, np.float32)
    out = {
        "scene": C.scene_to_numpy(jscene),
        "origin": np.asarray(rays.origin, np.float32),
        "direction": np.asarray(rays.direction, np.float32),
        "rng_in": np.asarray(rng),
        "light_idx": np.asarray(scene_light_indices(jscene), np.int32),
        "wts": wts,
        "image": img,
        "mse_loss": np.float32(np.mean((img - NEE_GRAD_TARGET) ** 2)),
    }
    for prefix, (g_params, g_o, g_d) in zip(("", "mse_"), pullbacks):
        for field, g in zip(JG.SceneParams._fields, g_params):
            out[f"{prefix}d_{field}"] = np.asarray(g, np.float32)
        out[f"{prefix}d_origin"] = np.asarray(g_o, np.float32)
        out[f"{prefix}d_direction"] = np.asarray(g_d, np.float32)
    return out


def nee_grad_golden_arrays(traces):
    """Flatten {case: jax_nee_grad_trace(case)} for NEE_GRAD_GOLDEN_CASES into
    the NEE gradient golden file's arrays: inputs, `wts` and the gradients
    of sum(image * wts)."""
    out = {}
    for case in NEE_GRAD_GOLDEN_CASES:
        t = traces[case]
        for k, v in t["scene"].items():
            out[f"{case}__scene__{k}"] = v
        for k, v in t.items():
            if k in ("origin", "direction", "rng_in", "light_idx", "wts") or k.startswith("d_"):
                out[f"{case}__{k}"] = v
        out[f"{case}__config"] = np.array([NEE_GRAD_SPP, NEE_GRAD_BOUNCES], np.int32)
    return out


SPLIT_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "torch_port_split_golden.npz")
SPLIT_W, SPLIT_H = 128, 8
# name -> (scene, spp, bounces, stack depth, accumulator seed); the glass
# scene is benchmarks/suite.py config 3's (tests/test_pallas_split.py's),
# seen from the origin as there; "mixed" has all four kinds and no glass.
SPLIT_CASES = {"glass": ("glass", 2, 4, 2, 61), "glass_deep": ("glass", 1, 8, 4, 62),
               "mixed": ("mixed", 2, 5, 2, 63)}


def jax_split_scene(name):
    """(scene, camera) of the JAX package for a splitting case."""
    if name == "mixed":
        return jax_scene("mixed")
    import test_pallas_split as T

    return T.glass_scene(), JaxCamera.create([0.0] * 3, [0.0] * 3, 90.0)


def jax_split_trace(case):
    """A splitting case's inputs and the JAX package's Pallas splitting
    kernel's outputs (interpret mode)."""
    from haskell_path_tracer_tpu.ops.pallas_split import trace_split_pallas

    scene_name, spp, bounces, stack_depth, seed = SPLIT_CASES[case]
    jscene, jcam = jax_split_scene(scene_name)
    rays = jax_primary_rays(jcam, SPLIT_W, SPLIT_H)
    rng = J.make_accumulator(SPLIT_W, SPLIT_H, seed=seed).rng
    radiance, rng_out = trace_split_pallas(jscene, rays, rng, num_bounces=bounces, spp=spp,
                                           stack_depth=stack_depth, interpret=True)
    return {
        "scene": C.scene_to_numpy(jscene),
        "origin": np.asarray(rays.origin, np.float32),
        "direction": np.asarray(rays.direction, np.float32),
        "rng_in": np.asarray(rng),
        "radiance": np.asarray(radiance, np.float32),
        "rng_out": np.asarray(rng_out),
        "config": np.array([spp, bounces, stack_depth], np.int32),
    }


def split_golden_arrays(traces):
    """Flatten {case: jax_split_trace(case)} into the split golden file's
    arrays."""
    out = {}
    for case, t in traces.items():
        for k, v in t["scene"].items():
            out[f"{case}__scene__{k}"] = v
        for k in ("origin", "direction", "rng_in", "radiance", "rng_out", "config"):
            out[f"{case}__{k}"] = t[k]
    return out


def lane_agreement(rng_a, rng_b, color_a, color_b):
    """(share of lanes whose rng words all agree, share of color values
    isclose at rtol = atol = 1e-4, the same share among the values that
    are lit in `color_b`): tests/test_pallas.py's tolerance, and the last
    number says that it was not met by zeros alone."""
    rng_match = (np.asarray(rng_a) == np.asarray(rng_b)).all(axis=-1).mean()
    close = np.isclose(
        np.asarray(color_a), np.asarray(color_b), rtol=1e-4, atol=1e-4
    )
    lit = np.asarray(color_b) != 0
    return float(rng_match), float(close.mean()), float(close[lit].mean())


if __name__ == "__main__":
    import sys

    nee_grad = {NEE_GRAD_GOLDEN_PATH: lambda: nee_grad_golden_arrays(
        {c: jax_nee_grad_trace(c) for c in NEE_GRAD_GOLDEN_CASES})}
    split = {SPLIT_GOLDEN_PATH: lambda: split_golden_arrays(
        {c: jax_split_trace(c) for c in SPLIT_CASES})}
    files = {NEE_GOLDEN_PATH: lambda: nee_golden_arrays({c: jax_nee_trace(c) for c in NEE_CASES})}
    if sys.argv[1:] == ["nee_grad"]:
        files = nee_grad
    elif sys.argv[1:] == ["split"]:
        files = split
    elif sys.argv[1:] != ["nee"]:
        files.update(nee_grad)
        files.update(split)
        files[GOLDEN_PATH] = lambda: golden_arrays(
            {c: jax_trace(c) for c in GOLDEN_CASES},
            {c: jax_grad_trace(c) for c in GRAD_CASES},
        )
    for path, arrays in files.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
