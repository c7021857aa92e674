"""Who takes a tie's gradient: a witness on suite config 8's scene, on the CPU.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/nee_tie_witness.py [W H SPP BOUNCES]

benchmarks/suite.py's config 8 has two coplanar emitter triangles that
overlap, so a ray that meets the overlap meets both at the same t.  The
gradient of sum(radiance * wts) (default 48x32 / 2 spp / 3 bounces, the
initial camera) is computed four ways:

  * jax_pallas: the JAX package's NEE backward kernel
    (`trace_physical_nee_pallas_diff`, interpret mode);
  * jax_xla: `jax.vjp` of its XLA estimator (`trace_physical(fused=False)`);
  * port_kernel: the port's NEE backward kernel's code (`csrc/nee_vjp.cuh`)
    compiled for the host with g++ through tests/nee_adjoint_host.cpp, its
    table cotangents mapped to the scene's leaves (`table_grads_to_leaves`);
  * port_plain: the port's plain backward (`ops/nee_vjp.py:
    backward_reference`, autograd of the plain trace).

It prints one JSON line per pair with the normalised error max|a - b| /
max|b| of every SceneParams field: (port_kernel, jax_pallas) and
(port_plain, jax_xla) hold the port to the JAX package's two routes,
(jax_pallas, jax_xla) and (port_kernel, port_plain) show each package's
kernel parting from its plain version.  Takes a few minutes: JAX compiles
the Pallas backward in interpret mode.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import haskell_path_tracer_tpu as J  # noqa: E402
from haskell_path_tracer_tpu.diff import grad as JG  # noqa: E402
from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays  # noqa: E402
from haskell_path_tracer_tpu.models.objects import Rays as JaxRays  # noqa: E402
from haskell_path_tracer_tpu.ops.pallas_nee import scene_light_indices  # noqa: E402
from haskell_path_tracer_tpu.ops.pallas_nee_vjp import trace_physical_nee_pallas_diff  # noqa: E402
from haskell_path_tracer_tpu.render.nee import trace_physical  # noqa: E402

from haskell_path_tracer_torch.models import convert as C  # noqa: E402
from haskell_path_tracer_torch.models.objects import Rays  # noqa: E402
from haskell_path_tracer_torch.ops import megakernel as MK  # noqa: E402
from haskell_path_tracer_torch.ops import nee as NE  # noqa: E402
from haskell_path_tracer_torch.ops import nee_vjp as NV  # noqa: E402
from haskell_path_tracer_torch.render.nee import _present_kinds  # noqa: E402
from test_torch_nee_render import _suite_config  # noqa: E402
from torch_port_fixtures import torch_scene  # noqa: E402

SEED = 8


def host_kernel_grads(scene, rays, rng, wts, bounces, spp):
    """The kernel's per-pixel backward, compiled for the host, summed over
    the image and mapped to the scene's leaves."""
    cxx = shutil.which("g++") or shutil.which("c++")
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libnee_adjoint_host.so")
        subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                        "-I", MK.CSRC, "-o", lib_path, os.path.join(HERE, "nee_adjoint_host.cpp")],
                       check=True)
        lib = ctypes.CDLL(lib_path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hpt_nee_backward_host.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i,
                                          vp, vp, vp, vp, i, i, vp, vp, vp, vp, vp]
    lib.hpt_nee_backward_host.restype = i
    tables = NE.nee_scene_tables(scene)
    kinds = _present_kinds(scene)
    h, w = rng.shape[:2]
    got = [torch.zeros_like(tables.fold), torch.zeros_like(tables.payload),
           torch.zeros_like(tables.lights), torch.zeros(h, w, 3), torch.zeros(h, w, 3)]
    err = lib.hpt_nee_backward_host(
        tables.fold.data_ptr(), tables.payload.data_ptr(), tables.lights.data_ptr(), *tables.counts,
        tables.num_lights, int(1 in kinds), int(2 in kinds), h * w, rays.origin.data_ptr(),
        rays.direction.data_ptr(), rng.data_ptr(), wts.data_ptr(), spp, bounces,
        *(x.data_ptr() for x in got))
    assert err == 0
    return NV.table_grads_to_leaves(scene, None, *got[:3])


def main(w=48, h=32, spp=2, bounces=3):
    jscene, _ = _suite_config(8)
    jcam = J.initial_camera()
    jrays = jax_primary_rays(jcam, w, h)
    jrng = J.make_accumulator(w, h, seed=SEED).rng
    wts = np.random.default_rng(SEED).normal(size=(h, w, 3)).astype(np.float32)
    light_idx = scene_light_indices(jscene)
    params = JG.scene_to_params(jscene)

    def xla(p):
        s = JG.params_to_scene(p, jscene)

        def body(rr, _):
            rad, rr = trace_physical(s, JaxRays(origin=jrays.origin, direction=jrays.direction), rr,
                                     bounces, nee=True, fused=False)
            return rr, rad

        _, rads = jax.lax.scan(body, jrng, None, length=spp)
        return jnp.sum(rads.sum(axis=0) * wts)

    def pallas(p):
        rad, _ = trace_physical_nee_pallas_diff(JG.params_to_scene(p, jscene), jrays, jrng,
                                                num_bounces=bounces, spp=spp, light_idx=light_idx,
                                                interpret=True)
        return jnp.sum(rad * wts)

    grads = {}
    for name, fn in (("jax_xla", xla), ("jax_pallas", pallas)):
        g = jax.jit(jax.grad(fn))(params)
        grads[name] = {f: np.asarray(x, np.float64) for f, x in zip(JG.SceneParams._fields, g)}

    scene = torch_scene(jscene)
    rays = Rays(origin=torch.as_tensor(np.asarray(jrays.origin, np.float32)),
                direction=torch.as_tensor(np.asarray(jrays.direction, np.float32)))
    rng = C.rng_from_numpy(np.asarray(jrng), "cpu")
    g_rad = torch.as_tensor(wts)
    plain, _, _ = NV.backward_reference(scene, rays, rng, g_rad, bounces, spp)
    kernel = host_kernel_grads(scene, rays, rng, g_rad, bounces, spp)
    grads["port_plain"] = {f: x.double().numpy() for f, x in plain.items()}
    grads["port_kernel"] = {f: x.double().numpy() for f, x in kernel.items()}

    print(json.dumps({"shape": f"{w}x{h} spp{spp} b{bounces}", "seed": SEED,
                      "scene": "benchmarks/suite.py config8", "light_idx": list(light_idx)}))
    for a, b in (("port_kernel", "jax_pallas"), ("port_plain", "jax_xla"),
                 ("jax_pallas", "jax_xla"), ("port_kernel", "port_plain")):
        errs = {f: float(np.abs(grads[a][f] - x).max() / max(np.abs(x).max(), 1e-6))
                for f, x in grads[b].items() if x.size and np.abs(x).max() > 0}
        print(json.dumps({"pair": [a, b], "max_field": max(errs, key=errs.get),
                          "normalised_error": errs}))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
