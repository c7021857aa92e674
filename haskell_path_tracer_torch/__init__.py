"""haskell_path_tracer_torch — the path tracer on PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper.

The port of ``haskell_path_tracer_tpu`` (JAX, Pallas on TPU), module for
module.  The inline parity renderer runs end to end: scene and camera,
SFC32 per-pixel RNG, primary rays, nearest hit, the reference BRDFs, the
inline integrator, the progressive `Renderer`, checkpoints and the CLI.
On a CUDA device the whole sample x bounce loop is one launch of the
megakernel in ``csrc/megakernel.cu``; on the CPU the same functions run
as plain tensor ops.  Inverse rendering (`loss_and_grad` of `image_loss`
over `SceneParams`) differentiates the same trace, on a CUDA device through
the backward megakernel in ``csrc/megakernel_vjp.cu``.  The physical/NEE
estimator (`render_batch_physical`, `Renderer(algorithm="physical")`) runs
on a CUDA device as one launch of the NEE megakernel in
``csrc/nee_megakernel.cu``; its gradient (`loss_and_grad(...,
estimator="physical", light_idx=...)`) through that kernel and the NEE
backward megakernel in ``csrc/nee_megakernel_vjp.cu``, or, without an
emitter tuple, through the dual-fold kernel in ``csrc/sphere_fold.cu``.
The wavefront integrator (`render_batch_wavefront`,
`Renderer(algorithm="wavefront")`) runs the same bounce over a queue of
lanes; with deterministic dielectric splitting (`render_batch_split_auto`,
`split=True`) a CUDA device runs it as one launch of the splitting kernel
in ``csrc/split.cu``.  This package imports neither JAX nor the JAX
package.
"""

from .models.objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Accumulator,
    Boxes,
    Camera,
    Materials,
    Planes,
    Rays,
    Scene,
    Spheres,
    Triangles,
    make_boxes,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)
from .models.world import initial_camera, main_scene
from .models.io import load_scene, save_scene
from .models.camera import primary_rays
from .render.integrator import (
    make_accumulator,
    render_batch_auto,
    render_batch_fused,
    render_batch_inline,
    render_sample_inline,
    trace_inline,
)
from .render.wavefront import (
    WavefrontStats,
    depth_histogram,
    render_batch_split_auto,
    render_batch_wavefront,
    render_batch_wavefront_split,
    render_sample_wavefront,
    render_sample_wavefront_split,
)
from .render.nee import render_batch_physical, render_sample_physical, trace_physical
from .ops.nee import primary_probe, scene_light_indices
from .ops.nee_vjp import trace_physical_nee_diff
from .ops.sphere_fold import sphere_dual_query
from .render.renderer import Renderer
from .diff.grad import (
    SceneParams,
    image_loss,
    loss_and_grad,
    params_to_scene,
    render_radiance,
    scene_to_params,
)
from .utils.config import RenderConfig

__version__ = "0.1.0"
