"""haskell_path_tracer_torch — the path tracer on PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper.

The port of ``haskell_path_tracer_tpu`` (JAX, Pallas on TPU), module for
module.  The inline parity renderer runs end to end: scene and camera,
SFC32 per-pixel RNG, primary rays, nearest hit, the reference BRDFs, the
inline integrator, the progressive `Renderer`, checkpoints and the CLI.
On a CUDA device the whole sample x bounce loop is one launch of the
megakernel in ``csrc/megakernel.cu``; on the CPU the same functions run
as plain tensor ops.  This package imports neither JAX nor the JAX package.
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
from .render.renderer import Renderer
from .utils.config import RenderConfig

__version__ = "0.1.0"
