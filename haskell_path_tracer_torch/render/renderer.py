"""The progressive renderer, with the reference's schedule.

Counterpart of ``haskell_path_tracer_tpu/render/renderer.py`` for the
inline, wavefront and physical algorithms: one sample per step for the first 100
iterations, then batches of max(30, iterations / 50); every
`reseed_interval` samples the per-pixel RNGs are reseeded.  PyTorch runs
eagerly, so there is no compile boundary; a step's kernels run
asynchronously on the accumulator's device, but on a CUDA device the step
waits for the one before it (`Renderer.step`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..models.objects import Accumulator, Camera, Scene
from ..ops import rng as rng_ops
from ..utils.config import RenderConfig
from ..utils.metrics import span
from . import integrator, nee, wavefront


def resolve_device(name: str) -> torch.device:
    """The torch device for `name`; a CUDA device without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA GPU is available")
    return device


class Renderer:
    """Progressive path tracer bound to a (resolution, algorithm, bounces,
    device) configuration.

    `algorithm="wavefront"` renders the wavefront integrator
    (`render/wavefront.py:render_batch_wavefront`), with `split` the
    deterministic-splitting one (`render_batch_split_auto`, honouring
    `kernel`: the CUDA kernel on a CUDA device under "auto").
    `algorithm="physical"` renders the physical/NEE estimator
    (`render/nee.py:render_batch_physical`; `nee` and `kernel` as there),
    with `sampler="threefry"` on stateless per-batch streams
    (`render_batch_physical_stateless`).
    Its BRDF kinds and emitters are read from a scene once, when `step`
    first sees that scene object: a scene changed in place needs a new
    Scene object to be read again."""

    def __init__(self, config: RenderConfig):
        self.config = config
        self._physical = config.algorithm == "physical"
        if self._physical:
            if config.sampler not in ("sfc32", "threefry"):
                raise ValueError(f"unknown sampler {config.sampler!r}")
            batch = (nee.render_batch_physical_stateless if config.sampler == "threefry"
                     else nee.render_batch_physical)
            self._step = partial(
                batch, num_bounces=config.bounces, nee=config.nee, kernel=config.kernel,
            )
            # The BRDF kinds and the emitters, read on the host once per
            # scene object (a read from a CUDA device waits for it).
            self._scene_facts = (None, None, None)
        elif config.algorithm == "inline":
            step_fn = {
                "auto": integrator.render_batch_auto,
                "torch": integrator.render_batch_inline,
                "cuda": integrator.render_batch_fused,
            }[config.kernel]
            self._step = partial(
                step_fn,
                num_bounces=config.bounces,
                russian_roulette=config.russian_roulette,
            )
        elif config.algorithm == "wavefront":
            if config.split:
                self._step = partial(
                    wavefront.render_batch_split_auto, num_bounces=config.bounces,
                    queue_factor=config.queue_factor, kernel=config.kernel,
                )
            else:
                self._step = partial(
                    wavefront.render_batch_wavefront, num_bounces=config.bounces,
                    russian_roulette=config.russian_roulette,
                )
        else:
            raise ValueError(f"unknown algorithm {config.algorithm!r}")
        self.device = resolve_device(config.device)
        self._fused = config.algorithm == "inline" and config.kernel in ("auto", "cuda")

    def init_accumulator(self, seed: Optional[int] = None) -> Accumulator:
        return integrator.make_accumulator(
            self.config.width, self.config.height, seed, self.device
        )

    def step(self, scene: Scene, camera: Camera, acc: Accumulator, spp: int = 1):
        """Render `spp` more samples into the accumulator, in span
        "hpt.render.step".  On a CUDA device the step blocks before its
        launches: `primary_rays` uploads host scalars (span
        "hpt.camera.rays"), each a pageable copy that waits for the work
        queued before it, so the step starts its kernel only once the step
        before it has finished, and the device idles while the host
        finishes the rays, packs the tables (span "hpt.nee.tables") and
        launches."""
        with span("hpt.render.step"):
            if self.config.kernel == "cuda" and not acc.color.is_cuda:
                raise ValueError(
                    "kernel='cuda' needs CUDA tensors; the accumulator is on "
                    f"{acc.color.device}"
                )
            if self._physical:
                if self._scene_facts[0] is not scene:
                    self._scene_facts = (
                        scene, nee._present_kinds(scene), nee.nee_ops.scene_light_indices(scene)
                    )
                _, kinds, light_idx = self._scene_facts
                return self._step(scene, camera, acc, spp, kinds=kinds, light_idx=light_idx)
            if self._fused:
                # Glass-free scenes skip the kernel's glass block.
                return self._step(
                    scene, camera, acc, spp, has_dielectric=scene.has_dielectric()
                )
            return self._step(scene, camera, acc, spp)

    def batch_size(self, iterations: int) -> int:
        """Single samples for the first 100 iterations, then batches of
        max(30, iterations // 50)."""
        if iterations < 100:
            return 1
        return max(30, iterations // 50)

    def should_reseed(self, prev_iters: int, new_iters: int) -> bool:
        k = self.config.reseed_interval
        return (prev_iters // k) != (new_iters // k)

    def reseed(self, acc: Accumulator, seed: Optional[int] = None) -> Accumulator:
        return rng_ops.reseed(
            (self.config.height, self.config.width), acc, seed=seed
        )

    def render(
        self,
        scene: Scene,
        camera: Camera,
        total_spp: int,
        seed: Optional[int] = None,
        progress: bool = False,
    ) -> Accumulator:
        """Render `total_spp` samples with the batching and reseeding
        schedule, returning the final accumulator.  The accumulator's rng
        states are made on the host first (span "hpt.rng.seed"), then each
        step runs in span "hpt.render.step"."""
        acc = self.init_accumulator(seed=seed)
        done = 0
        while done < total_spp:
            n = min(self.batch_size(done), total_spp - done)
            prev = done
            acc = self.step(scene, camera, acc, spp=n)
            done += n
            if self.should_reseed(prev, done):
                acc = self.reseed(acc, seed=None if seed is None else seed + done)
            if progress:
                print(f"  {done}/{total_spp} spp", flush=True)
        return acc

    def image(self, acc: Accumulator) -> np.ndarray:
        """Normalized (divided-by-iterations) image on the host."""
        return acc.image.cpu().numpy()

    def wavefront_stats(self, scene: Scene, camera: Camera, acc: Accumulator):
        """One probe sample's wavefront telemetry, the accumulator left as
        it is: {"occupancy", "depth_histogram", "capacity"} as lists and an
        int, from the tensor loop (with splitting, its segments per depth).
        None for the other algorithms."""
        if self.config.algorithm != "wavefront":
            return None
        if self.config.split:
            _, stats = wavefront.render_sample_wavefront_split(
                scene, camera, acc, num_bounces=self.config.bounces,
                queue_factor=self.config.queue_factor, return_stats=True,
            )
        else:
            _, stats = wavefront.render_sample_wavefront(
                scene, camera, acc, num_bounces=self.config.bounces,
                russian_roulette=self.config.russian_roulette, return_stats=True,
            )
        return {
            "occupancy": stats.occupancy.tolist(),
            "depth_histogram": wavefront.depth_histogram(stats).tolist(),
            "capacity": int(stats.capacity),
        }
