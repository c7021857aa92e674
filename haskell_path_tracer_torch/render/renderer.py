"""The progressive renderer, with the reference's schedule.

Counterpart of ``haskell_path_tracer_tpu/render/renderer.py`` for the
inline and physical algorithms: one sample per step for the first 100
iterations, then batches of max(30, iterations / 50); every
`reseed_interval` samples the per-pixel RNGs are reseeded.  PyTorch runs
eagerly, so there is no compile boundary; a step launches asynchronously on
the accumulator's device.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..models.objects import Accumulator, Camera, Scene
from ..ops import rng as rng_ops
from ..utils.config import RenderConfig
from . import integrator, nee


def resolve_device(name: str) -> torch.device:
    """The torch device for `name`; a CUDA device without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA GPU is available")
    return device


class Renderer:
    """Progressive path tracer bound to a (resolution, algorithm, bounces,
    device) configuration.

    `algorithm="physical"` renders the physical/NEE estimator
    (`render/nee.py:render_batch_physical`; `nee` and `kernel` as there).
    Its BRDF kinds and emitters are read from a scene once, when `step`
    first sees that scene object: a scene changed in place needs a new
    Scene object to be read again."""

    def __init__(self, config: RenderConfig):
        self.config = config
        self._physical = config.algorithm == "physical"
        if self._physical:
            if config.sampler != "sfc32":
                raise NotImplementedError(
                    f"sampler {config.sampler!r} (the stateless threefry sampler of "
                    "render_batch_physical_stateless) is not ported yet: ROADMAP "
                    "Queue A #8, its stateless item; use 'sfc32'"
                )
            self._step = partial(
                nee.render_batch_physical, num_bounces=config.bounces, nee=config.nee,
                kernel=config.kernel,
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
        else:
            raise NotImplementedError(
                f"algorithm {config.algorithm!r} is not ported yet (ROADMAP "
                "Queue A #10, wavefront); use 'inline' or 'physical'"
            )
        self.device = resolve_device(config.device)
        self._fused = config.kernel in ("auto", "cuda")

    def init_accumulator(self, seed: Optional[int] = None) -> Accumulator:
        return integrator.make_accumulator(
            self.config.width, self.config.height, seed, self.device
        )

    def step(self, scene: Scene, camera: Camera, acc: Accumulator, spp: int = 1):
        """Render `spp` more samples into the accumulator (asynchronous on
        a GPU)."""
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
        schedule, returning the final accumulator."""
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
