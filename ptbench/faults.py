"""Faults planted in the program's timed path, to show that the check sees
them (the tests, on the CPU) and to read them at a cell's own size
(`readings.py --faults`, on the card).

  * "unchanged": a step returns its state unchanged (a frame's step its
    accumulator; an SGD step a zero gradient, so the update moves nothing);
  * "half": half of the batch left out (a step leaves the lower half of the
    frame's rows as they were; the loss is the mean over the upper half of
    the rows alone);
  * "altered": an answer altered where it is produced (a step's colour,
    the loss, by 1%).
The cells run on one chip, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Within the block the program's path for loops of `kind` ("frames",
    "sgd") carries `fault`."""
    import haskell_path_tracer_torch as hpt
    from haskell_path_tracer_torch.models.objects import Accumulator
    from haskell_path_tracer_torch.render import renderer

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if kind == "frames":
        owner, name = renderer.Renderer, "step"
        step = renderer.Renderer.step

        def broken(self, scene, camera, acc, spp=1):
            out = step(self, scene, camera, acc, spp)
            if fault == "unchanged":
                return acc
            if fault == "half":
                h = out.color.shape[0] // 2
                color, rng = out.color.clone(), out.rng.clone()
                color[h:], rng[h:] = acc.color[h:], acc.rng[h:]
                return Accumulator(color=color, rng=rng, iterations=out.iterations)
            return Accumulator(color=out.color * 1.01, rng=out.rng, iterations=out.iterations)
    else:
        owner, name = hpt, "loss_and_grad"
        loss_and_grad = hpt.loss_and_grad

        def broken(params, scene, camera, target, rng, **kw):
            if fault == "half":
                # The lower rows' target is the render itself, so they add
                # nothing; the mean is then taken over the upper half.
                h = target.shape[0] // 2
                with torch.no_grad():
                    img = hpt.render_radiance(
                        hpt.params_to_scene(params, scene), camera, rng, target.shape[1],
                        target.shape[0], kw["num_bounces"], kw["spp"],
                        estimator=kw["estimator"], light_idx=kw.get("light_idx"))
                target = torch.cat([target[:h], img[h:]])
                loss, grads = loss_and_grad(params, scene, camera, target, rng, **kw)
                return loss * 2, type(grads)(*(g * 2 for g in grads))
            loss, grads = loss_and_grad(params, scene, camera, target, rng, **kw)
            if fault == "unchanged":
                return loss, type(grads)(*(torch.zeros_like(g) for g in grads))
            return loss * 1.01, grads
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, step if kind == "frames" else loss_and_grad)
