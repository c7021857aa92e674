"""The plain reference of a progressive frame and of an SGD step.

A progressive frame (`frame_lanes`) follows the program's Renderer
schedule (haskell_path_tracer_torch/render/renderer.py at commit
46789026a883eb6678717df1b19ed41c83f8556b: one sample per step below 100
samples, then batches of max(30, samples // 50), a reseed from
`seed + samples` whenever a multiple of the reseed interval is crossed),
each batch's radiance summed and added to the pixel's colour, for a set of
pixels.

An SGD step (`loss_and_grad`) is the mean squared error of the mean of
`spp` samples against a target, differentiated with respect to every
continuous leaf, as the program's `diff/grad.py:loss_and_grad` defines it
(decisions carry no gradient).  It runs in two passes: a deciding pass,
sample after sample, that gives the image, each sample's starting rng and
the words of its decisions; then a replaying pass under autograd over
blocks of (sample, pixel) lanes, each lane weighted by the loss's
derivative with respect to its pixel, which no fold runs in.

The estimator's sample is found by name: ptbench/reference/<estimator>.py,
with `primary(scene, o, d)` (what the deciding pass needs before the first
sample) and `trace(scene, o, d, rng, bounces, kinds, first, words)`.
Imports torch, numpy and this package only.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from . import core as C

# Lanes per block of the replaying pass.
REPLAY_LANES = 1 << 20


def batch_size(iterations: int) -> int:
    return 1 if iterations < 100 else max(30, iterations // 50)


def schedule(total_spp: int) -> list:
    """The samples of each step of a progressive frame."""
    out, done = [], 0
    while done < total_spp:
        n = min(batch_size(done), total_spp - done)
        out.append(n)
        done += n
    return out


def sampler(estimator: str):
    """The reference module of `estimator`."""
    return importlib.import_module(f".{estimator}", __package__)


def frame_lanes(estimator: str, scene, o, d, seeds, pixels, shape, total_spp: int,
                bounces: int, reseed_interval: int, dtype=torch.float32):
    """(colour [K, 3], rng [K, 4], iterations) of K pixels, each after a
    progressive frame of `total_spp` samples: lane k is flat pixel
    `pixels[k]` of a frame seeded with `seeds[k]`, its primary ray
    (`o`, `d` [K, 3])."""
    device = o.device
    seeds, pixels = np.asarray(seeds, dtype=object), np.asarray(pixels)

    def states(offset):
        out = np.empty((len(pixels), 4), np.int32)
        for s in set(seeds.tolist()):
            lanes = np.nonzero(seeds == s)[0]
            out[lanes] = C.seed_states(shape, s + offset, pixels[lanes])
        return torch.as_tensor(out, device=device)

    mod = sampler(estimator)
    kinds = C.present_kinds(scene)
    scene = C.cast_scene(scene, dtype)
    o, d = o.to(dtype), d.to(dtype)
    first = mod.primary(scene, o, d)
    rng = states(0)
    colour = torch.zeros_like(o)
    done = 0
    with torch.no_grad():
        for n in schedule(total_spp):
            batch = torch.zeros_like(o)
            for _ in range(n):
                radiance, rng = mod.trace(scene, o, d, rng, bounces, kinds, first)[:2]
                batch = batch + radiance
            colour = colour + batch
            prev, done = done, done + n
            if prev // reseed_interval != done // reseed_interval:
                rng = states(done)
    return colour, rng, done


def render_sum(estimator: str, scene, o, d, rng, spp: int, bounces: int, record: bool = False,
               dtype=torch.float32):
    """The radiance summed over `spp` samples of rays [N, 3] from the rng
    [N, 4]; with `record` also each sample's starting rng [spp, N, 4] and
    its words [spp, bounces, N]."""
    mod = sampler(estimator)
    kinds = C.present_kinds(scene)
    scene = C.cast_scene(scene, dtype)
    o, d = o.to(dtype), d.to(dtype)
    first = mod.primary(scene, o, d)
    total = torch.zeros_like(o)
    starts, words = [], []
    with torch.no_grad():
        for _ in range(spp):
            if record:
                starts.append(rng)
            radiance, rng, w, _ = mod.trace(scene, o, d, rng, bounces, kinds, first)
            if record:
                words.append(w)
            total = total + radiance
    if record:
        return total, torch.stack(starts), torch.stack(words)
    return total


def loss_and_grad(estimator: str, leaves: dict, kinds: dict, o, d, rng, target, spp: int,
                  bounces: int, dtype=torch.float32):
    """(loss, {leaf: gradient}) of the mean squared error between the mean of
    `spp` samples and `target` [H, W, 3]; rays [H, W, 3], rng [H, W, 4]."""
    o, d = o.reshape(-1, 3).to(dtype), d.reshape(-1, 3).to(dtype)
    flat_target = target.reshape(-1, 3).to(dtype)
    n = o.shape[0]
    plain = {k: v.detach().to(dtype) for k, v in leaves.items()}
    scene = C.scene_of_params(plain, kinds)
    total, starts, words = render_sum(estimator, scene, o, d, rng.reshape(-1, 4), spp, bounces,
                                      record=True, dtype=dtype)
    img = total / spp
    loss = ((img - flat_target) ** 2).mean()
    # d loss / d (one sample's radiance) of each pixel.
    weight = 2.0 * (img - flat_target) / float(img.numel()) / float(spp)
    mod = sampler(estimator)
    scene_kinds = C.present_kinds(scene)
    grads = {k: torch.zeros_like(v) for k, v in plain.items()}
    for lo in range(0, spp * n, REPLAY_LANES):
        lanes = torch.arange(lo, min(lo + REPLAY_LANES, spp * n), device=o.device)
        s, p = lanes // n, lanes % n
        with torch.enable_grad():
            req = {k: v.clone().requires_grad_() for k, v in plain.items()}
            sc = C.scene_of_params(req, kinds)
            radiance, _ = mod.trace(sc, o[p], d[p], starts[s, p], bounces, scene_kinds,
                                    words=words[s, :, p].transpose(0, 1))
            part = torch.autograd.grad((radiance * weight[p]).sum(), list(req.values()),
                                       allow_unused=True)
        for k, g in zip(req, part):
            if g is not None:
                grads[k] += g
    return loss, grads


def sgd_rates(leaves: dict, grads: dict, fraction: float) -> dict:
    """One step size per leaf, set from the first gradient so that the
    leaf's root-mean-square gradient element moves it by `fraction` of its
    scale (max |p| + 1e-3), after `chip_smoke.py:sgd_rates` (commit
    46789026a883), which normalises by the largest element: one element at
    a knife edge sets that, the mean square is steady.  A leaf whose
    gradient norm is under a thousandth of the median leaf's, nought but
    for rounding, gets 0.  One step size for all leaves,
    `chip_smoke.py:sgd_lr`, moves the leaves whose gradient is small by
    less than their float32 rounding, or, set the other way, flings the
    others out of the scene."""
    norms = {k: g.double().norm().item() for k, g in grads.items() if g.numel()}
    median = float(np.median(list(norms.values())))
    rates = {}
    for k, g in grads.items():
        norm = norms.get(k, 0.0)
        moving = norm > 0 and norm >= 1e-3 * median
        rates[k] = (fraction * (leaves[k].abs().max().item() + 1e-3) * g.numel() ** 0.5 / norm
                    if moving else 0.0)
    return rates


def sgd(leaves: dict, grads: dict, rates: dict) -> dict:
    return {k: v - rates[k] * grads[k] for k, v in leaves.items()}
