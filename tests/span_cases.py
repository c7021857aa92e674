"""The port's launch spans on the card, shared by `test_torch_spans.py` and
`chip_smoke.py` (which runs it there: pytest cannot start on a machine
without JAX).  Imports torch and the port only."""

import torch
from torch.profiler import ProfilerActivity, profile

from haskell_path_tracer_torch import initial_camera, loss_and_grad, scene_to_params
from haskell_path_tracer_torch.models import scenes
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops.rng import gen_seeds

# The spans a presorted NEE batch and a physical NEE gradient open.
NEE_SPANS = ("hpt.camera.rays", "hpt.nee.tables", "hpt.nee.presort", "hpt.launch.probe",
             "hpt.launch.nee", "hpt.grad.forward", "hpt.grad.backward",
             "hpt.launch.nee_backward")


def launch_spans(device) -> dict:
    """Under the profiler (CPU and CUDA): `trace_physical_nee` presorted and
    `loss_and_grad(estimator="physical")` on the card, 64x48, 2 spp, 3
    bounces.  Returns {"cpu": [(name, start ns, end ns)] of the "hpt."
    spans on the host, "device": the names of device events that start
    with "hpt." (the profiler's mirrors of user-scoped spans)}."""
    scene = scenes.cornell_scene(device)
    camera = initial_camera(device)
    w, h = 64, 48
    rng = gen_seeds((h, w), 3, device)
    light_idx = NE.scene_light_indices(scene)
    target = torch.full((h, w, 3), 0.2, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        NE.trace_physical_nee(scene, primary_rays(camera, w, h), rng, 3, 2,
                              light_idx=light_idx, presort=True)
        loss_and_grad(scene_to_params(scene), scene, camera, target, rng, num_bounces=3,
                      spp=2, estimator="physical", light_idx=light_idx)
        torch.cuda.synchronize(device)
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hpt."):
            if str(e.device_type()).endswith("CPU"):
                cpu.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
            else:
                dev.append(e.name())
    return {"cpu": cpu, "device": dev}


def check_launch_spans(device) -> dict:
    """`launch_spans`, held to NEE_SPANS: each opened, none mirrored on the
    device, and the backward's launch inside `hpt.grad.backward` (it runs
    on the autograd engine's device thread).  Returns the span counts."""
    got = launch_spans(device)
    names = [n for n, _, _ in got["cpu"]]
    missing = [n for n in NEE_SPANS if n not in names]
    if missing:
        raise AssertionError(f"spans not recorded: {missing}")
    if got["device"]:
        raise AssertionError(f"spans mirrored on the device: {sorted(set(got['device']))}")
    (_, b0, b1), = [s for s in got["cpu"] if s[0] == "hpt.grad.backward"]
    inside = [s for s in got["cpu"] if s[0] == "hpt.launch.nee_backward" and b0 <= s[1] <= s[2] <= b1]
    if len(inside) != 1:
        raise AssertionError("hpt.launch.nee_backward is not inside hpt.grad.backward")
    return {n: names.count(n) for n in sorted(set(names))}
