"""One run of one cell: set-up, the measured window, the traced reading, the
check against the reference, and the result's line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel is found by name:
  * the cell's configuration: the file that BENCHMARK.json names;
  * its traffic: ptbench/traffic/<traffic>.json, whose "kind" names the
    loop, ptbench/loops/<kind>.py;
  * its limits: ptbench/checks/<workload>.json;
  * its per-layer metrics: ptbench/metrics/<metric>.py, each a `read`
    over the traced run's `trace.Record`;
  * its kernels' work: ptbench/work/<kernel>.py, listed per loop kind in
    the configuration's "kernels".
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import time

import numpy as np
import torch

from . import scenes, trace
from .loops import common
from .reference import core as C
from .work import WorkInputs

HERE = os.path.dirname(os.path.abspath(__file__))
# Seconds after which a traced run's window ends, at the first unit that
# completes after them; the whole of that window is traced.
TRACED_S = 10.0
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> tuple:
    """(workload entry, configuration, traffic, limits) of a cell."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    wl = found[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", wl["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "checks", workload + ".json"))
    return wl, config, traffic, limits


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "ptbench_metric_" + name.replace(".", "_"), os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def context(bench: dict, workload: str, seed: int, trace_on: bool, device,
            overrides: dict | None = None) -> common.Context:
    wl, config, traffic, limits = cell(bench, workload)
    for key, value in (overrides or {}).items():
        part, _, field = key.partition(".")
        {"config": config, "traffic": traffic}[part][field] = value
    return common.Context(config=config, traffic=traffic, limits=limits,
                          seed=seed, device=torch.device(device), trace=trace_on,
                          arrays=scenes.build(config["scene"]))


def work_inputs(ctx: common.Context) -> WorkInputs:
    """The cell's inputs that the work counts read: the benchmark's own
    primary-hit pass over every pixel (the reference's fold)."""
    scene = C.scene_from_arrays(ctx.arrays, ctx.device)
    o, d = common.reference_rays(ctx)
    t, prim = C.nearest(o, d, scene, 0.0)
    hit = t < C.INFINITE
    n_spheres = scene["sphere_pos"].shape[0]
    kinds = torch.cat([scene["sphere_kind"], scene["plane_kind"]])
    kind = (prim[hit] >= n_spheres).long()
    brdf = kinds[prim[hit]].long()
    mix = torch.bincount(kind * 3 + brdf, minlength=6).tolist()
    return WorkInputs(counts=(n_spheres, scene["plane_pos"].shape[0]),
                      lights=len(C.light_indices(scene)), pixels=int(t.numel()),
                      hits=int(hit.sum().item()), spp=ctx.traffic["spp"],
                      hit_mix={(k // 3, k % 3): n for k, n in enumerate(mix) if n})


def sync(ctx: common.Context) -> None:
    C.device_sync(ctx.device)


def window(ctx: common.Context, loop, seconds: float, prof=None) -> tuple:
    """The measured window: units until the first that completes after
    `seconds`.  With a profiler the window ends at the first unit that
    completes after min(TRACED_S, seconds): a traced line reports only the
    per-layer metrics, which need a few units, and the trace of a whole
    window of small steps takes minutes to read.  Returns (units, window
    seconds)."""
    units = []
    limit = min(seconds, TRACED_S) if prof is not None else seconds
    with contextlib.ExitStack() as tracing:
        if prof is not None:
            tracing.enter_context(ctx.span(trace.WINDOW))
        t0 = time.perf_counter()
        while True:
            with ctx.span(trace.UNIT):
                start = time.perf_counter()
                rec = loop.unit(ctx, len(units))
                rec["latency_s"] = time.perf_counter() - start
            units.append(rec)
            if time.perf_counter() - t0 >= limit:
                break
        window_s = time.perf_counter() - t0
        if prof is not None:
            tracing.close()
            sync(ctx)
            prof.stop()
    return units, window_s


def run(bench: dict, workload: str, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, overrides: dict | None = None, control_dtype=None, details: bool = False,
        during=None) -> dict:
    """One run of the cell; returns the result's line as a dict.  With
    `control_dtype` the line also holds the control's numbers: the
    reference in that precision put in the program's place; with `details`
    the loop's per-leaf readings of the check, where it has them.
    `during`, a context manager, is entered once set-up is done and left
    once the units that the check reads have all run (`faults.planted`,
    to plant a fault in the timed path alone)."""
    ctx = context(bench, workload, seed, trace_on, device, overrides)
    loop = importlib.import_module(f"ptbench.loops.{ctx.traffic['kind']}")
    loop.setup(ctx)
    sync(ctx)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace_on:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    with during or contextlib.nullcontext():
        units, window_s = window(ctx, loop, seconds, prof)
        if hasattr(loop, "finish"):
            # Units the check reads that a short window did not reach; they
            # run after the window and count in no metric.
            loop.finish(ctx)
        sync(ctx)
    measured = loop.end_to_end(ctx, units, window_s)
    measured["setup_s"] = (setup_s, "s")
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}

    metrics, extra = {}, {}
    if trace_on:
        window_ns, spans, device_events = trace.collect(prof)
        del prof
        rec = trace.Record(window=window_ns, spans=spans, device=device_events,
                           units=len(units),
                           kernels=ctx.config["kernels"].get(ctx.traffic["kind"], []),
                           work=work_inputs(ctx))
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = metric_reader(m["name"]).read(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=rec.busy_s(), window_s=rec.window_s)
        extra["breakdown"] = trace.breakdown(rec)
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload) and m["name"] in measured:
                value, unit = measured[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}

    loop.release(ctx)
    common.free_device_memory(ctx)
    t_check = time.perf_counter()
    numbers = loop.check(ctx)
    check_s = time.perf_counter() - t_check
    checks = {name: {"value": value, "limit": ctx.limits[name]["limit"]}
              for name, value in numbers}
    if details and hasattr(loop, "details"):
        extra["details"] = loop.details(ctx)
    if control_dtype is not None:
        extra["control"] = dict(loop.control(ctx, control_dtype))
    failed = sum(bool(u["failed"]) for u in units)
    correct = failed == 0 and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    line = {"correct": bool(correct), "attempted": len(units), "failed": failed,
            "metrics": metrics,
            "device": dev}
    line.update(extra)
    lat = sorted(u["latency_s"] for u in units)
    line["unit_s"] = {"min": lat[0], "median": lat[len(lat) // 2], "max": lat[-1]}
    line["check_s"] = check_s
    line["checks"] = checks
    return line
