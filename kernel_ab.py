"""A/B timing of the splitting kernel (csrc/split.cu) and of the primary-hit
probe (csrc/nee_megakernel.cu) on one CUDA GPU.

    python3 kernel_ab.py [--kernels split,probe] [--reps N] [--out FILE] TREE [TREE ...]

Each TREE is a checkout of this repository (for an earlier commit, unpack
its `git archive` into a directory that .gitignore lists, such as
`_archive/`).  TREE:VARIANT takes that checkout's package with one of the
source edits in VARIANTS applied to a copy of its csrc/.  Every
tree runs in a process of its own (its package, its build), in turns:
the trees in order, then in reverse, N times (2: A B C C B A ...), and
each run reports, on CUDA events after a warm-up:

  * split: the kernel's launch function at suite config 3 (glass, 512x512
    / 64 spp / 8 bounces, 2 stack slots) and at the CLI shape (800x600 /
    15 / 1, 2 slots) on the glass and the reference scenes, median of n
    calls;
  * probe: `launch_probe` on config 4's scene (1000 spheres) at 800x600
    and 1920x1088, and on 20000 spheres at 320x180, median of n calls;
  * a digest of each output (radiance and rng; t0 and prim0), held equal
    to the first tree's: every variant must give the first tree's bits;
  * the registers, stack bytes and resident warps per SM of the instance
    each launch takes: through split.cu's resource query, which an older
    source without one gets appended to its copy, and `ops/nee.py:
    kernel_resources(probe=True)`;
  * with the probe, ptxas's registers, stack and spills of every kernel in
    the probe's library and in the sphere folds' (which share its
    sources), with the names of those that differ from the first tree's.

Each tree's first run also reports the warp efficiency of the splitting
kernel's nested and flat step loop at both glass shapes, from its plain
version's per-sample step counts (`trace_split_reference(telemetry=True)`
and `chip_smoke.py:split_warp_efficiency`, where the tree has them).  The
card's name and power limit are printed first; the record goes to FILE
(_archive/kernel_ab.json) and its summary to standard output.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# Source edits of csrc/, by name: (file, old, new) triples, each old text
# of which must occur in its file.
VARIANTS = {
    "no_one_sample": [("split.cu", "constexpr int kOneSampleBlocks = 6;",
                       "constexpr int kOneSampleBlocks = 0;")],
    "probe_r2": [("nee_megakernel.cu", "constexpr int kProbeRays = 1;",
                  "constexpr int kProbeRays = 2;")],
    "probe_r4": [("nee_megakernel.cu", "constexpr int kProbeRays = 1;",
                  "constexpr int kProbeRays = 4;")],
    "probe_r2_12": [("nee_megakernel.cu", "constexpr int kProbeRays = 1;",
                     "constexpr int kProbeRays = 2;"),
                    ("nee_megakernel.cu", "constexpr int kProbeMinBlocks = 4;",
                     "constexpr int kProbeMinBlocks = 12;")],
    "probe_256": [("nee_megakernel.cu", "constexpr int kProbeThreads = 128;",
                   "constexpr int kProbeThreads = 256;")],
}
# The resource query appended to a split.cu that has none (its kernel
# split_kernel<CAP, IN_SMEM> one thread per pixel, kThreads per block).
RESOURCE_QUERY = r'''
extern "C" int hpt_split_resources(int gcols, int num_primitives, int stack_depth, int spp,
                                   int* out, const char** name) {
  const size_t bytes = sizeof(float) * (size_t)num_primitives * (gcols + 8);
  const bool s = bytes <= hpt::smem_optin_bytes();
  const int cap = hpt::stack_capacity(stack_depth);
  const void* k =
      cap == 1 ? (s ? (const void*)split_kernel<1, true> : (const void*)split_kernel<1, false>)
      : cap == 2 ? (s ? (const void*)split_kernel<2, true> : (const void*)split_kernel<2, false>)
      : cap == 4 ? (s ? (const void*)split_kernel<4, true> : (const void*)split_kernel<4, false>)
      : (s ? (const void*)split_kernel<0, true> : (const void*)split_kernel<0, false>);
  *name = "split_kernel";
  hpt::kernel_resources(k, kThreads, s ? bytes : 0, out);
  return (int)cudaGetLastError();
}
'''
CONFIG3 = (512, 512, 64, 8, 2)
CLI = (800, 600, 1, 15, 2)
ORIGIN_POSE = ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
CAM4_POSE = ([0.0, 2.0, 0.0], [0.2, 0.0, 0.0])  # suite config 4's camera
# The probe's shapes: (spheres, width, height, calls timed).
PROBE_SHAPES = {"probe_800x600_big1000": (1000, 800, 600, 50),
                "probe_1920x1088_big1000": (1000, 1920, 1088, 20),
                "probe_320x180_big20000": (20000, 320, 180, 20)}


def prepare(spec: str, scratch: str) -> tuple:
    """(label, package parent directory) of TREE or TREE:VARIANT."""
    tree, _, variant = spec.partition(":")
    tree = os.path.abspath(tree)
    csrc = os.path.join(tree, "haskell_path_tracer_torch", "csrc")
    edits = list(VARIANTS[variant]) if variant else []
    src = open(os.path.join(csrc, "split.cu")).read()
    if "hpt_split_resources" not in src:
        edits.append(("split.cu", src, src + RESOURCE_QUERY))
    if not edits:
        return spec, tree
    dest = os.path.join(scratch, f"{os.path.basename(tree)}_{variant or 'query'}")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "haskell_path_tracer_torch"),
                    os.path.join(dest, "haskell_path_tracer_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new in edits:
        path = os.path.join(dest, "haskell_path_tracer_torch", "csrc", name)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"{spec}: the edit's text is not in {name}: {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return spec, dest


def cuda_times(fn, reps: int) -> dict:
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in events)
    return {"n": reps, "median_ms": statistics.median(ms), "min_ms": ms[0], "max_ms": ms[-1]}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def split_runs(dev, efficiency: bool) -> dict:
    from haskell_path_tracer_torch.models import scenes as SC
    from haskell_path_tracer_torch.models import world
    from haskell_path_tracer_torch.models.camera import primary_rays
    from haskell_path_tracer_torch.models.objects import Camera
    from haskell_path_tracer_torch.ops import megakernel as MK
    from haskell_path_tracer_torch.ops import split as SP
    from haskell_path_tracer_torch.ops.rng import gen_seeds

    lib = SP._library()
    origin = Camera.create(*ORIGIN_POSE, 90.0, dev)
    glass = SC.suite_glass_scene(dev)
    out = {}
    for name, scene, cam, (w, h, spp, b, sd), reps in (
            ("config3_glass", glass, origin, CONFIG3, 10),
            ("cli_glass", glass, origin, CLI, 50),
            ("cli_reference", world.main_scene(dev), world.initial_camera(dev), CLI, 50)):
        tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
        rays, rng = primary_rays(cam, w, h), gen_seeds((h, w), 0, dev)
        got = SP.launch_split(*tables, rays, rng, b, spp, sd)
        rec = {"kernel": cuda_times(lambda: SP.launch_split(*tables, rays, rng, b, spp, sd), reps),
               "digest": digest(*got), "mean": got[0].mean().item()}
        query = getattr(lib, "hpt_split_resources")
        query.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        rec["resources"] = MK.resources(query, tables[0].shape[1], sum(tables[2]), sd, spp)
        if efficiency and name != "cli_reference":
            plain = SP.trace_split_reference(scene, rays, rng, b, spp, sd, telemetry=True)
            if len(plain) == 4:
                from chip_smoke import split_warp_efficiency

                rec["warp_efficiency"] = split_warp_efficiency(plain[3])
        out[name] = rec
    return out


def probe_ptxas() -> dict:
    """ptxas's report of every kernel that shares the probe's sources (the
    NEE kernel's instances, the sphere folds), by mangled name with the
    translation unit's hash taken out, so that two trees' names match."""
    from haskell_path_tracer_torch.ops import megakernel as MK
    from haskell_path_tracer_torch.ops import nee as NE
    from haskell_path_tracer_torch.ops import sphere_fold as SF

    return {re.sub(r"_(?:GLOBAL__N_|INTERNAL)_+[0-9a-f]+_\d+_", "_", fn): rep
            for lib in (NE.build(), SF.build()) for fn, rep in MK.ptxas_report(lib).items()}


def probe_runs(dev) -> dict:
    from haskell_path_tracer_torch.models import scenes as SC
    from haskell_path_tracer_torch.models.camera import primary_rays
    from haskell_path_tracer_torch.models.objects import Camera
    from haskell_path_tracer_torch.ops import nee as NE

    cam = Camera.create(*CAM4_POSE, 90.0, dev)
    out = {}
    for name, (spheres, w, h, reps) in PROBE_SHAPES.items():
        tables = NE.nee_scene_tables(SC.big_scene(dev, spheres))
        rays = primary_rays(cam, w, h)
        got = NE.launch_probe(tables, rays)
        out[name] = {
            "kernel": cuda_times(lambda: NE.launch_probe(tables, rays), reps),
            "digest": digest(*got), "hits": int((got[1] != 0).sum()),
            "resources": NE.kernel_resources(tables, probe=True)}
    return out


def worker(label: str, tree: str, kernels: list, efficiency: bool) -> dict:
    sys.path.insert(0, tree)
    import torch

    dev = torch.device("cuda", 0)
    out = {"label": label, "tree": tree, "shapes": {}}
    if "split" in kernels:
        out["shapes"].update(split_runs(dev, efficiency))
    if "probe" in kernels:
        out["shapes"].update(probe_runs(dev))
        out["ptxas"] = probe_ptxas()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--kernels", default="split,probe", help="comma-separated: split, probe")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "_archive", "kernel_ab.json"))
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= {"split", "probe"}:
        ap.error(f"--kernels: unknown {set(kernels) - {'split', 'probe'}}")
    if args.worker:
        label, tree, eff = args.worker
        print(json.dumps(worker(label, tree, kernels, eff == "1")))
        return 0
    import torch

    if not torch.cuda.is_available() or not args.trees:
        print("kernel_ab: needs a CUDA GPU and at least one tree", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    scratch = os.path.join(ROOT, "_archive", "kernel_ab")
    trees = [prepare(spec, scratch) for spec in args.trees]
    order = [t for r in range(args.reps) for t in (trees if r % 2 == 0 else trees[::-1])]
    runs = []
    for k, (label, tree) in enumerate(order):
        first_of_tree = (label, tree) not in order[:k]
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernels", args.kernels,
                               "--worker", label, tree, "1" if first_of_tree else "0"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{label}: the run failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first = runs[0]["shapes"]
    for r in runs:
        for s, rec in r["shapes"].items():
            rec["bits_equal_first"] = rec["digest"] == first[s]["digest"]
            print(json.dumps({"tree": r["label"], "shape": s, "median_ms": rec["kernel"]["median_ms"],
                              "bits_equal_first": rec["bits_equal_first"],
                              **{k: rec["resources"][k] for k in ("instance", "registers", "stack_bytes",
                                                                   "warps_per_sm")}}))
    for r in runs:
        if "ptxas" in r:
            names = set(r["ptxas"]) | set(runs[0]["ptxas"])
            print(json.dumps({"tree": r["label"], "ptxas_entries": len(r["ptxas"]),
                              "ptxas_differs_from_first": sorted(
                                  n for n in names if r["ptxas"].get(n) != runs[0]["ptxas"].get(n))}))
    for r in runs:
        for s, rec in r["shapes"].items():
            if "warp_efficiency" in rec:
                print(json.dumps({"tree": r["label"], "shape": s, "warp_efficiency": rec["warp_efficiency"]}))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    bad = [(r["label"], s) for r in runs for s, rec in r["shapes"].items() if not rec["bits_equal_first"]]
    if bad:
        print(f"kernel_ab: outputs differ from the first tree's: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
