"""The harness on the CPU at tiny sizes: every cell runs and comes out
correct, the control and the planted faults come out not correct, the line
has its schema, the measurement path refuses to run without a card,
nothing loads JAX or the JAX package, the reference loads nothing of the
program, and a cell, a mix and a metric are added by files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from ptbench import faults, harness
from ptbench.loops import common

from helpers import CELLS, MEASURED, ROOT, bench, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def limits_failed(line, numbers):
    return [k for k, v in numbers.items() if not v <= line["checks"][k]["limit"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_and_its_line_has_the_schema(workload):
    line = run_tiny(workload)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    b = bench()
    names = [m["name"] for m in b["end_to_end"]
             if "workloads" not in m or workload in m["workloads"]]
    assert sorted(line["metrics"]) == sorted(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.dumps(line)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line(workload):
    line = run_tiny(workload, trace=True)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    wanted = {m["name"] for m in bench()["per_layer"] if workload in m["workloads"]}
    # No device on the CPU: only the host spans and the counts read.
    assert set(line["metrics"]) <= wanted
    assert any(n.startswith("host_ms_per_") for n in line["metrics"])
    for key in ("device_ops", "idle_gaps"):
        assert len(line["breakdown"][key]) <= 10


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails(workload):
    line = run_tiny(workload, seed=11, control_dtype=torch.bfloat16)
    assert line["correct"] is True
    assert limits_failed(line, line["control"])


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_is_not_correct(workload, fault):
    """The fault is planted once set-up is done: the window alone carries it."""
    kind = "frames" if workload.endswith(".render") else "sgd"
    line = run_tiny(workload, during=faults.planted(kind, fault))
    assert line["correct"] is False, line["checks"]


def test_no_card_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "ptbench/run.py", "--workload", "big1000_nee.render",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "ptbench"), tmp_path / "ptbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "ptbench/run.py", "--workload", "big1000_nee.render",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


IMPORT_CHECK = textwrap.dedent("""
    import sys, json, time
    sys.path.insert(0, {root!r})
    import ptbench.reference.core, ptbench.reference.physical, ptbench.reference.parity
    import ptbench.reference.progressive
    reference_only = sorted({{m.split('.')[0] for m in sys.modules}})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(2)
    from helpers import run_tiny
    run_tiny("big1000_nee.train", trace=True)
    run_tiny("big1000_nee.render")
    print(json.dumps([reference_only, sorted({{m.split('.')[0] for m in sys.modules}})]))
""")


def test_nothing_loads_jax_and_the_reference_loads_no_program():
    code = IMPORT_CHECK.format(root=ROOT, tests=os.path.dirname(__file__))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    reference_only, everything = json.loads(proc.stdout.strip().splitlines()[-1])
    forbidden = {"jax", "jaxlib", "flax", "haskell_path_tracer_tpu"}
    assert not forbidden & set(everything)
    assert "haskell_path_tracer_torch" in everything
    assert "haskell_path_tracer_torch" not in reference_only
    # Nor do the sources name the JAX package or `benchmarks/`.
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ptbench")):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_"):
                text = open(os.path.join(dirpath, f)).read()
                assert not re.search(r"^\s*(import|from)\s+(jax|haskell_path_tracer_tpu|benchmarks)\b",
                                     text, re.M), f


NEW_METRIC = textwrap.dedent('''
    """Frames per window, a count."""
    LAYER = "device"
    MOVES = "render_paths_per_s"


    def read(rec):
        return float(rec.units)
''')


def test_cell_mix_and_metric_are_added_by_files(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell, its limits
    and a per-layer metric as new files and BENCHMARK.json entries; the
    harness finds them by name and no file that was there changes."""
    shutil.copytree(os.path.join(ROOT, "ptbench"), tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench(with_parity=False)
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "ptbench").rglob("*.*"))}
    pb = tmp_path / "ptbench"
    cfg = json.load(open(pb / "configs" / "reference_parity.json"))
    cfg.update(name="glass_world", width=20, height=12, bounces=5)
    cfg["scene"]["spheres"][2]["brdf"] = "dielectric"
    cfg["scene"]["spheres"][2]["param"] = 1.5
    cfg["kernels"] = {"frames": ["nee_kernel"]}
    cfg.update(estimator="physical", algorithm="physical", light_idx=True)
    (pb / "configs" / "glass_world.json").write_text(json.dumps(cfg))
    mix = {"kind": "frames", "spp": 3, "reseed_interval": 2, "candidate_pixels": 100,
           "checked_pixels": 20, "why": "a test mix"}
    (pb / "traffic" / "frames_3spp.json").write_text(json.dumps(mix))
    limits = json.load(open(pb / "checks" / "big1000_nee.render.json"))
    (pb / "checks" / "glass_world.render.json").write_text(json.dumps(limits))
    (pb / "metrics" / "frames_in_window.render.py").write_text(NEW_METRIC)
    b["configs"].append({"name": "glass_world", "source": "a test",
                         "file": "ptbench/configs/glass_world.json", "reduced": [],
                         "why": "a test configuration"})
    b["workloads"].append({"name": "glass_world.render", "config": "glass_world",
                           "traffic": "frames_3spp", "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "frames_in_window.render", "unit": "frames",
                           "better": "higher", "source": "program_counter", "layer": "device",
                           "moves": "render_paths_per_s", "workloads": ["glass_world.render"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if m.get("workloads") and "big1000_nee.render" in m["workloads"]:
            m["workloads"].append("glass_world.render")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = textwrap.dedent(f"""
        import sys, json, time
        sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]
        import torch
        torch.set_num_threads(2)
        from ptbench import faults, harness
        assert harness.HERE.startswith({str(tmp_path)!r})
        b = harness.load_json({str(tmp_path / "BENCHMARK.json")!r})
        out = [harness.run(b, "glass_world.render", 5, 0.1, t, "cpu", time.perf_counter())
               for t in (False, True)]
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["correct"] and "render_paths_per_s" in plain["metrics"]
    assert traced["metrics"]["frames_in_window.render"]["value"] >= 1
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


def test_benchmark_json_keeps_the_contract():
    b = bench(with_parity=False)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["ptbench"] and all(PATH.match(p) for p in b["paths"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    # A full check of 24 cells: 2 + 14 per cell runs of run_seconds + 60 s,
    # 2 x 90 s per cell to compile, 1200 s spare.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith("ptbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "ptbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "ptbench", "checks", w["name"] + ".json"))
        reported = [m for m in b["end_to_end"] if "workloads" not in m
                    or w["name"] in m["workloads"]]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        reader = harness.metric_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_seeds_derive_apart_and_large_seeds_work():
    a = common.derive(2**31 + 5, "frame", 0)
    assert a != common.derive(2**31 + 5, "frame", 1) != common.derive(2**31 + 6, "frame", 0)
    assert 0 <= a < 2**63 and a == common.derive(2**31 + 5, "frame", 0)


@pytest.mark.chip
@pytest.mark.parametrize("workload", MEASURED)
def test_cell_on_the_card(card, workload):
    """On the card: one short run of the cell through `run.py`."""
    proc = subprocess.run([sys.executable, "ptbench/run.py", "--workload", workload, "--seed",
                           str(2**31 + 3), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
