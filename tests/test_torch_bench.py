"""The port's headline benchmark (haskell_path_tracer_torch/bench.py) on
the CPU, at a tiny size: it runs the gradient path and prints bench.py's
line last."""

import json

import pytest
import torch

from haskell_path_tracer_torch import bench
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import megakernel_vjp as V

torch.set_num_threads(2)


def test_bench_prints_the_headline_line_last(capsys):
    MK.LAUNCHES = V.LAUNCHES = 0
    assert bench.main(["--device", "cpu", "--width", "8", "--height", "8", "--spp", "1",
                       "--bounces", "2", "--reps", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["device"] == "cpu"
    timing = json.loads(lines[-2])
    assert timing["n"] == 2 and timing["segments"] == 8 * 8 * 1 * 2
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "ray_segments_per_s_cpu_fwd+bwd_8x8x1sppx2b"
    assert last["unit"] == "rays/s" and last["value"] > 0
    assert last["vs_baseline"] == pytest.approx(last["value"] / 5.0e8)
    # The CPU runs the plain version: no kernel launched.
    assert MK.LAUNCHES == V.LAUNCHES == 0


def test_bench_needs_a_card_unless_told_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--width", "8", "--height", "8"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA GPU" in out.err


def test_bench_imports_no_jax():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(bench))
    names = [a.name for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names] + [n.module or "" for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not any("jax" in n or "haskell_path_tracer_tpu" in n for n in names)
