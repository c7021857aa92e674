"""The program's spans in the trace (`ptbench/spans.py`): the collector on
synthetic profiler events, the readings against hand counts, and one
traced run of each cell on the CPU at a tiny size."""

import importlib.util
import os

import pytest

from ptbench import spans, trace
from ptbench.work import WorkInputs

from helpers import bench, tiny

NEE = "void (anonymous namespace)::nee_kernel<false, false, false>(nee::Scene, bool)"


class Event:
    def __init__(self, name, device, start, end):
        self._name, self._device, self._start, self._end = name, device, start, end

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


class Profiler:
    """What `collect` reads of a `torch.profiler.profile`."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Inner", (), {"kineto_results": results})()


# One traced window of two frames: the benchmark's spans, a kernel, a copy,
# and the benchmark's mirror on the device's timeline.
BENCH_EVENTS = [
    Event("ptbench.traced", "CPU", 100, 1100),
    Event("ptbench.unit", "CPU", 100, 600), Event("ptbench.render", "CPU", 100, 550),
    Event("ptbench.unit", "CPU", 600, 1100), Event("ptbench.render", "CPU", 600, 1050),
    Event(NEE, "CUDA", 300, 500), Event(NEE, "CUDA", 800, 1000),
    Event("Memcpy DtoH (Device -> Pageable)", "CUDA", 1040, 1060),
    Event("ptbench.render", "CUDA", 300, 1000),
    Event("aten::add", "CPU", 120, 130),
]
# The program's spans inside them, and a mirror of one on the device.
PROGRAM_EVENTS = [
    Event("hpt.rng.seed", "CPU", 100, 250), Event("hpt.rng.seed", "CPU", 600, 780),
    Event("hpt.render.step", "CPU", 260, 540), Event("hpt.render.step", "CPU", 790, 1040),
    Event("hpt.camera.rays", "CPU", 270, 290), Event("hpt.nee.tables", "CPU", 280, 320),
    Event("hpt.launch.nee", "CPU", 330, 340),
    Event("hpt.render.step", "CUDA", 300, 500),
]


def record(events, collect=trace.collect, units=2, kernels=("nee_kernel",)):
    window, sp, device = collect(Profiler(events))
    work = WorkInputs(counts=(2, 1), lights=1, pixels=4, hits=3, spp=2,
                      hit_mix={(0, 0): 2, (1, 1): 1})
    return trace.Record(window=window, spans=sp, device=device, units=units,
                        kernels=list(kernels), work=work)


def metric_files():
    here = os.path.join(os.path.dirname(trace.__file__), "metrics")
    return sorted(f[:-3] for f in os.listdir(here) if f.endswith(".py"))


def test_collect_keeps_the_programs_spans_and_drops_their_mirrors():
    window, sp, device = spans.collect(Profiler(BENCH_EVENTS + PROGRAM_EVENTS))
    assert window == (100, 1100)
    names = [n for n, _, _ in sp]
    assert names.count("hpt.render.step") == 2 and "hpt.launch.nee" in names
    assert "aten::add" not in names
    assert [n for n, _, _ in device] == [NEE, NEE, "Memcpy DtoH (Device -> Pageable)"]
    # `trace.collect` alone keeps the mirror as device activity.
    assert "hpt.render.step" in [n for n, _, _ in trace.collect(Profiler(PROGRAM_EVENTS + BENCH_EVENTS))[2]]


@pytest.mark.parametrize("name", metric_files())
def test_accepted_metrics_read_the_same_with_the_programs_spans(name):
    from ptbench import harness

    read = harness.metric_reader(name).read
    without = record(BENCH_EVENTS)
    with_spans = record(BENCH_EVENTS + PROGRAM_EVENTS, spans.collect)
    assert read(with_spans) == read(without)


def test_readings_by_hand():
    rec = record(BENCH_EVENTS + PROGRAM_EVENTS, spans.collect)
    got = spans.readings(rec, "big1000_nee.render")
    assert set(got) == {n for n in spans.READINGS if n.endswith(".render")}
    # Seeding: 150 + 180 ns over 2 frames.
    assert got["seed_ms_per_frame.render"] == pytest.approx(330e-6 / 2)
    # Device busy 300-500, 800-1000, 1040-1060: idle 100-300, 500-800,
    # 1000-1040, 1060-1100 in a 1000 ns window.  Seeding holds 100-250 and
    # 600-780, both idle: 330 ns.
    assert got["seed_idle_pct.render"] == pytest.approx(33.0)
    # Steps 260-540 (idle 260-300, 500-540) and 790-1040 (idle 790-800,
    # 1000-1040).
    assert got["step_idle_pct.render"] == pytest.approx(13.0)
    # Rays 270-290 and tables 280-320 overlap: their union is 50 ns.
    assert got["pack_ms_per_frame.render"] == pytest.approx(50e-6 / 2)
    by_span = spans.host_by_span(rec)
    assert by_span["hpt.rng.seed"] == [2, pytest.approx(330e-9)]
    assert by_span["hpt.render.step"] == [2, pytest.approx(530e-9)]
    assert by_span["ptbench.unit"] == [2, pytest.approx(1000e-9)]
    assert list(by_span)[0] == "ptbench.unit" and "ptbench.traced" not in by_span


def test_train_readings_by_hand():
    events = [
        Event("ptbench.traced", "CPU", 0, 1000),
        Event("hpt.grad.forward", "CPU", 0, 300), Event("hpt.grad.backward", "CPU", 300, 450),
        Event("hpt.host_read", "CPU", 50, 60), Event("hpt.host_read", "CPU", 70, 80),
        Event("hpt.launch.nee_backward", "CPU", 350, 360),  # on another thread
        Event("hpt.grad.forward", "CPU", 500, 700), Event("hpt.grad.backward", "CPU", 700, 900),
        Event("hpt.host_read", "CPU", 510, 520), Event("hpt.host_read", "CPU", 530, 540),
        Event("k", "CUDA", 100, 250), Event("k", "CUDA", 520, 980),
    ]
    got = spans.readings(record(events, spans.collect), "big1000_nee.train")
    assert got == pytest.approx({
        "forward_ms_per_step.train": 500e-6 / 2,
        "backward_ms_per_step.train": 350e-6 / 2,
        # Idle 0-100, 250-520 (a gap partly inside the forwards), 980-1000.
        "forward_idle_pct.train": 100 * (100 + 50 + 20) / 1000,
        "host_reads_per_step.train": 2.0,
    })


def test_readings_without_the_programs_spans_are_none():
    rec = record(BENCH_EVENTS)
    assert all(v is None for v in spans.readings(rec, "big1000_nee.render").values())
    assert all(v is None for v in spans.readings(rec, "big1000_nee.train").values())


def test_breakdown_names_the_innermost_program_span():
    rec = record(BENCH_EVENTS + PROGRAM_EVENTS, spans.collect)
    gaps = [(round(t * 1e9), n) for n, t in trace.breakdown(rec)["idle_gaps"]]
    # 500-800: its middle, 650, is in the second frame's seeding, inside
    # ptbench.render; 100-300 in the first's; 1000-1040 in a step; 1060-1100
    # after the frame's render span.
    assert gaps == [(300, "hpt.rng.seed"), (200, "hpt.rng.seed"), (40, "hpt.render.step"),
                    (40, "ptbench.unit")]
    assert spans.idle_by_span(rec) == pytest.approx(
        {"hpt.rng.seed": 500e-9, "hpt.render.step": 40e-9, "ptbench.unit": 40e-9})
    # Without the program's spans the same gaps read as the benchmark's.
    assert {n for n, _ in trace.breakdown(record(BENCH_EVENTS))["idle_gaps"]} == {
        "ptbench.render", "ptbench.unit"}


@pytest.mark.parametrize("workload", ("big1000_nee.render", "big1000_nee.train"))
def test_traced_run_of_the_cell_reads_the_programs_spans(workload):
    line = spans.traced(bench(), workload, 2**31 + 11, 0.2, "cpu", tiny(workload))
    assert line["correct"] is True
    got = line["spans"]["readings"]
    # On the CPU the program packs no tables and runs no kernel: the
    # render's pack reading is the rays alone, and nothing runs on a device.
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert any(n.startswith("hpt.") for n in line["spans"]["idle_s_by_span"])
    assert any(g[0].startswith("hpt.") for g in line["breakdown"]["idle_gaps"])
    assert trace.collect is not spans.collect


def test_the_program_does_not_import_the_benchmark():
    spec = importlib.util.find_spec("haskell_path_tracer_torch")
    root = os.path.dirname(spec.origin)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "ptbench" not in fh.read(), os.path.join(dirpath, f)
