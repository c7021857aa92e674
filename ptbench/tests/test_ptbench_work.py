"""The work counts against hand counts, and the trace reader's arithmetic on
synthetic events."""

import pytest

from ptbench import trace
from ptbench.work import WorkInputs, nee_kernel, nee_probe, nee_record, nee_resid_backward
from ptbench.work import parity_record, parity_sample_backward, peaks

# Two spheres and a plane, one emitter; 4 pixels, 3 of them hit (two on a
# matte sphere, one on a glossy plane); 2 samples per pixel.
INP = WorkInputs(counts=(2, 1), lights=1, pixels=4, hits=3, spp=2,
                 hit_mix={(0, 0): 2, (1, 1): 1})
# fold 4*2 + 8*1 = 16 floats, payload 12*3 = 36, lights 16: 68 floats.
TABLES = 4 * 68


def test_nee_kernel_hand_count():
    per_bounce = 2 * 31 + 1 * 20 + 38 + 77
    ops, nbytes = nee_kernel.work(INP, launches=3)
    assert ops == 2 * 3 * per_bounce
    assert nbytes == 3 * (4 * 68 + TABLES)


def test_nee_record_and_backward_hand_count():
    ops, nbytes = nee_record.work(INP, launches=1)
    assert ops == 2 * 3 * (2 * 31 + 20 + 38 + 77)
    assert nbytes == 4 * 68 + TABLES + 4 * 2 * 3
    ops, nbytes = nee_resid_backward.work(INP, launches=1)
    assert ops == 2 * 3 * (416 + 38)
    assert nbytes == 4 * 76 + 2 * TABLES + 4 * 2 * 3


def test_probe_hand_count():
    ops, nbytes = nee_probe.work(INP, launches=2)
    assert ops == 2 * 4 * (2 * 19 + 14)
    assert nbytes == 2 * (4 * 32 + 4 * 16)


def test_parity_hand_count():
    ops, nbytes = parity_record.work(INP, launches=1)
    shade = 2 * (44 + 13 + 70) + 1 * (44 + 0 + 84)
    assert ops == 4 * (2 * 20 + 14) + 2 * shade
    assert nbytes == 4 * 68 + 4 * (16 + 36 + 16) + 16 * 4 * 2
    ops, nbytes = parity_sample_backward.work(INP, launches=1)
    assert ops == 2 * (2 * (69 + 87 + 67) + 1 * (69 + 205 + 47))
    assert nbytes == 4 * 76 + 2 * 4 * (16 + 36 + 16) + 16 * 4 * 2


def test_bound_takes_the_larger():
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12) == pytest.approx(1.0)


def record(device, units=2, kernels=("nee_kernel",)):
    return trace.Record(window=(0, 1000), spans=[(trace.WINDOW, 0, 1000),
                                                 ("ptbench.render", 0, 400),
                                                 ("ptbench.image", 400, 1000)],
                        device=device, units=units, kernels=list(kernels), work=INP)


def test_busy_is_the_union_and_gaps_are_named():
    rec = record([("a", 100, 300), ("b", 200, 400), ("Memcpy DtoH", 600, 700)])
    assert rec.busy_s() == pytest.approx(400e-9)
    assert len(rec.kernel_events()) == 2
    gaps = trace.breakdown(rec)["idle_gaps"]
    assert gaps[0] == ["ptbench.image", pytest.approx(300e-9)]
    assert sorted(g[1] for g in gaps) == pytest.approx([100e-9, 200e-9, 300e-9])


def test_roofline_and_mfu_from_matched_kernels():
    name = "void (anonymous namespace)::nee_kernel<false, false, false>(nee::Scene, bool)"
    rec = record([(name, 0, 500), ("other", 500, 600)])
    ops, nbytes = nee_kernel.work(INP, 0.5)
    want = 100 * peaks.bound_s(2 * nbytes, 2 * ops) / 500e-9
    assert trace.roofline_pct(rec) == pytest.approx(want)
    assert trace.step_mfu_pct(rec) == pytest.approx(100 * 2 * ops / (1e-6 * 67e12))


def test_no_matching_kernel_reads_nothing():
    rec = record([("void nee_kernel<false, false, true>(x)", 0, 500)])
    assert trace.roofline_pct(rec) is None
    assert trace.step_mfu_pct(rec) is None
