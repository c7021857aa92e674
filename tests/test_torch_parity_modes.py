"""The parity gradient's two modes and the tools around its kernels, on the
CPU: the plain version of what the recording forward writes (the rng at the
start of every sample), the byte budget that picks one thread per (pixel,
sample) or per pixel, the launchers' checks before any launch, and the
build log's ptxas report."""

import numpy as np
import pytest
import torch

from haskell_path_tracer_torch.models import world
from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.ops import megakernel_vjp as V
from haskell_path_tracer_torch.ops.rng import gen_seeds

torch.set_num_threads(2)


def _inputs(w=12, h=8):
    scene, cam = world.main_scene("cpu"), world.initial_camera("cpu")
    tables = (*MK.scene_tables(scene), MK.primitive_counts(scene))
    return tables, primary_rays(cam, w, h), gen_seeds((h, w), 4, "cpu")


def test_sample_states_are_the_rng_after_s_samples():
    tables, rays, rng = _inputs()
    states = MK.sample_states_reference(*tables, rays, rng, 5, 4, False)
    assert states.shape == (8, 12, 4, 4) and states.dtype == torch.int32
    assert torch.equal(states[:, :, 0], rng)
    for s in range(1, 4):
        _, after = MK.trace_tables_reference(*tables, rays, rng, 5, s, False, 3, False)
        assert torch.equal(states[:, :, s], after), s
    # The last state is where the trace's last sample began, not where it ended.
    _, end = MK.trace_tables_reference(*tables, rays, rng, 5, 4, False, 3, False)
    assert not torch.equal(states[:, :, 3], end)


GIB = 1 << 30


@pytest.mark.parametrize("h, w, spp, free_bytes, want", [
    # 16 B per pixel and sample: 268 MB at 512x512 / 64 spp, which takes
    # the per-sample mode while it is at most half the free memory.
    (512, 512, 64, 80 * GIB, True),
    (512, 512, 64, 2 * 16 * 512 * 512 * 64, True),
    (512, 512, 64, 2 * 16 * 512 * 512 * 64 - 1, False),
    (512, 512, 65, 2 * 16 * 512 * 512 * 64, False),
    # One sample takes one thread per pixel, whatever the memory.
    (512, 512, 1, 80 * GIB, False),
    (2160, 3840, 1, 80 * GIB, False),
    # 3840x2160 at 16 spp holds 1.98 GiB of states.
    (2160, 3840, 16, 3 * GIB, False),
    (2160, 3840, 16, 4 * GIB, True),
    (8, 12, 2, 0, False),
])
def test_the_free_memory_picks_the_mode(h, w, spp, free_bytes, want):
    rng = torch.zeros((h, w, 4), dtype=torch.int32)
    assert V.per_sample(rng, spp, free_bytes) is want


def test_launchers_refuse_before_launching():
    tables, rays, rng = _inputs()
    MK.LAUNCHES = MK.RECORD_LAUNCHES = V.LAUNCHES = V.SAMPLE_LAUNCHES = 0
    with pytest.raises(ValueError, match="without Russian roulette"):
        MK.launch_kernel(*tables, rays, rng, 4, 2, True, 3, False, record=True)
    g_rad = torch.zeros((8, 12, 3))
    bad = torch.zeros((8, 12, 3, 4), dtype=torch.int32)  # 3 samples recorded, 2 asked
    with pytest.raises(ValueError, match="rng_samples"):
        V.launch_backward(*tables, rays, rng, g_rad, 4, 2, False, bad)
    assert (MK.LAUNCHES, MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES) == (0, 0, 0, 0)


def test_gradient_on_the_cpu_runs_the_plain_version():
    """No mode, no launch: the CPU differentiates the plain trace."""
    tables, rays, rng = _inputs()
    scene = world.main_scene("cpu")
    MK.LAUNCHES = MK.RECORD_LAUNCHES = V.LAUNCHES = V.SAMPLE_LAUNCHES = 0
    got = V.trace_inline_fused_diff(scene, rays, rng, num_bounces=4, spp=3)
    want = MK.trace_tables_reference(*tables, rays, rng, 4, 3, False, 3, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (MK.LAUNCHES, MK.RECORD_LAUNCHES, V.LAUNCHES, V.SAMPLE_LAUNCHES) == (0, 0, 0, 0)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN1a10megakernelILb0ELb0ELb1ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN1a10megakernelILb0ELb0ELb1ELb0EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN1a14megakernel_vjpILb0ELb1ELb1ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN1a14megakernel_vjpILb0ELb1ELb1ELb1EEEvPKf
    944 bytes stack frame, 92 bytes spill stores, 84 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 448 bytes cmem[0]
"""


def test_ptxas_report_reads_the_build_log(tmp_path):
    lib = tmp_path / "libx.so"
    (tmp_path / "libx.so.log").write_text(PTXAS_LOG)
    rep = MK.ptxas_report(str(lib))
    assert rep["_ZN1a10megakernelILb0ELb0ELb1ELb0EEEvPKf"] == {
        "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0, "registers": 64}
    assert rep["_ZN1a14megakernel_vjpILb0ELb1ELb1ELb1EEEvPKf"] == {
        "stack_bytes": 944, "spill_stores": 92, "spill_loads": 84, "registers": 80}
    assert rep["__internal_trig_reduction_slowpathd"]["stack_bytes"] == 40


def test_build_flags_keep_the_ptxas_report():
    flags = " ".join(MK.NVCC_FLAGS)
    assert "-Xptxas -v" in flags and "-fmad=false" in flags and "fast_math" not in flags
