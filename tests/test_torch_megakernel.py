"""The megakernel's plain PyTorch version against the JAX package's Pallas
kernel (`trace_inline_pallas` in interpret mode, as tests/test_pallas.py
runs it), and the golden file that `chip_smoke.py` holds the CUDA kernel
against.

Tolerance (tests/test_pallas.py): at least 99.5% of lanes have equal rng
words and at least 99% of color values are isclose at rtol = atol = 1e-4;
a transcendental's last bit can flip a discrete bounce decision in rare
lanes.
"""

import numpy as np
import pytest
import torch

from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy, scene_from_numpy
from haskell_path_tracer_torch.ops import megakernel as MK
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils.config import RenderConfig

from torch_port_fixtures import (
    CASES,
    GOLDEN_CASES,
    GOLDEN_PATH,
    GRAD_CASES,
    H,
    W,
    golden_arrays,
    jax_grad_trace,
    jax_trace,
    lane_agreement,
    torch_rays,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def traces():
    return {case: jax_trace(case) for case in CASES}


def _reference(inp, **kw):
    args = dict(
        num_bounces=inp["bounces"], spp=inp["spp"],
        russian_roulette=inp["russian_roulette"],
    )
    args.update(kw)
    return MK.trace_inline_fused_reference(
        scene_from_numpy(inp["scene"], "cpu"), torch_rays(inp),
        rng_from_numpy(inp["rng_in"], "cpu"), **args,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_pallas_interpret(traces, case):
    inp = traces[case]
    radiance, rng = _reference(inp)
    assert radiance.shape == (H, W, 3) and rng.dtype == torch.int32
    rng_match, close, lit_close = lane_agreement(
        rng_to_numpy(rng), inp["rng_out"], radiance.numpy(), inp["radiance"]
    )
    assert rng_match >= 0.995, rng_match
    assert close >= 0.99 and lit_close >= 0.99, (close, lit_close)
    assert np.isfinite(radiance.numpy()).all()
    # The case does work: most lanes draw, and some pick up emission.
    assert (rng_to_numpy(rng) != inp["rng_in"]).all(-1).mean() > 0.5
    assert (radiance.numpy() != 0).any()


def test_glass_case_takes_the_glass_block(traces):
    inp = traces["glass"]
    with_glass, _ = _reference(inp, has_dielectric=True)
    without, _ = _reference(inp, has_dielectric=False)
    assert not torch.equal(with_glass, without)


@pytest.mark.parametrize("case", ["main", "mixed"])
def test_dielectric_elision_is_bit_identical(traces, case):
    inp = traces[case]
    a = _reference(inp, has_dielectric=True)
    b = _reference(inp, has_dielectric=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_golden_file_is_current(traces):
    """Regenerated from the JAX package, the golden file is unchanged: the
    forward cases and the gradient cases."""
    want = golden_arrays(traces, {case: jax_grad_trace(case) for case in GRAD_CASES})
    with np.load(GOLDEN_PATH) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_reference_matches_golden_file(case):
    with np.load(GOLDEN_PATH) as z:
        inp = {
            "scene": {
                k.split("__", 2)[2]: z[k] for k in z.files if k.startswith(f"{case}__scene__")
            },
            **{k: z[f"{case}__{k}"] for k in ("origin", "direction", "rng_in", "radiance", "rng_out")},
        }
        spp, bounces, rr = z[f"{case}__config"].tolist()
    inp.update(spp=spp, bounces=bounces, russian_roulette=bool(rr))
    radiance, rng = _reference(inp)
    rng_match, close, lit_close = lane_agreement(
        rng_to_numpy(rng), inp["rng_out"], radiance.numpy(), inp["radiance"]
    )
    assert rng_match >= 0.995 and close >= 0.99 and lit_close >= 0.99, (
        rng_match, close, lit_close,
    )


def test_fused_on_cpu_runs_the_reference_and_never_launches(traces):
    inp = traces["main"]
    MK.LAUNCHES = 0
    got = MK.trace_inline_fused(
        scene_from_numpy(inp["scene"], "cpu"), torch_rays(inp),
        rng_from_numpy(inp["rng_in"], "cpu"), num_bounces=inp["bounces"], spp=inp["spp"],
    )
    want = _reference(inp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert MK.LAUNCHES == 0


def test_cuda_kernel_choice_on_cpu_raises():
    renderer = Renderer(RenderConfig(width=8, height=4, kernel="cuda", device="cpu"))
    from haskell_path_tracer_torch.models import world

    acc = renderer.init_accumulator(seed=0)
    with pytest.raises(ValueError, match="kernel='cuda' needs CUDA tensors"):
        renderer.step(world.main_scene("cpu"), world.initial_camera("cpu"), acc, spp=1)
    assert MK.LAUNCHES == 0


def test_kernel_source_and_build_flags():
    """The build targets sm_90a, keeps FMA contraction off and fast math out
    (the parity choice written in the kernel's source note)."""
    flags = " ".join(MK.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags
    src = open(MK.SOURCE).read()
    assert 'extern "C" int hpt_megakernel_launch' in src
    assert MK.library_path().startswith(MK.BUILD_DIR)
    # The NEE library (kernels #3 and #4): same flags, its two entry
    # points, and the f32 constants of the plain version in its header.
    from haskell_path_tracer_torch.ops import nee as NE
    from haskell_path_tracer_torch.render import nee as RN

    src = open(NE.SOURCE).read()
    assert 'extern "C" int hpt_nee_launch' in src and 'extern "C" int hpt_probe_launch' in src
    assert NE.library_path().startswith(MK.BUILD_DIR)
    header = open(NE.HEADERS[0]).read()
    assert "kMinD2 = 0x1.0c6f7cp-16f" in header and float.fromhex("0x1.0c6f7cp-16") == RN.MIN_D2
    assert "kTwoPi = 6.28318548f" in header and np.float32(6.28318548) == np.float32(RN.TWO_PI)
