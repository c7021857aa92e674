"""The port's stateless physical sampler (`sampler="threefry"`) on the CPU
against the JAX package: `render/nee.py:stateless_states`,
`render_batch_physical_stateless` and `trace_physical_stateless`, the
Renderer and the CLI, and the golden file `chip_smoke.py` holds the CUDA
path to.

Tolerances: the derived SFC32 states and every threefry word bit-equal;
radiance under `assert_lane_parity` (tests/test_pallas_nee.py); replay
bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.models.camera import primary_rays as jax_primary_rays
from haskell_path_tracer_tpu.render import nee as jnee

from haskell_path_tracer_torch.models.camera import primary_rays
from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy
from haskell_path_tracer_torch.models.objects import Accumulator
from haskell_path_tracer_torch.ops import nee as NE
from haskell_path_tracer_torch.ops import threefry as T
from haskell_path_tracer_torch.render import integrator as tint
from haskell_path_tracer_torch.render import nee as tnee
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils.config import RenderConfig

from test_pallas_nee import assert_lane_parity
from torch_port_fixtures import (
    STATELESS_FOLD_DATA,
    STATELESS_GOLDEN_PATH,
    STATELESS_SEEDS,
    STATELESS_SHAPES,
    STATELESS_STATES,
    jax_nee_scene,
    stateless_golden_arrays,
    torch_camera,
    torch_scene,
)

torch.set_num_threads(2)
W, H, BOUNCES, SPP = 16, 12, 3, 2


def _accumulators(seed):
    """The same accumulator in both packages (numpy-seeded SFC32 states)."""
    jacc = J.make_accumulator(W, H, seed=seed)
    return jacc, Accumulator(color=torch.as_tensor(np.array(jacc.color)),
                             rng=rng_from_numpy(np.asarray(jacc.rng), "cpu"), iterations=0)


@pytest.mark.parametrize("case", list(STATELESS_STATES))
def test_derived_states_match_jax(case):
    """The states of (seed word, iterations) against the golden file's,
    which `test_stateless_golden_file_is_current` holds to `jax.random`;
    the word of case "a" is above 2^31, a negative int32 in the
    accumulator."""
    word, iterations, h, w = STATELESS_STATES[case]
    rng = torch.zeros((h, w, 4), dtype=torch.int32)
    rng[0, 0, 0] = int(np.array(word, np.uint32).view(np.int32))
    states = tnee.stateless_states(Accumulator(color=torch.zeros(h, w, 3), rng=rng,
                                               iterations=iterations))
    with np.load(STATELESS_GOLDEN_PATH) as z:
        assert (rng_to_numpy(states) == z[f"states__{case}"]).all()


def test_stateless_batch_matches_jax():
    """16x12 / 3 bounces / 2 spp on the reference scene: the derived states
    are the ones the JAX batch runs on, radiance under lane parity, the
    SFC32 state untouched."""
    jscene, jcam = J.main_scene(), J.initial_camera()
    jacc, acc = _accumulators(21)
    jacc = jacc.__class__(color=jacc.color, rng=jacc.rng, iterations=jnp.int32(5))
    acc = Accumulator(color=acc.color, rng=acc.rng, iterations=5)
    # The JAX batch is its stateful batch on the states the port derives
    # (both in one jitted function: one compile).
    states = tnee.stateless_states(acc)
    jout, jref = jax.jit(lambda a, st: (
        jnee.render_batch_physical_stateless(jscene, jcam, a, SPP, BOUNCES, fused=False),
        jnee.render_batch_physical(
            jscene, jcam, a.__class__(color=a.color, rng=st, iterations=a.iterations), SPP,
            BOUNCES, fused=False),
    ))(jacc, jnp.asarray(rng_to_numpy(states)))
    np.testing.assert_array_equal(np.asarray(jout.color), np.asarray(jref.color))

    out = tnee.render_batch_physical_stateless(torch_scene(jscene), torch_camera(jcam), acc, SPP,
                                               BOUNCES)
    assert out.iterations == 5 + SPP == int(jout.iterations)
    assert torch.equal(out.rng, acc.rng)
    np.testing.assert_array_equal(np.asarray(jout.rng), rng_to_numpy(acc.rng))
    # Lane parity on the radiance, and on the rng the batch ended with.
    plain = tnee.render_batch_physical(torch_scene(jscene), torch_camera(jcam),
                                       Accumulator(color=acc.color, rng=states, iterations=5),
                                       SPP, BOUNCES)
    assert torch.equal(plain.color, out.color)
    assert_lane_parity(np.asarray(jref.rng), rng_to_numpy(plain.rng), np.asarray(jout.color),
                       out.color.numpy())
    assert np.abs(np.asarray(jout.color)).max() > 0


def test_stateless_replay_and_fresh_streams():
    """The JAX package's tests/test_app.py checks through the port: a batch
    replays bit-exactly from (seed, iterations), another seed or the next
    batch draws another stream, and the SFC32 state rides along."""
    scene, cam = torch_scene(J.main_scene()), torch_camera(J.initial_camera())

    def batch(acc):
        return tnee.render_batch_physical_stateless(scene, cam, acc, SPP, BOUNCES)

    a = batch(tint.make_accumulator(W, H, 3, "cpu"))
    b = batch(tint.make_accumulator(W, H, 3, "cpu"))
    assert torch.equal(a.color, b.color)
    c = batch(tint.make_accumulator(W, H, 4, "cpu"))
    assert (a.color - c.color).abs().max() > 1e-6
    a2 = batch(a)
    d1, d2 = a.color, a2.color - a.color
    assert a2.iterations == 2 * SPP and torch.isfinite(d2).all()
    assert (d1 - d2).abs().max() > 1e-6
    assert torch.equal(a2.rng, tint.make_accumulator(W, H, 3, "cpu").rng)
    # kernel="cuda" refuses CPU tensors, as the stateful batch does.
    NE.LAUNCHES.update(nee_megakernel=0, primary_probe=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tnee.render_batch_physical_stateless(scene, cam, a, 1, kernel="cuda")
    assert NE.LAUNCHES == {"nee_megakernel": 0, "primary_probe": 0}


@pytest.mark.parametrize("case,w,h", [("reference", 32, 24), ("tri", W, H)])
def test_trace_physical_stateless_matches_jax(case, w, h):
    """The reference scene, and the triangle-emitter scene (spheres, planes,
    emitter triangles: both light samplers).  On the reference scene one
    knife-edge lane differs from the JAX trace, jitted or not, so that
    case runs at 32x24, where one lane is 0.13% of them, inside the
    contract's 0.5%."""
    jscene, jcam = ((J.main_scene(), J.initial_camera()) if case == "reference"
                    else jax_nee_scene(case))
    # Rays, key and trace in one jitted function: one compile.
    want = np.asarray(jax.jit(lambda: jnee.trace_physical_stateless(
        jscene, jax_primary_rays(jcam, w, h), jax.random.fold_in(jax.random.PRNGKey(99), 4),
        BOUNCES, SPP))())
    got = tnee.trace_physical_stateless(torch_scene(jscene), primary_rays(torch_camera(jcam), w, h),
                                        T.fold_in(T.prng_key(99), 4), BOUNCES, SPP)
    zeros = np.zeros((h, w, 4), np.uint32)
    assert_lane_parity(zeros, zeros, want, got.numpy())
    assert np.abs(want).max() > 0


def test_renderer_and_cli_threefry(tmp_path):
    from haskell_path_tracer_torch.app.main import main
    from haskell_path_tracer_torch.utils.checkpoint import load_accumulator

    scene, cam = torch_scene(J.main_scene()), torch_camera(J.initial_camera())
    config = RenderConfig(width=W, height=H, algorithm="physical", sampler="threefry",
                          bounces=BOUNCES, device="cpu")
    acc = Renderer(config).render(scene, cam, 3, seed=5)
    want = tint.make_accumulator(W, H, 5, "cpu")
    for _ in range(3):
        want = tnee.render_batch_physical_stateless(scene, cam, want, 1, BOUNCES)
    assert acc.iterations == 3
    assert torch.equal(acc.color, want.color) and torch.equal(acc.rng, want.rng)
    sfc32 = Renderer(config.replace(sampler="sfc32")).render(scene, cam, 3, seed=5)
    assert not torch.equal(sfc32.color, acc.color)
    with pytest.raises(ValueError, match="unknown sampler"):
        Renderer(config.replace(sampler="pcg"))

    out, ckpt = str(tmp_path / "t.png"), str(tmp_path / "state.npz")
    assert main(["--variant", "physical", "--sampler", "threefry", "--device", "cpu",
                 "--width", str(W), "--height", str(H), "--spp", "3", "--bounces", str(BOUNCES),
                 "--seed", "5", "--quiet", "--checkpoint", ckpt, "-o", out]) == 0
    cli, _ = load_accumulator(ckpt, "cpu")
    assert torch.equal(cli.color, acc.color)


def test_port_matches_stateless_golden():
    """The checks `chip_smoke.py` phase 27 runs on the card, on the CPU."""
    with np.load(STATELESS_GOLDEN_PATH) as z:
        g = {k: z[k] for k in z.files}
    key = T.prng_key(1234)
    for s in STATELESS_SEEDS:
        assert (T.prng_key(int(np.array(s, np.uint32).view(np.int32))).numpy().view(np.uint32)
                == g[f"key__{s}"]).all()
    for d in STATELESS_FOLD_DATA:
        assert (rng_to_numpy(T.fold_in(key, d)) == g[f"fold_in__{d}"]).all()
    for name, shape in STATELESS_SHAPES.items():
        assert (rng_to_numpy(T.bits(key, shape)) == g[f"bits__{name}"]).all()
        assert (T.uniform(key, shape).numpy() == g[f"uniform__{name}"]).all()
    assert (rng_to_numpy(T.split(key, 5)) == g["split__5"]).all()


def test_stateless_golden_file_is_current():
    want = stateless_golden_arrays()
    with np.load(STATELESS_GOLDEN_PATH) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
