"""SFC32 in the PyTorch port (int32 words) against the JAX package (uint32):
the streams, floats and seeds must be bit-equal."""

import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.ops import rng as jrng
from haskell_path_tracer_torch.models.convert import rng_from_numpy, rng_to_numpy
from haskell_path_tracer_torch.ops import rng as trng

torch.set_num_threads(2)

LANES = 4096
STEPS = 64


def _states(seed=0):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=(LANES, 4), dtype=np.uint32
    )


def test_sfc32_next_is_bit_equal_with_jax_and_numpy():
    s_np = _states()
    s_jax = s_np.copy()
    s_t = rng_from_numpy(s_np, "cpu")
    for step in range(STEPS):
        out_t, s_t = trng.sfc32_next(s_t)
        out_j, s_jax = jrng.sfc32_next(s_jax)
        out_n, s_np = jrng.np_sfc32_next(s_np)
        np.testing.assert_array_equal(rng_to_numpy(s_t), np.asarray(s_jax), err_msg=str(step))
        np.testing.assert_array_equal(rng_to_numpy(s_t), s_np, err_msg=str(step))
        np.testing.assert_array_equal(rng_to_numpy(out_t), np.asarray(out_j))


def test_sfc32_float_and_gen_vec_are_bit_equal():
    s = _states(1)
    u_t, s_t = trng.sfc32_float(rng_from_numpy(s, "cpu"))
    u_j, s_j = jrng.sfc32_float(s)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    v_t, s_t = trng.gen_vec(s_t)
    v_j, s_j = jrng.gen_vec(s_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(rng_to_numpy(s_t), np.asarray(s_j))
    assert u_t.dtype == v_t.dtype == torch.float32
    assert 0.0 <= float(u_t.min()) and float(u_t.max()) < 1.0


def test_numpy_twin_matches_jax_twin():
    s = _states(2)
    a, sa = trng.np_gen_vec(s)
    b, sb = jrng.np_gen_vec(s)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("shape,seed", [((16, 128), 0), ((3, 5), 123), ((1, 1), 2**40)])
def test_gen_seeds_is_bit_equal(shape, seed):
    t = trng.gen_seeds(shape, seed, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (*shape, 4)
    np.testing.assert_array_equal(rng_to_numpy(t), np.asarray(jrng.gen_seeds(shape, seed=seed)))


def test_logical_shift_on_int32_words():
    """The masked arithmetic shift equals uint32 >> k on the sign-bit cases."""
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    t = rng_from_numpy(words, "cpu")
    for k in (8, 9, 11):
        np.testing.assert_array_equal(rng_to_numpy(trng.srl(t, k)), words >> np.uint32(k))


def test_reseed_keeps_color_and_draws_the_seeded_states():
    from haskell_path_tracer_torch.render.integrator import make_accumulator

    acc = make_accumulator(8, 4, 1, "cpu")
    acc = type(acc)(color=acc.color + 1.0, rng=acc.rng, iterations=3)
    out = trng.reseed((4, 8), acc, seed=9)
    assert out.iterations == 3 and torch.equal(out.color, acc.color)
    np.testing.assert_array_equal(rng_to_numpy(out.rng), np.asarray(jrng.gen_seeds((4, 8), seed=9)))
