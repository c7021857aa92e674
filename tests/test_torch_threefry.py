"""The port's threefry2x32 (`ops/threefry.py`, `ops/rng.py:fresh_keys`)
against `jax.random` on the CPU: every word bit-equal.

The installed JAX runs `threefry2x32` with `jax_threefry_partitionable`
on, which sets the layout of `bits` and `split`; the first test pins that.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from haskell_path_tracer_tpu.ops.rng import fresh_keys as jax_fresh_keys

from haskell_path_tracer_torch.ops import rng as R
from haskell_path_tracer_torch.ops import threefry as T

torch.set_num_threads(2)


def words(t: torch.Tensor) -> np.ndarray:
    """int32-held words as uint32."""
    return t.numpy().view(np.uint32)


def int32_word(w: int) -> int:
    return int(np.array(w, np.uint32).view(np.int32))


def test_jax_runs_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31, 0xDEADBEEF, 2**32 - 1])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jr.PRNGKey(jnp.uint32(seed)))
    assert (words(T.prng_key(seed)) == want).all()
    # A word at or above 2^31 held as int32, as a Python int and as a tensor.
    assert (words(T.prng_key(int32_word(seed))) == want).all()
    tensor_seed = torch.tensor(int32_word(seed), dtype=torch.int32)
    assert (words(T.prng_key(tensor_seed)) == want).all()
    if seed < 2**31:
        assert (np.asarray(jr.PRNGKey(seed)) == want).all()


def test_prng_key_refuses_wider_seeds():
    for bad in (2**32, -(2**31) - 1):
        with pytest.raises(ValueError, match="32-bit word"):
            T.prng_key(bad)
    with pytest.raises(ValueError, match="int32 scalar"):
        T.prng_key(torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("data", [0, 1, 12345, 2**31 + 5])
def test_fold_in_matches_jax(data):
    key = jr.PRNGKey(77)
    want = np.asarray(jr.fold_in(key, jnp.uint32(data)))
    assert (words(T.fold_in(T.prng_key(77), data)) == want).all()
    # Folded twice, as the stateless trace derives a bounce's key.
    want2 = np.asarray(jr.fold_in(jr.fold_in(key, jnp.uint32(data)), 3))
    assert (words(T.fold_in(T.fold_in(T.prng_key(77), data), 3)) == want2).all()


@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (3, 5), (13, 11, 4)])
def test_bits_and_uniform_match_jax(shape):
    key = jr.fold_in(jr.PRNGKey(5), 9)
    tkey = T.fold_in(T.prng_key(5), 9)
    assert (words(T.bits(tkey, shape)) == np.asarray(jr.bits(key, shape, jnp.uint32))).all()
    u = T.uniform(tkey, shape)
    assert u.dtype == torch.float32 and u.shape == shape
    assert (u.numpy().view(np.uint32) == np.asarray(jr.uniform(key, shape)).view(np.uint32)).all()
    assert (u >= 0).all() and (u < 1).all()


@pytest.mark.parametrize("num", [1, 2, 5, (2, 3)])
def test_split_matches_jax(num):
    key = jr.PRNGKey(2024)
    assert (words(T.split(T.prng_key(2024), num)) == np.asarray(jr.split(key, num))).all()


@pytest.mark.parametrize("shape,seed", [((4, 3), 0), ((5,), 11), ((2, 2, 3), 2**31 - 1)])
def test_fresh_keys_match_jax(shape, seed):
    want = np.asarray(jax.random.key_data(jax_fresh_keys(shape, seed)))
    got = R.fresh_keys(shape, seed, "cpu")
    assert got.shape == (*shape, 2) and (words(got) == want).all()


def test_stateless_seeding_warmup_and_uniformity():
    """tests/test_rng.py's check through the port: threefry words, 12
    SFC32 warm-up rounds, then the first draws are uniform (mean within 5
    sigma of 0.5 and each octile within 5 sigma over 64k draws).  The
    states themselves are held to the JAX package's in
    tests/test_torch_stateless.py."""
    states = T.bits(T.prng_key(1234), (128, 128, 4))
    for _ in range(12):
        _, states = R.sfc32_next(states)
    u, _ = R.sfc32_float(states)
    u = u.numpy().ravel()
    n = u.size
    assert abs(u.mean() - 0.5) < 5 * (1.0 / np.sqrt(12 * n))
    counts, _ = np.histogram(u, bins=8, range=(0.0, 1.0))
    sigma = np.sqrt(n * (1 / 8) * (7 / 8))
    assert (np.abs(counts - n / 8) < 5 * sigma).all(), counts
