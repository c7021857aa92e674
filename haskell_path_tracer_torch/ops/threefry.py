"""Counter-based threefry2x32 keys and draws, bit-equal with `jax.random`.

The part of `jax.random` that the JAX package's stateless sampler uses
(``haskell_path_tracer_tpu/render/nee.py:render_batch_physical_stateless``,
`trace_physical_stateless`, ``ops/rng.py:fresh_keys``), as JAX 0.9.0
computes it with its defaults: the ``threefry2x32`` implementation and
``jax_threefry_partitionable`` on.

  * A key is a pair of uint32 words.  A 32-bit seed gives ``(0, seed)``
    (``jax/_src/prng.py:_threefry_seed``).
  * ``threefry2x32`` is Random123's 20-round Threefry-2x32 with the key
    schedule injected every four rounds (``_threefry2x32_lowering``).
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key.
  * ``bits(key, shape)`` hashes the row-major flat index of every element,
    split into (high, low) words, and returns the XOR of the two output
    words (``_threefry_random_bits_partitionable``); ``split(key, n)``
    hashes the same counters and keeps both words as the new keys
    (``_threefry_split_foldlike``).
  * ``uniform`` keeps the top 23 bits as the mantissa of a float in
    [1, 2) and subtracts 1 (``jax/_src/random.py:_uniform``).

Words live in int32 tensors holding the uint32 bit patterns, as the SFC32
words do (`ops/rng.py`): add and left shift wrap the same on int32, and
the logical right shift is `rng.srl`.  Every function takes its device from
the key, or from `device` where it makes one; nothing leaves the device.
"""

from __future__ import annotations

import math

import torch

from .rng import srl

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# The bit pattern of 1.0f: the exponent that makes the mantissa a float
# in [1, 2).
_ONE_BITS = 0x3F800000


def _word(x: int) -> int:
    """A Python integer in [-2^31, 2^32) as the int32 holding its uint32
    bit pattern."""
    if not -(1 << 31) <= x < (1 << 32):
        raise ValueError(f"{x} is not a 32-bit word")
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | srl(x, 32 - r)


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2); the key words broadcast against the counters.  Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _word(_PARITY))
    x1 = x1 + ks[0]
    x2 = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + (i + 1)
    return x1, x2


def prng_key(seed, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: int32 [2] = (0, seed).

    `seed` is a Python integer in [-2^31, 2^32) (a word at or above 2^31
    may come as its negative int32 pattern: both give the same key) or an
    int32 scalar tensor, which stays on its device."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.dim():
            raise ValueError("a tensor seed is an int32 scalar")
        return torch.stack([torch.zeros_like(seed), seed])
    return torch.tensor([0, _word(int(seed))], dtype=torch.int32, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for a key int32 [..., 2] and a
    Python integer in [-2^31, 2^32)."""
    zero = torch.zeros_like(key[..., 0])
    out = threefry2x32(key[..., 0], key[..., 1], zero, zero + _word(int(data)))
    return torch.stack(out, dim=-1)


def _counters(shape, device):
    """The row-major flat index of every element of `shape`, as the
    (high, low) words of a 64-bit count (`iota_2x32_shape`)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    lo = (idx & 0xFFFFFFFF) - ((idx & 0x80000000) << 1)
    return (idx >> 32).to(torch.int32), lo.to(torch.int32)


def _hash_counters(key: torch.Tensor, shape):
    if key.shape != (2,):
        raise ValueError(f"a key is int32 [2], not {tuple(key.shape)}")
    hi, lo = _counters(tuple(shape), key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`: int32 words of `shape`."""
    b1, b2 = _hash_counters(key, shape)
    return b1 ^ b2


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """`jax.random.split(key, num)`: int32 [*num, 2] keys (`num` an int or
    a shape)."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    return torch.stack(_hash_counters(key, shape), dim=-1)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    mant = srl(bits(key, shape), 32 - 23) | _ONE_BITS
    return mant.view(torch.float32) - 1.0
