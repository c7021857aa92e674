"""Per-pixel SFC32 RNG on int32 tensors.

Counterpart of ``haskell_path_tracer_tpu/ops/rng.py``: every pixel carries
a 4-word state (a, b, c, counter) and the draws are bit-equal with the JAX
package and its numpy twin.

torch on the CPU has no uint32 add or right shift, so the words live in
int32 tensors holding the uint32 bit patterns:
  * add and left shift wrap modulo 2^32 on int32 exactly as on uint32;
  * a logical right shift is the arithmetic one with the sign-extended
    bits masked off: (x >> k) & (2^(32-k) - 1);
  * the float map ((bits >> 8) & 0xFFFFFF) * 2^-24 is exact, the value
    being below 2^24.

SFC32 step:
    t       = a + b + counter
    counter = counter + 1
    a       = b ^ (b >> 9)
    b       = c + (c << 3)
    c       = rotl(c, 21) + t
    output  = t
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..utils.metrics import span

_INV_2_24 = float(np.float32(1.0 / (1 << 24)))


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def sfc32_next(state: torch.Tensor):
    """Advance SFC32. `state` is int32 [..., 4] = (a, b, c, counter).

    Returns (output [...] int32 bits, new_state [..., 4])."""
    a, b, c, counter = state.unbind(-1)
    t = a + b + counter
    counter = counter + 1
    a = b ^ srl(b, 9)
    b = c + (c << 3)
    c = ((c << 21) | srl(c, 11)) + t
    return t, torch.stack([a, b, c, counter], dim=-1)


def sfc32_float(state: torch.Tensor):
    """One uniform f32 draw in [0, 1) per lane. Returns (u, new_state)."""
    bits, state = sfc32_next(state)
    return srl(bits, 8).to(torch.float32) * _INV_2_24, state


def gen_vec(state: torch.Tensor):
    """Three uniforms in [-1, 1]^3, drawn in x, y, z order (`genVec`).
    Returns (vec [..., 3], new_state)."""
    x, state = sfc32_float(state)
    y, state = sfc32_float(state)
    z, state = sfc32_float(state)
    return torch.stack([x, y, z], dim=-1) * 2.0 - 1.0, state


def np_gen_seeds(shape, seed: int | None = None) -> np.ndarray:
    """uint32 [*shape, 4]: numpy PCG64 words, then 12 warm-up rounds —
    the JAX package's seeding, so a seed gives the same states in both."""
    rng = np.random.default_rng(
        seed if seed is not None else int.from_bytes(os.urandom(8), "little")
    )
    state = rng.integers(0, 2**32, size=(*tuple(shape), 4), dtype=np.uint32)
    for _ in range(12):
        _, state = np_sfc32_next(state)
    return state


def gen_seeds(shape, seed: int | None, device) -> torch.Tensor:
    """Fresh per-pixel SFC32 states, int32 [*shape, 4] on `device`: made
    on the host by `np_gen_seeds`, then uploaded, in span "hpt.rng.seed"."""
    with span("hpt.rng.seed"):
        words = np.ascontiguousarray(np_gen_seeds(shape, seed)).view(np.int32)
        return torch.as_tensor(words, device=device)


def reseed(rng_state_shape, accumulator, seed: int | None = None):
    """Replace every pixel's RNG state with a fresh one, keeping the color
    (the reference's periodic `reseed`)."""
    return dataclasses.replace(
        accumulator,
        rng=gen_seeds(rng_state_shape, seed, accumulator.rng.device),
    )


def fresh_keys(shape, seed: int = 0, device=None) -> torch.Tensor:
    """A grid of threefry keys, one per pixel: int32 [*shape, 2], the key
    words of `jax.random.split(jax.random.key(seed), prod(shape))` reshaped
    (the JAX package's `fresh_keys`; `ops/threefry.py`)."""
    from . import threefry

    shape = tuple(shape)
    keys = threefry.split(threefry.prng_key(seed, device), int(np.prod(shape)))
    return keys.reshape(*shape, 2)


# numpy twin, on uint32 — bit-exact with the functions above.


def np_sfc32_next(state: np.ndarray):
    a = state[..., 0]
    b = state[..., 1]
    c = state[..., 2]
    counter = state[..., 3]
    with np.errstate(over="ignore"):
        t = a + b + counter
        counter = counter + np.uint32(1)
        a = b ^ (b >> np.uint32(9))
        b = c + (c << np.uint32(3))
        c = ((c << np.uint32(21)) | (c >> np.uint32(11))) + t
    return t, np.stack([a, b, c, counter], axis=-1)


def np_sfc32_float(state: np.ndarray):
    bits, state = np_sfc32_next(state)
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(_INV_2_24), state


def np_gen_vec(state: np.ndarray):
    x, state = np_sfc32_float(state)
    y, state = np_sfc32_float(state)
    z, state = np_sfc32_float(state)
    return np.stack([x, y, z], axis=-1) * np.float32(2.0) - np.float32(1.0), state
