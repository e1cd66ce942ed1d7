"""The port's threefry2x32: the key derivations and draws of ``jax.random``.

The fault model's draws (``core.faults``) must be JAX's bits, because the
flip sets are compared with the reference package's exactly. These
functions reproduce ``jax.random.PRNGKey``, ``fold_in`` and
``bits(key, (), uint32)`` under ``jax_threefry_partitionable=True`` (the
default of JAX 0.9):

- a key is a pair of uint32 words ``(k0, k1)``;
- ``prng_key(seed)`` is ``(0, seed)`` for an int32 seed (``threefry_seed``
  shifts the seed right by 32 for the high word, which is 0 for a 32-bit
  seed, and masks it for the low word);
- ``fold_in(key, data)`` hashes the counter ``(0, uint32(data))`` under
  ``key``: the new key is both output words (``threefry_seed`` of the
  data, hashed as a count of two);
- ``bits32(key)`` hashes the counter ``(0, 0)`` (the iota of shape ``()``,
  high and low words) and returns the XOR of the two output words.

Every function takes Python ints or int64 tensors (words in
``[0, 2^32)``, masked after every add and shift), so one code path serves
the host (the kernel's keys) and the plain engine (batched draws). A
tensor never holds uint32: torch on the CPU cannot shift one right.
``csrc/threefry.cuh`` is the device version, in uint32.
"""
from __future__ import annotations

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry_2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: the words ``(x0, x1)`` hashed under
    the key ``(k0, k1)``; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def u32(x):
    """An int32 (or any int) as its uint32 bit pattern."""
    return x & M32


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for an int32 seed, as ``(k0, k1)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must be an int32, got {seed}")
    return 0, seed & M32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: ``data`` int32, hashed as its
    uint32 bit pattern (so -1 folds in 0xFFFFFFFF)."""
    return threefry_2x32(key[0], key[1], 0, u32(data))


def bits32(key):
    """``jax.random.bits(key, (), uint32)``."""
    y0, y1 = threefry_2x32(key[0], key[1], 0, 0)
    return y0 ^ y1


def as_int32(word: int) -> int:
    """A uint32 word as the int32 with its bit pattern (for the kernel's
    parameter block)."""
    word &= M32
    return word - (1 << 32) if word >= 1 << 31 else word
