"""The JAX package's random stream as plain torch ops: ``jax.random``'s
threefry2x32 keys, ``fold_in``, ``split``, 32-bit random bits and
``randint``, bit for bit.

The JAX package draws every sampler batch with ``jax.random`` on its default
implementation, threefry2x32 in its "partitionable" form
(``jax_threefry_partitionable``, on by default), with 64-bit types off.
These functions reproduce that mode:

- a key is two 32-bit words; ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``
  (JAX converts a Python int seed to int64 and then, with 64-bit types off,
  keeps its low 32 bits);
- ``threefry2x32(key, x0, x1)`` hashes the counter pair ``(x0, x1)``: 20
  rounds of add, rotate and xor in 5 groups of 4, rotations (13, 15, 26, 6)
  and (17, 29, 16, 24) in turn, the key schedule ``k0, k1, k0 ^ k1 ^
  0x1BD11BDA`` injected after each group;
- ``fold_in(key, data)`` hashes ``(0, data)``; key ``i`` of ``split(key,
  n)`` hashes ``(0, i)``; ``random_bits32(key, n)`` is ``y0 ^ y1`` of the
  hash of ``(0, i)`` for ``i < n``;
- ``randint(key, n, lo, hi)`` splits the key in two, draws 32 bits from each
  (``h``, ``l``) and returns ``lo + ((h mod s) * m + l mod s) mod s`` for
  ``s = hi - lo`` (1 when ``hi <= lo``) and ``m = (2^16 mod s)^2 mod s``, every
  step in uint32 arithmetic that wraps (so ``m`` is 0 for ``s > 2^16``).

Words are int64 tensors holding values in ``[0, 2^32)``; every add and
product is masked back to 32 bits, and a rotation is a shift, a shift and an
or.  Every function takes keys of shape ``(..., 2)`` and broadcasts over the
leading dimensions, and runs only device ops on the key's device (no host
read), so a CUDA graph can capture it.  ``csrc/draw_kernel.cu`` computes the
sampler's draws with the same arithmetic on native uint32 words.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
#: threefry's key-schedule parity constant
KS_PARITY = 0x1BD11BDA
#: the rotation distances of the even and odd groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def prng_key(seed: int) -> tuple[int, int]:
    """The two words of ``jax.random.PRNGKey(seed)`` with 64-bit types off:
    ``(0, seed mod 2^32)`` for any seed in int64's range (JAX raises
    outside it, and so does this).  ``torch.tensor(prng_key(seed))`` is
    the key as the functions below take it."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64, as PRNGKey requires")
    return 0, seed & MASK32


def _add(a, b):
    return (a + b) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _threefry(k0, k1, x0, x1):
    """threefry2x32 of ``(x0, x1)`` under ``(k0, k1)``, on words that are
    int64 tensors or Python ints alike."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = _add(x0, ks[0])
    x1 = _add(x1, ks[1])
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _add(x0, ks[(group + 1) % 3])
        x1 = _add(x1, ks[(group + 2) % 3] + group + 1)
    return x0, x1


def threefry2x32(key: torch.Tensor, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y0, y1)``: threefry2x32 of the counter words ``(x0, x1)`` under
    ``key`` (``(..., 2)``); ``x0``, ``x1`` (tensors or ints) broadcast
    against ``key[..., 0]``."""
    return _threefry(key[..., 0], key[..., 1], x0, x1)


def fold_in_words(key: tuple[int, int], data: int) -> tuple[int, int]:
    """:func:`fold_in` of a key the host holds, hashed in Python ints: no
    tensor is made, so it costs the host microseconds and the card
    nothing."""
    return _threefry(int(key[0]) & MASK32, int(key[1]) & MASK32, 0, int(data) & MASK32)


def _counters(key: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=key.device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``(*shape, 2)`` keys, the hash of
    ``(0, data mod 2^32)``; ``data`` (an int or an integer tensor, int64 or
    narrower) broadcasts against ``key[..., 0]``."""
    if isinstance(data, torch.Tensor):
        data = data.long() & MASK32
    else:
        data = torch.tensor(int(data) & MASK32, dtype=torch.int64, device=key.device)
    return torch.stack(threefry2x32(key, 0, data), dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` in the partitionable form: ``(..., n,
    2)``, key ``i`` the hash of ``(0, i)``."""
    return torch.stack(threefry2x32(key[..., None, :], 0, _counters(key, n)), dim=-1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)``: JAX's 32 random bits of ``key``, ``y0 ^ y1`` of the
    hash of ``(0, i)`` for ``i < n``."""
    y0, y1 = threefry2x32(key[..., None, :], 0, _counters(key, n))
    return y0 ^ y1


def randint_span(lo: int, hi: int) -> int:
    """The uint32 span of ``randint(., lo, hi)``: ``hi - lo``, or 1 when
    ``hi <= lo``.  ``lo`` and ``hi`` must fit in int32 (JAX's default int)."""
    for v in (lo, hi):
        if not INT32_MIN <= v <= INT32_MAX:
            raise OverflowError(f"randint bound {v} does not fit in int32")
    return (hi - lo) & MASK32 if hi > lo else 1


def randint_multiplier(span: int) -> int:
    """``(2^16 mod span)^2 mod span`` in uint32 arithmetic, as JAX takes it:
    the square wraps, so it is 0 for ``span > 2^16``."""
    m = (1 << 16) % span
    return ((m * m) & MASK32) % span


def randint(key: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), lo, hi)`` (int32): ``(..., n)``
    int64 values in ``[lo, hi)`` (``lo`` alone when ``hi <= lo``)."""
    span = randint_span(lo, hi)
    mult = randint_multiplier(span)
    k = split(key)
    h = random_bits32(k[..., 0, :], n)
    low = random_bits32(k[..., 1, :], n)
    offset = (((h % span) * mult) & MASK32) + low % span
    return ((offset & MASK32) % span) + lo
