"""The sampler's draws: the Hopper draw kernel, its wrapper and its plain
version.

:func:`draw_windows` makes ``n_batches`` sampling steps' draws, ``(region,
donor, chrom)`` of every window, and each window's start, the JAX package's
``_sample_batch`` stream bit for bit: batch ``i`` draws under
``fold_in(key, step0 + i)``, split in three, one ``randint`` a field over
``[0, R)``, ``[0, D)`` and ``[0, C)``.  With ``digest`` the key is first
``fold_in(key, digest)``: a chain link's key made from the link before it.
On a CUDA tensor it is one launch of ``csrc/draw_kernel.cu``; on a CPU
tensor it is :func:`draws_plain`, the same function in torch ops
(``ops/threefry.py``).  It never falls back from one to the other.

The kernel ports no Pallas kernel: it stands for the ``jax.random`` ops and
the window crop that XLA runs for the JAX sampler.

A key is either two words as Python ints (a key the host holds, which the
kernel takes by value, so no copy reaches the card) or a ``(2,)`` int64
tensor on the device (a key the card made, read by the kernel from device
memory, so it never reaches the host).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Union

import torch

from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.threefry import (
    INT32_MAX,
    INT32_MIN,
    MASK32,
    fold_in,
    randint,
    randint_multiplier,
    split,
)

#: two key words on the host, or a (2,) int64 key tensor on the device
Key = Union[Sequence[int], torch.Tensor]


class Draws(NamedTuple):
    """The draws of ``n_batches`` steps, batch ``i`` in lanes ``[i * B, (i +
    1) * B)``."""

    key: torch.Tensor  # (2,) int64: the key the steps were drawn under
    region_idx: torch.Tensor  # (n_batches * B,) int32
    donor_idx: torch.Tensor  # (n_batches * B,) int32
    chrom_idx: torch.Tensor  # (n_batches * B,) int32
    start: torch.Tensor  # (n_batches * B,) int32: window_starts of the draws


def window_starts(regions: torch.Tensor, lengths: torch.Tensor, region_idx: torch.Tensor,
                  chrom_idx: torch.Tensor, L: int) -> torch.Tensor:
    """(B,) int32 window starts: each region's midpoint crop, clamped so the
    window stays inside the drawn chromosome (int32 arithmetic)."""
    span = regions[region_idx.long()]  # (B, 2)
    mid = (span[:, 0] + span[:, 1]) // 2
    new_start = (mid - L // 2).clamp(min=0)
    limit = (lengths[chrom_idx.long()] - L).clamp(min=0)
    return torch.minimum(new_start, limit).to(torch.int32)


def _check(key: Key, step0: int, n_batches: int, batch_size: int, regions: torch.Tensor,
           lengths: torch.Tensor, n_donors: int, L: int, digest) -> None:
    """Raise on what neither version takes."""
    if not INT32_MIN <= step0 <= INT32_MAX:
        raise OverflowError(f"step {step0} does not fit in int32, as the JAX sampler's step")
    if n_batches < 1 or batch_size < 1 or n_batches * batch_size > INT32_MAX:
        raise ValueError(f"unsupported n_batches={n_batches} x batch_size={batch_size}")
    if regions.dim() != 2 or regions.shape[1] != 2 or lengths.dim() != 1:
        raise ValueError("regions must be (R, 2) and lengths (C,)")
    sizes = (regions.shape[0], n_donors, lengths.shape[0])
    if min(sizes) < 1 or max(sizes) > INT32_MAX:
        raise ValueError(f"draw sizes (R, D, C) = {sizes} must lie in [1, 2^31)")
    if not 1 <= L <= INT32_MAX:
        raise ValueError(f"L={L} outside [1, 2^31)")
    for name, t in (("regions", regions), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("key", key), ("digest", digest)):
        if isinstance(t, torch.Tensor) and t.device != regions.device:
            raise ValueError(f"{name} is on {t.device}, regions are on {regions.device}")
    if isinstance(key, torch.Tensor):
        if key.shape != (2,) or key.dtype != torch.int64:
            raise ValueError(f"a key tensor must be (2,) int64, got {tuple(key.shape)} {key.dtype}")
    elif len(key) != 2:
        raise ValueError(f"a key is two words, got {key!r}")
    if digest is not None and (digest.shape != () or digest.dtype != torch.int64):
        raise ValueError("digest must be a () int64 tensor")


def draws_plain(key: Key, step0: int, n_batches: int, batch_size: int, regions: torch.Tensor,
                lengths: torch.Tensor, n_donors: int, L: int,
                digest: torch.Tensor | None = None) -> Draws:
    """:func:`draw_windows` in torch ops on ``regions``' device."""
    _check(key, step0, n_batches, batch_size, regions, lengths, n_donors, L, digest)
    dev = regions.device
    if not isinstance(key, torch.Tensor):
        key = torch.tensor([int(k) & MASK32 for k in key], dtype=torch.int64, device=dev)
    if digest is not None:
        key = fold_in(key, digest)
    steps = torch.arange(step0, step0 + n_batches, dtype=torch.int64, device=dev)
    keys = split(fold_in(key, steps), 3)  # (n_batches, 3, 2)
    sizes = (regions.shape[0], n_donors, lengths.shape[0])
    r, d, c = (randint(keys[:, f], batch_size, 0, size).reshape(-1).to(torch.int32)
               for f, size in enumerate(sizes))
    return Draws(key, r, d, c, window_starts(regions, lengths, r, c, L))


def divisor(d: int) -> tuple[int, int, int, int]:
    """``(d, magic, shift, mult)``: the kernel's constants for a divisor
    ``d`` in ``[1, 2^31)`` fixed for a launch.  For every uint32 ``n``,
    ``n // d == ((n * magic >> 32) + n) >> shift``, the sum taken in 64 bits
    (Granlund and Montgomery's round-up method: ``shift = ceil(log2 d)``,
    ``magic = 2^32 (2^shift - d) // d + 1 < 2^32``), and ``mult`` is
    :func:`~haplohyped_tpu_torch.ops.threefry.randint_multiplier` of ``d``."""
    shift = (d - 1).bit_length()
    magic = (((1 << shift) - d) << 32) // d + 1
    return d, magic, shift, randint_multiplier(d)


@functools.lru_cache(maxsize=64)
def _divisors(R: int, D: int, C: int, B: int) -> ctypes.Array:
    """``hh_draw``'s 16 words: :func:`divisor` of R, D, C and B, made once
    per size tuple."""
    return (ctypes.c_uint32 * 16)(*(w for d in (R, D, C, B) for w in divisor(d)))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("draw_kernel")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.hh_draw.argtypes = [p, u, u, p, p, u, i, ctypes.POINTER(u), p, p, i, p, p]
    lib.hh_draw.restype = ctypes.c_int
    lib.hh_draw_error_string.argtypes = [ctypes.c_int]
    lib.hh_draw_error_string.restype = ctypes.c_char_p
    return lib


def draw_windows(key: Key, step0: int, n_batches: int, batch_size: int, regions: torch.Tensor,
                 lengths: torch.Tensor, n_donors: int, L: int,
                 digest: torch.Tensor | None = None) -> Draws:
    """The draws and window starts of steps ``step0 .. step0 + n_batches -
    1`` under ``key`` (``fold_in(key, digest)`` with a digest): the Hopper
    kernel when ``regions`` lie on a CUDA device, the plain version when
    they lie on the CPU.  ``draw_windows.launches`` counts the kernel's
    launches."""
    dev = regions.device
    if dev.type == "cpu":
        return draws_plain(key, step0, n_batches, batch_size, regions, lengths, n_donors, L,
                           digest)
    if dev.type != "cuda":
        raise ValueError(f"no draw kernel for device {dev}")
    _check(key, step0, n_batches, batch_size, regions, lengths, n_donors, L, digest)
    for name, t in (("regions", regions), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if regions.data_ptr() % 8:
        raise ValueError("regions must start on an 8-byte boundary")
    key_t = key if isinstance(key, torch.Tensor) else None
    k0, k1 = (0, 0) if key_t is not None else (int(k) & MASK32 for k in key)
    n = n_batches * batch_size
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    key_out = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hh_draw(
            None if key_t is None else key_t.data_ptr(), k0, k1,
            None if digest is None else digest.data_ptr(), key_out.data_ptr(),
            step0 & MASK32, n_batches,
            _divisors(regions.shape[0], n_donors, lengths.shape[0], batch_size),
            regions.data_ptr(), lengths.data_ptr(), L, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"draw kernel launch failed: {lib.hh_draw_error_string(rc).decode()}")
    draw_windows.launches += 1
    return Draws(key_out, *out)


draw_windows.launches = 0
