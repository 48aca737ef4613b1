"""The port's bit-packed genome codecs (torch ops, on the CPU here) against
the JAX package's and the numpy codecs.

``gather_window_2bit`` must return ``codes[s:s + L]`` for every start; the
JAX function does so only where none of its fixed-size slices clamps, and
one test pins the starts where it does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haplohyped_tpu.ops import pack as jax_pack
from haplohyped_tpu_torch.ops.pack import (
    gather_window_2bit,
    pack_2bit_device,
    pack_4bit_device,
    unpack_2bit_device,
    unpack_4bit_device,
)
from haplohyped_tpu_torch.utils.bitpack import bitpack_indices, pack_2bit, unpack_bits

WINDOW_LENGTHS = (6, 8, 256, 1000, 1001, 1002, 1003)


@pytest.fixture(scope="module")
def codes():
    """The fixture of ``tests/test_pack.py``."""
    return np.random.default_rng(0).integers(0, 5, size=4096).astype(np.int8)


@pytest.fixture(scope="module")
def packed(codes):
    return pack_2bit_device(torch.from_numpy(codes))


def test_codecs_match_jax_at_4096(codes):
    p, m = pack_2bit_device(torch.from_numpy(codes))
    jp, jm = jax_pack.pack_2bit_device(jnp.asarray(codes))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert p.dtype == m.dtype == torch.uint8
    assert p.numel() == codes.size // 4 and m.numel() == codes.size // 8
    u = unpack_2bit_device(p, m)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax_pack.unpack_2bit_device(jp, jm)))
    np.testing.assert_array_equal(u.numpy(), codes)
    p4 = pack_4bit_device(torch.from_numpy(codes))
    jp4 = jax_pack.pack_4bit_device(jnp.asarray(codes))
    np.testing.assert_array_equal(p4.numpy(), np.asarray(jp4))
    np.testing.assert_array_equal(unpack_4bit_device(p4).numpy(),
                                  np.asarray(jax_pack.unpack_4bit_device(jp4)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 12, 13, 4097, 4099, 4100])
def test_codecs_at_odd_lengths(n):
    """Bit-equal to the numpy codecs at every length; to the JAX functions
    at the lengths they take (a multiple of 4, or of 2 for 4-bit)."""
    c = np.random.default_rng(n).integers(0, 5, n).astype(np.int8)
    p, m = pack_2bit_device(torch.from_numpy(c))
    np_p, np_m, _ = pack_2bit(c)
    np.testing.assert_array_equal(p.numpy(), np_p)
    np.testing.assert_array_equal(m.numpy(), np_m)
    np.testing.assert_array_equal(unpack_2bit_device(p, m).numpy()[:n], c)
    p4 = pack_4bit_device(torch.from_numpy(c))
    np.testing.assert_array_equal(p4.numpy(), bitpack_indices(c))
    np.testing.assert_array_equal(unpack_4bit_device(p4).numpy(), unpack_bits(p4.numpy()))
    if n % 4 == 0:
        jp, jm = jax_pack.pack_2bit_device(jnp.asarray(c))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    if n % 2 == 0:
        np.testing.assert_array_equal(p4.numpy(),
                                      np.asarray(jax_pack.pack_4bit_device(jnp.asarray(c))))


def _jax_windows(codes, starts, L):
    """The JAX ``gather_window_2bit`` at each start, one call each (a
    ``lax.map``, so every call keeps its own slices)."""
    jp, jm = jax_pack.pack_2bit_device(jnp.asarray(codes))
    f = jax.jit(lambda ss: jax.lax.map(
        lambda s: jax_pack.gather_window_2bit(jp, jm, s, L=L), ss))
    return np.asarray(f(jnp.asarray(starts, jnp.int32)))


def _jax_slices_in_bounds(starts, L, n_bytes, n_mask_bytes):
    """Whether each of the JAX function's four dynamic slices fits without
    clamping its start, at each start."""
    s = np.asarray(starts, np.int64)
    byte_start, nbytes = s // 4, L // 4 + 1
    phase = s - byte_start * 4
    n_idx = byte_start * 4 - byte_start // 2 * 8 + phase
    return ((byte_start + nbytes <= n_bytes)
            & (byte_start // 2 + nbytes // 2 + 1 <= n_mask_bytes)
            & (phase + L <= 4 * nbytes)
            & (n_idx + L <= 8 * (nbytes // 2 + 1)))


@pytest.mark.parametrize("L", WINDOW_LENGTHS)
def test_gather_window_every_start(codes, packed, L):
    starts = np.arange(codes.size - L + 1)
    got = gather_window_2bit(*packed, torch.from_numpy(starts), L=L).numpy()
    assert got.dtype == np.int8 and got.shape == (starts.size, L)
    np.testing.assert_array_equal(got, np.lib.stride_tricks.sliding_window_view(codes, L))
    for s in (0, 3, codes.size - L):  # int starts
        np.testing.assert_array_equal(gather_window_2bit(*packed, s, L=L).numpy(),
                                      codes[s:s + L])


@pytest.mark.parametrize("L", WINDOW_LENGTHS)
def test_gather_window_equals_jax_where_jax_does_not_clamp(codes, packed, L):
    starts = np.arange(codes.size - L + 1)
    ok = _jax_slices_in_bounds(starts, L, packed[0].numel(), packed[1].numel())
    assert ok.sum() > 0
    jax_out = _jax_windows(codes, starts[ok], L)
    got = gather_window_2bit(*packed, torch.from_numpy(starts[ok]), L=L).numpy()
    np.testing.assert_array_equal(got, jax_out)


def test_jax_gather_window_fault_is_pinned(codes, packed):
    """The JAX function returns wrong bases where a slice clamps: at L=6,
    start=3 (its 8 unpacked bases hold only 5 of the window's) and at the
    last L=1000 window (start 3096, whose covering bytes pass the end).  The
    port returns the codes' slice at both."""
    L, s = 6, 3
    jax_win = _jax_windows(codes, [s], L)[0]
    np.testing.assert_array_equal(codes[s:s + L][[0, 2]], [1, 0])
    np.testing.assert_array_equal(jax_win[[0, 2]], [2, 1])
    assert not np.array_equal(jax_win, codes[s:s + L])
    np.testing.assert_array_equal(gather_window_2bit(*packed, s, L=L).numpy(), codes[s:s + L])
    L, s = 1000, 3096
    assert not _jax_slices_in_bounds([s], L, packed[0].numel(), packed[1].numel())[0]
    assert not np.array_equal(_jax_windows(codes, [s], L)[0], codes[s:s + L])
    np.testing.assert_array_equal(gather_window_2bit(*packed, s, L=L).numpy(), codes[s:s + L])


def test_gather_window_refuses_int_starts_out_of_range(packed):
    for s in (-1, 4096 - 6 + 1):
        with pytest.raises(ValueError, match="outside"):
            gather_window_2bit(*packed, s, L=6)


def test_gather_window_batched_shape(codes, packed):
    starts = torch.tensor([[0, 5], [17, 4090]])
    got = gather_window_2bit(*packed, starts, L=6)
    assert got.shape == (2, 2, 6)
    np.testing.assert_array_equal(got[1, 1].numpy(), codes[4090:4096])
