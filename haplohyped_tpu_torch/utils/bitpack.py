"""Bit-packed nucleotide codecs (numpy).

Two codecs, the reference the torch codecs of
:mod:`haplohyped_tpu_torch.ops.pack` are held against:

- 4-bit (``bitpack_indices``/``unpack_bits``): lossless for the 5-symbol
  alphabet {A,C,G,T,N}; two codes per byte.
- 2-bit (``pack_2bit``/``unpack_2bit``): four bases per byte for {A,C,G,T}
  with a separate N bit-mask (a 3-Gbase genome in ~0.75 GB of device memory
  with its mask, against 15 GB one-hot).
"""

from __future__ import annotations

import numpy as np

from haplohyped_tpu_torch.core.constants import N_CODE, NUM_CHANNELS


def bitpack_indices(indices: np.ndarray) -> np.ndarray:
    """Pack int8 nucleotide codes (0..15) into 4-bit nibbles, two per byte.

    The array is padded with 0 to even length; callers keep the original
    length for exact round-trips via :func:`unpack_bits`.
    """
    idx = np.asarray(indices, dtype=np.uint8).ravel()
    if idx.size % 2:
        idx = np.concatenate([idx, np.zeros(1, dtype=np.uint8)])
    pairs = idx.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8)


def unpack_bits(packed: np.ndarray, length: int | None = None) -> np.ndarray:
    """Inverse of :func:`bitpack_indices`; ``length`` trims the pad element."""
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.empty(packed.size * 2, dtype=np.int8)
    out[0::2] = packed & 0x0F
    out[1::2] = packed >> 4
    return out[:length] if length is not None else out


def pack_2bit(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack base codes into 2 bits/base plus an N bit-mask.

    Returns ``(packed, n_mask, length)`` where ``packed[i]`` holds 4 bases
    (LSB-first) and ``n_mask`` is a ``np.packbits``-style bit mask (little
    bit order) of positions whose code was N (those positions pack as 0/A).
    """
    codes = np.asarray(codes, dtype=np.int8).ravel()
    length = codes.size
    is_n = codes == N_CODE
    two_bit = np.where(is_n, 0, codes).astype(np.uint8) & 0x3
    pad = (-length) % 4
    if pad:
        two_bit = np.concatenate([two_bit, np.zeros(pad, dtype=np.uint8)])
    quads = two_bit.reshape(-1, 4)
    packed = (
        quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    ).astype(np.uint8)
    n_mask = np.packbits(is_n, bitorder="little")
    return packed, n_mask, length


def unpack_2bit(packed: np.ndarray, n_mask: np.ndarray, length: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit` -> int8 codes in [0, NUM_CHANNELS)."""
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.empty(packed.size * 4, dtype=np.int8)
    out[0::4] = packed & 0x3
    out[1::4] = (packed >> 2) & 0x3
    out[2::4] = (packed >> 4) & 0x3
    out[3::4] = (packed >> 6) & 0x3
    out = out[:length]
    is_n = np.unpackbits(np.asarray(n_mask, dtype=np.uint8), bitorder="little")[:length]
    out[is_n.astype(bool)] = N_CODE
    return out


def index_to_onehot(indices: np.ndarray, num_classes: int = NUM_CHANNELS) -> np.ndarray:
    """Convert int codes to one-hot rows (uint8); codes are clipped into
    ``[0, num_classes)``."""
    idx = np.asarray(indices)
    eye = np.eye(num_classes, dtype=np.uint8)
    return eye[np.clip(idx, 0, num_classes - 1)]
