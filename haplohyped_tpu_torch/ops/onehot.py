"""ASCII bases to int8 base codes and one-hot rows, as torch ops on the
input's device (``haplohyped_tpu.ops.onehot``, XLA code there)."""

from __future__ import annotations

import torch

from haplohyped_tpu_torch.core.constants import N_CODE, NUM_CHANNELS


def ascii_to_codes(raw: torch.Tensor) -> torch.Tensor:
    """uint8 ASCII bytes -> int8 base codes (unknown -> N), case-folded.

    Four compares against the case-folded byte, as in the JAX package; the
    result equals ``BASE_LUT[raw]`` for every byte value."""
    u = raw.to(torch.uint8) & 0xDF  # ASCII uppercase fold (clears bit 5)
    codes = torch.full(u.shape, N_CODE, dtype=torch.int8, device=u.device)
    for code, base in enumerate(b"ACGT"):
        codes = torch.where(u == base, code, codes).to(torch.int8)
    return codes


def codes_to_onehot(
    codes: torch.Tensor, num_channels: int = NUM_CHANNELS, dtype: torch.dtype = torch.uint8
) -> torch.Tensor:
    """int codes ``(...,)`` -> one-hot ``(..., num_channels)``; a code outside
    ``[0, num_channels)`` gives an all-zero row (``codes[..., None] == iota``)."""
    iota = torch.arange(num_channels, dtype=codes.dtype, device=codes.device)
    return (codes[..., None] == iota).to(dtype)


def encode_ascii_onehot(raw: torch.Tensor, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """ASCII bytes -> one-hot rows ``(..., NUM_CHANNELS)``."""
    return codes_to_onehot(ascii_to_codes(raw), dtype=dtype)
