"""ASCII bases to int8 base codes, as torch ops (``haplohyped_tpu.ops.onehot``)."""

from __future__ import annotations

import torch

from haplohyped_tpu_torch.core.constants import N_CODE


def ascii_to_codes(raw: torch.Tensor) -> torch.Tensor:
    """uint8 ASCII bytes -> int8 base codes (unknown -> N), case-folded.

    Four compares against the case-folded byte, as in the JAX package; the
    result equals ``BASE_LUT[raw]`` for every byte value."""
    u = raw.to(torch.uint8) & 0xDF  # ASCII uppercase fold (clears bit 5)
    codes = torch.full(u.shape, N_CODE, dtype=torch.int8, device=u.device)
    for code, base in enumerate(b"ACGT"):
        codes = torch.where(u == base, code, codes).to(torch.int8)
    return codes
