"""Bit-packed nucleotide codecs as torch ops on the input's device (the
counterpart of ``haplohyped_tpu.ops.pack``, XLA code there).

2 bits a base plus an N mask keeps a whole human genome under 1 GB of device
memory.  Pack and unpack are bit-equal to the numpy codecs of
:mod:`haplohyped_tpu_torch.utils.bitpack` at every length (the JAX functions
take lengths that are a multiple of 4, or 2 for the 4-bit codec; here shorter
tails pad as numpy pads them).  The N mask is little-endian by bit
(``np.packbits(..., bitorder="little")``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from haplohyped_tpu_torch.core.constants import N_CODE


def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_2bit_device(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes (n,) -> (packed uint8 ceil(n/4), n_mask uint8 ceil(n/8)).

    N positions pack as 0; the mask restores them on unpack."""
    c = codes.reshape(-1).to(torch.uint8)
    is_n = c == N_CODE
    two = F.pad(c.masked_fill(is_n, 0) & 0x3, (0, -c.numel() % 4))
    q = two.view(-1, 4)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    bits = F.pad(is_n.to(torch.uint8), (0, -c.numel() % 8)).view(-1, 8)
    n_mask = (bits << _bit_weights(c.device)).sum(dim=1).to(torch.uint8)
    return packed, n_mask


def unpack_2bit_device(packed: torch.Tensor, n_mask: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_2bit_device` -> int8 codes (``4 * len(packed)``
    of them; slice off a pad tail)."""
    p = packed.to(torch.uint8)
    out = torch.stack([p & 0x3, (p >> 2) & 0x3, (p >> 4) & 0x3, (p >> 6) & 0x3], dim=1)
    out = out.reshape(-1)
    is_n = ((n_mask.to(torch.uint8)[:, None] >> _bit_weights(p.device)) & 1).reshape(-1)
    return out.masked_fill(is_n[: out.numel()].bool(), N_CODE).to(torch.int8)


def pack_4bit_device(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes (n,) -> nibble-packed uint8 (two codes a byte, ceil(n/2))."""
    c = codes.reshape(-1).to(torch.uint8)
    c = F.pad(c, (0, c.numel() % 2)).view(-1, 2)
    return (c[:, 0] & 0xF) | (c[:, 1] << 4)


def unpack_4bit_device(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_4bit_device` -> int8 codes (``2 * len(packed)``)."""
    p = packed.to(torch.uint8)
    return torch.stack([p & 0xF, p >> 4], dim=1).reshape(-1).to(torch.int8)


def gather_window_2bit(
    packed: torch.Tensor, n_mask: torch.Tensor, start, *, L: int
) -> torch.Tensor:
    """The codes ``[start, start + L)`` straight from the packed form.

    ``start`` is an int or an integer tensor of any shape (one window each;
    the result is ``start.shape + (L,)`` int8).  Each base is read from the
    byte that holds it and each flag from its mask byte, so a window never
    clamps or shifts: every ``start`` in ``[0, n - L]`` gives exactly the
    window (the JAX function's fixed-size slices of ``L // 4 + 1`` bytes
    clamp near the end and miss bases where ``start % 4 + L`` exceeds them).
    An int start outside ``[0, 4 * len(packed) - L]`` raises ``ValueError``;
    tensor starts are not checked (that would wait for the device)."""
    dev = packed.device
    if isinstance(start, int) and not 0 <= start <= 4 * packed.numel() - L:
        raise ValueError(f"start {start} outside [0, {4 * packed.numel() - L}] for L={L}")
    s = torch.as_tensor(start, dtype=torch.int64, device=dev)
    idx = s[..., None] + torch.arange(L, dtype=torch.int64, device=dev)
    base = (packed[idx >> 2] >> ((idx & 3) * 2).to(torch.uint8)) & 0x3
    is_n = (n_mask[idx >> 3] >> (idx & 7).to(torch.uint8)) & 1
    return base.masked_fill(is_n.bool(), N_CODE).to(torch.int8)
