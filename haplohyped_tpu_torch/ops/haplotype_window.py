"""Variant-aware haplotype window encoding: the plain PyTorch version.

Each haplotype window starts as the reference-genome codes; every in-window
variant position is then overwritten with the variant's ALT code where that
haplotype's phase bit is 1, else with its REF code.  The first ``K``
in-window variants are applied; the rest are counted as overflow.

:func:`encode_haplotype_windows` is the ground truth of the port.  It follows
the JAX package's ``_one_window`` step for step, with batched tensor ops:

- the genome slice starts at ``offsets[c] + s``, clamped to ``[0, G - L]``
  (``jax.lax.dynamic_slice``'s clamp);
- ``lo``/``hi`` are ``searchsorted(side="left")`` of ``s`` and ``s + L`` in
  the (donor, chrom) position row, each clamped to the row's count;
- the first ``min(n_in, K)`` variants from ``lo`` are applied; on duplicate
  positions the last one wins (a ``(B, K, L)`` match and max, never a
  scatter, whose order on CUDA is undefined);
- ``overflow = max(n_in - K, 0)``.

It runs on any device.  The Hopper kernel (:mod:`.window_kernel`) is held
bit-equal against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: elements of the largest intermediate the plain version materialises per
#: chunk of windows (rows of V positions, or the (b, K, L) match)
_CHUNK_ELEMS = 1 << 24


class HaplotypeWindows(NamedTuple):
    hap1: torch.Tensor  # (B, L) int8 codes
    hap2: torch.Tensor  # (B, L) int8 codes
    n_variants: torch.Tensor  # (B,) int32 — in-window variant count (before the cap)
    overflow: torch.Tensor  # (B,) int32 — variants dropped by the K cap


def _encode_chunk(genome_flat, chrom_offsets, var_pos, var_ref, var_alt,
                  var_p1, var_p2, var_counts, donor_idx, chrom_idx, start, L, K):
    D, C, V = var_pos.shape
    dev = start.device
    # out-of-range indices clamp, as a JAX gather does
    d = donor_idx.long().clamp(0, D - 1)
    c = chrom_idx.long().clamp(0, C - 1)
    s = start.to(torch.int32)
    row = d * C + c

    flat = (chrom_offsets[c].long() + s.long()).clamp(0, genome_flat.shape[0] - L)
    window = genome_flat[flat[:, None] + torch.arange(L, device=dev)]  # (b, L)

    pos_rows = var_pos.reshape(D * C, V)[row]  # (b, V)
    lo = torch.searchsorted(pos_rows, s[:, None], side="left")[:, 0]
    hi = torch.searchsorted(pos_rows, (s + L)[:, None], side="left")[:, 0]
    count = var_counts.reshape(D * C)[row].long()
    n_in = (torch.minimum(hi, count) - torch.minimum(lo, count)).clamp(min=0)

    k = torch.arange(K, device=dev)
    take = (lo[:, None] + k).clamp(0, V - 1)  # (b, K)
    applied = k[None, :] < n_in.clamp(max=K)[:, None]
    pos = torch.gather(pos_rows, 1, take) - s[:, None]
    # unapplied lanes point past the window, so they match no output byte
    pos = torch.where(applied, pos, L)

    rows = row[:, None]
    ref = var_ref.reshape(D * C, V)[rows, take]
    alt = var_alt.reshape(D * C, V)[rows, take]
    sub1 = torch.where(var_p1.reshape(D * C, V)[rows, take] == 1, alt, ref)
    sub2 = torch.where(var_p2.reshape(D * C, V)[rows, take] == 1, alt, ref)

    out_pos = torch.arange(L, dtype=pos.dtype, device=dev)
    match = pos[:, :, None] == out_pos[None, None, :]  # (b, K, L)
    prio = torch.arange(1, K + 1, dtype=torch.int16, device=dev)[None, :, None]
    kbest = torch.where(match, prio, 0).amax(dim=1)  # (b, L): last match k + 1
    has = kbest > 0
    sel = (kbest.long() - 1).clamp(min=0)
    hap1 = torch.where(has, torch.gather(sub1, 1, sel), window)
    hap2 = torch.where(has, torch.gather(sub2, 1, sel), window)
    n_in = n_in.to(torch.int32)
    return hap1, hap2, n_in, (n_in - K).clamp(min=0)


def encode_haplotype_windows(
    genome_flat: torch.Tensor,  # (G,) int8 concatenated chrom codes
    chrom_offsets: torch.Tensor,  # (C,) int32
    var_pos: torch.Tensor,  # (D, C, V) int32 sorted per (d, c); pad INT32_MAX
    var_ref: torch.Tensor,  # (D, C, V) int8
    var_alt: torch.Tensor,  # (D, C, V) int8
    var_p1: torch.Tensor,  # (D, C, V) int8
    var_p2: torch.Tensor,  # (D, C, V) int8
    var_counts: torch.Tensor,  # (D, C) int32
    donor_idx: torch.Tensor,  # (B,) int32
    chrom_idx: torch.Tensor,  # (B,) int32
    start: torch.Tensor,  # (B,) int32 window start within chrom
    *,
    L: int,
    K: int,
) -> HaplotypeWindows:
    """Encode a batch of variant-aware haplotype windows (plain version)."""
    B = start.shape[0]
    V = var_pos.shape[2]
    if genome_flat.shape[0] < L:
        raise ValueError(f"genome of {genome_flat.shape[0]} codes is shorter than L={L}")
    # windows per chunk, so no intermediate exceeds _CHUNK_ELEMS elements
    step = max(1, _CHUNK_ELEMS // max(V, K * L))
    parts = [
        _encode_chunk(
            genome_flat, chrom_offsets, var_pos, var_ref, var_alt, var_p1,
            var_p2, var_counts, donor_idx[i : i + step], chrom_idx[i : i + step],
            start[i : i + step], L, K,
        )
        for i in range(0, max(B, 1), step)
    ]
    return HaplotypeWindows(*(torch.cat(p) for p in zip(*parts)))


def windows_to_onehot(
    codes: torch.Tensor, num_channels: int = 5, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(..., L) int8 codes -> (..., L, num_channels) one-hot."""
    iota = torch.arange(num_channels, dtype=codes.dtype, device=codes.device)
    return (codes[..., None] == iota).to(dtype)
