"""The sampler's plain reference: the draws, the window encode, the chain
digest and the chain, written from their definitions.

- Keys and draws are ``jax.random``'s threefry2x32 stream in its partitionable
  form with 64-bit types off: ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``;
  step ``s`` of key ``k`` draws under ``fold_in(k, s)``, split in three, one
  ``randint`` a field over ``[0, R)``, ``[0, D)`` and ``[0, C)`` (uint32
  arithmetic that wraps, so randint's multiplier ``(2^16 mod n)^2 mod n`` is
  0 above 2^16).  ``rounds`` is threefry's 20; the control hashes with fewer.
- A window is cropped around its region's midpoint, clamped into the drawn
  chromosome; its codes are the genome's, and each of the first ``K``
  variants of that (donor, chromosome) row inside the window is written over
  with ALT where the haplotype's phase is 1, else REF (the last one wins on a
  repeated position).  The variants are found by a binary search of the row
  and written by a max-scatter of their rank: another algorithm than the
  program's, with the same answer.
- A batch's digest is ``parity(sum hap1) ^ parity(sum hap2) << 1 ^ sum
  n_variants`` (mod 2^32); link ``k + 1`` of a chain draws under
  ``fold_in(key_k, digest_k)``; the chain's answer is the digests' sum.

Words are int64 tensors in ``[0, 2^32)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
#: threefry2x32's rounds, in groups of four
ROUNDS = 20


def threefry(k0, k1, x0, x1, rounds: int = ROUNDS):
    """threefry2x32 of the counter ``(x0, x1)`` under the key ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for group in range(rounds // 4):
        for r in _ROT[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    return 0, int(seed) & MASK32


def _fold_in(key, data, rounds):
    """``(..., 2)`` keys: ``fold_in`` of ``key`` (a (2,) tensor) and ``data``."""
    return torch.stack(threefry(key[..., 0], key[..., 1], 0, data & MASK32, rounds), -1)


def _bits(key, n: int, rounds):
    """``(..., n)`` 32 random bits of each key of ``(..., 2)``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry(key[..., :1], key[..., 1:], 0, i, rounds)
    return y0 ^ y1


def _randint(key, n: int, hi: int, rounds):
    """``randint(key, (n,), 0, hi)`` of every key of ``(..., 2)``."""
    span = hi if hi > 0 else 1
    mult = (((1 << 16) % span) ** 2 & MASK32) % span
    i = torch.arange(2, dtype=torch.int64, device=key.device)
    halves = torch.stack(threefry(key[..., None, 0], key[..., None, 1], 0, i, rounds), -1)
    h = _bits(halves[..., 0, :], n, rounds)
    lo = _bits(halves[..., 1, :], n, rounds)
    return (((((h % span) * mult) & MASK32) + lo % span) & MASK32) % span


class Draws(NamedTuple):
    key: torch.Tensor  # (2,) int64: the key of the call's steps
    region: torch.Tensor  # (n,) int64
    donor: torch.Tensor
    chrom: torch.Tensor
    start: torch.Tensor  # (n,) int64 window starts


def draws(key, step0: int, n_batches: int, B: int, regions: torch.Tensor,
          lengths: torch.Tensor, n_donors: int, L: int, digest=None,
          rounds: int = ROUNDS) -> Draws:
    """Steps ``step0 .. step0 + n_batches - 1`` of ``key`` (a (2,) int64
    tensor; ``fold_in(key, digest)`` first with a digest), batch-major, and
    each window's start.  ``regions`` (R, 2) and ``lengths`` (C,) int64."""
    if digest is not None:
        key = _fold_in(key, digest, rounds)
    steps = torch.arange(step0, step0 + n_batches, dtype=torch.int64, device=key.device)
    step_keys = _fold_in(key, steps, rounds)  # (n_batches, 2)
    i = torch.arange(3, dtype=torch.int64, device=key.device)
    fields = torch.stack(threefry(step_keys[:, None, 0], step_keys[:, None, 1], 0, i, rounds), -1)
    sizes = (regions.shape[0], n_donors, lengths.shape[0])
    r, d, c = (_randint(fields[:, f], B, size, rounds).reshape(-1)
               for f, size in enumerate(sizes))
    span = regions[r]
    mid = (span[:, 0] + span[:, 1]) // 2
    start = torch.minimum((mid - L // 2).clamp(min=0), (lengths[c] - L).clamp(min=0))
    return Draws(key, r, d, c, start)


class Windows(NamedTuple):
    hap1: torch.Tensor  # (n, L) int8
    hap2: torch.Tensor  # (n, L) int8
    n_variants: torch.Tensor  # (n,) int64, before the cap
    overflow: torch.Tensor  # (n,) int64


def _search(flat: torch.Tensor, base: torch.Tensor, V: int, target: torch.Tensor):
    """For each lane, the first index ``j`` in ``[0, V]`` of its sorted row
    ``flat[base : base + V]`` with ``row[j] >= target`` (side ``left``)."""
    lo = torch.zeros_like(target)
    hi = torch.full_like(target, V)
    for _ in range(max(V, 1).bit_length()):
        mid = (lo + hi) // 2
        below = flat[base + mid.clamp(max=V - 1)] < target
        below &= mid < hi
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    return lo


def encode(codes, offsets, pos, ref, alt, p1, p2, counts, donor, chrom, start,
           L: int, K: int, block: int = 4096) -> Windows:
    """The windows of the given draws, ``block`` windows at a time.
    ``offsets`` is (C,) int64 on the device; the cohort is (D, C, V)."""
    D, C, V = pos.shape
    G = codes.shape[0]
    flat_pos, flat_ref, flat_alt = pos.reshape(-1), ref.reshape(-1), alt.reshape(-1)
    flat_p1, flat_p2, flat_counts = p1.reshape(-1), p2.reshape(-1), counts.reshape(-1)
    parts = []
    dev = codes.device
    ar_l = torch.arange(L, device=dev)
    ar_k = torch.arange(K, device=dev)
    for i in range(0, donor.shape[0], block):
        d = donor[i: i + block].clamp(0, D - 1)
        c = chrom[i: i + block].clamp(0, C - 1)
        s = start[i: i + block]
        n = s.shape[0]
        row = d * C + c
        first = (offsets[c] + s).clamp(0, G - L)
        window = codes[first[:, None] + ar_l]
        base = row * V
        count = flat_counts[row].long()
        lo = _search(flat_pos, base, V, s)
        hi = _search(flat_pos, base, V, s + L)
        n_in = (torch.minimum(hi, count) - torch.minimum(lo, count)).clamp(min=0)
        take = base[:, None] + (lo[:, None] + ar_k).clamp(max=V - 1)
        applied = ar_k[None, :] < n_in.clamp(max=K)[:, None]
        at = flat_pos[take].long() - s[:, None]
        at = torch.where(applied & (at >= 0) & (at < L), at, L)  # L: nowhere
        rank = torch.zeros(n * (L + 1), dtype=torch.int64, device=dev)
        idx = (torch.arange(n, device=dev)[:, None] * (L + 1) + at).reshape(-1)
        rank.scatter_reduce_(0, idx, (ar_k + 1).expand(n, K).reshape(-1), "amax")
        rank = rank.view(n, L + 1)[:, :L]
        has = rank > 0
        sel = torch.gather(take, 1, (rank - 1).clamp(min=0))
        a, r = flat_alt[sel], flat_ref[sel]
        h1 = torch.where(has, torch.where(flat_p1[sel] == 1, a, r), window)
        h2 = torch.where(has, torch.where(flat_p2[sel] == 1, a, r), window)
        parts.append((h1.to(torch.int8), h2.to(torch.int8), n_in, (n_in - K).clamp(min=0)))
    return Windows(*(torch.cat(p) for p in zip(*parts)))


def digest(w: Windows) -> torch.Tensor:
    """() int64: the digest of a batch of windows."""
    p1 = w.hap1.long().sum() & 1
    p2 = w.hap2.long().sum() & 1
    return p1 ^ (p2 << 1) ^ (w.n_variants.sum() & MASK32)


class Chain(NamedTuple):
    digest: int  # the links' digests summed mod 2^32
    keys: torch.Tensor  # (n_chain, 2) int64
    last: Windows  # the last link's windows, batch-major


def chain(state, first_key: tuple[int, int], n_chain: int, n_batches: int, B: int,
          L: int, K: int, device, rounds: int = ROUNDS) -> Chain:
    """``sample_chain(n_chain, n_batches, key)`` from the state's raw
    tensors (``state.State``)."""
    args = _draw_args(state, device)
    key = torch.tensor(first_key, dtype=torch.int64, device=device)
    keys, digests, dg = [], [], None
    for _ in range(n_chain):
        dr = draws(key, 0, n_batches, B, *args, L, dg, rounds)
        win = encode(*encode_args(state, device), dr.donor, dr.chrom, dr.start, L, K)
        dg = digest(win)
        keys.append(dr.key)
        digests.append(dg)
        key = dr.key
    return Chain(int(torch.stack(digests).sum() & MASK32), torch.stack(keys), win)


def _draw_args(state, device):
    return (torch.as_tensor(state.regions, device=device),
            torch.as_tensor(state.lengths, device=device), state.pos.shape[0])


def encode_args(state, device) -> tuple:
    return (state.codes, torch.as_tensor(state.offsets, device=device), state.pos, state.ref,
            state.alt, state.p1, state.p2, state.counts)


def batch(state, seed: int, step: int, B: int, L: int, K: int, device) -> Windows:
    """Sampling step ``step`` of ``PRNGKey(seed)``: a batch of ``B`` windows."""
    key = torch.tensor(prng_key(seed), dtype=torch.int64, device=device)
    dr = draws(key, step, 1, B, *_draw_args(state, device), L)
    return encode(*encode_args(state, device), dr.donor, dr.chrom, dr.start, L, K)
