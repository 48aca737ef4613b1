"""The sampler's deployment, made on the device from a seed: the benchmark's
copy of ``haplohyped_tpu_torch/tools/deployment.py::make_state``, with its
sizes read from the configuration's ``deployment`` group.

Chromosomes at the lengths given (random A/C/G/T codes, N past each end up
to a multiple of 128), ``n_donors`` donors with SNVs at ``snv_per_bp`` on
every chromosome (REF the genome's base, ALT another code, phases uniform,
positions strictly increasing), and ``n_regions`` BED spans of 200-2,000 bp.
The same seed and sizes give the same state on any device kind that draws
``torch.Generator`` streams alike (one CUDA card and the next do).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1
N_CODE = 4


class State(NamedTuple):
    names: list
    codes: torch.Tensor  # (G,) int8, chromosomes padded to a multiple of 128
    offsets: np.ndarray  # (C,) int64
    lengths: np.ndarray  # (C,) int64
    pos: torch.Tensor  # (D, C, V) int32, sorted per row, padded INT32_MAX
    ref: torch.Tensor  # (D, C, V) int8
    alt: torch.Tensor  # (D, C, V) int8
    p1: torch.Tensor  # (D, C, V) int8
    p2: torch.Tensor  # (D, C, V) int8
    counts: torch.Tensor  # (D, C) int32
    regions: np.ndarray  # (R, 2) int64 spans


def make_state(deployment: dict, seed: int, device: torch.device) -> State:
    """The deployment of ``deployment`` (``chromosomes``: name to length,
    ``n_donors``, ``snv_per_bp``, ``n_regions``) drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    names = list(deployment["chromosomes"])
    lengths = np.array(list(deployment["chromosomes"].values()), np.int64)
    padded = -(-lengths // 128) * 128
    offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
    G = int(padded.sum())
    if G > 2**31:
        raise ValueError("flat offsets must fit int32")
    codes = torch.randint(0, 4, (G,), dtype=torch.int8, device=device, generator=g)
    for off, n, p in zip(offsets, lengths, padded):
        codes[off + n: off + p] = N_CODE
    cohort = _cohort(codes, offsets, lengths, deployment["n_donors"],
                     deployment["snv_per_bp"], g)
    regions = _regions(lengths, deployment["n_regions"], seed)
    return State(names, codes, offsets, lengths, *cohort, regions)


def _cohort(codes, offsets, lengths, n_donors: int, rate: float, g: torch.Generator):
    device = codes.device
    # positions: a cumulative sum of gaps uniform on [1, 2/rate - 1] (mean
    # 1/rate), so rows come sorted; V leaves room for +0.5% on the longest
    C = len(lengths)
    V = -(-int(lengths.max() * rate * 1.005) // 128) * 128
    gap_hi = round(2 / rate) - 1
    pos = torch.empty((n_donors, C, V), dtype=torch.int32, device=device)
    ref, alt, p1, p2 = (torch.empty((n_donors, C, V), dtype=torch.int8, device=device)
                        for _ in range(4))
    counts = torch.empty((n_donors, C), dtype=torch.int32, device=device)
    len_t = torch.as_tensor(lengths, device=device)[:, None]
    off_t = torch.as_tensor(offsets, device=device)[:, None]
    for d in range(n_donors):
        gaps = torch.randint(1, gap_hi + 1, (C, V), dtype=torch.int32, device=device, generator=g)
        p = torch.cumsum(gaps, dim=1, dtype=torch.int32) - 1
        valid = p < len_t
        r = codes[off_t + torch.minimum(p, len_t - 1)]
        a = (r + torch.randint(1, 4, (C, V), dtype=torch.int8, device=device, generator=g)) % 4
        ph = torch.randint(0, 2, (2, C, V), dtype=torch.int8, device=device, generator=g)
        pos[d] = torch.where(valid, p, INT32_MAX)
        ref[d] = torch.where(valid, r, 0)
        alt[d] = torch.where(valid, a, 0)
        p1[d] = torch.where(valid, ph[0], 0)
        p2[d] = torch.where(valid, ph[1], 0)
        counts[d] = valid.sum(dim=1, dtype=torch.int32)
    return pos, ref, alt, p1, p2, counts


def _regions(lengths: np.ndarray, n_regions: int, seed: int) -> np.ndarray:
    """``(n_regions, 2)`` int64 spans of 200-2,000 bp on chromosomes drawn by
    length, uniform within each (every chromosome longer than 2,000 bp)."""
    rng = np.random.default_rng(seed)
    rc = rng.choice(len(lengths), size=n_regions, p=lengths / lengths.sum())
    s = (rng.random(n_regions) * (lengths[rc] - 2000)).astype(np.int64)
    return np.stack([s, s + rng.integers(200, 2001, n_regions)], axis=1)
