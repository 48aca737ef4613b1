"""The sampler's deployment-sized state, made on the device from a seed.

The GRCh38 autosomes chr1-chr12 at their true lengths (random codes), 128
donors with SNVs at ~1.2 per kb per chromosome, and 100,000 BED regions of
200-2,000 bp.  ``chip_smoke.py`` samples from it, and the window-kernel lab
measures on its chr1 (``--state deployment``).  ``make_cohort`` and
``make_regions`` make the same cohort and regions over another genome
(``chip_smoke.py`` phase 15: the genome read from a FASTA).
"""

from __future__ import annotations

import numpy as np
import torch

from haplohyped_tpu_torch.core.constants import INT32_MAX, N_CODE
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors

#: GRCh38 primary-assembly lengths of chr1-chr12 (2,077,042,982 bp): the
#: largest set of autosomes whose concatenation int32 ``offsets`` address
GRCH38_CHR1_12 = {
    "chr1": 248_956_422, "chr2": 242_193_529, "chr3": 198_295_559,
    "chr4": 190_214_555, "chr5": 181_538_259, "chr6": 170_805_979,
    "chr7": 159_345_973, "chr8": 145_138_636, "chr9": 138_394_717,
    "chr10": 133_797_422, "chr11": 135_086_622, "chr12": 133_275_309,
}
N_DONORS = 128
SNV_PER_BP = 1.2e-3  # one human genome against the reference
N_REGIONS = 100_000


def make_state(seed: int, device: torch.device):
    """``(genome, cohort, regions)``: genome and cohort tensors on ``device``
    and the ``(N_REGIONS, 2)`` int64 region spans."""
    g = torch.Generator(device=device).manual_seed(seed)
    names = list(GRCH38_CHR1_12)
    lengths = np.array(list(GRCH38_CHR1_12.values()), np.int64)
    padded = -(-lengths // 128) * 128
    offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
    G = int(padded.sum())
    if offsets[-1] >= 2**31:
        raise ValueError("flat offsets must fit int32")
    codes = torch.randint(0, 4, (G,), dtype=torch.int8, device=device, generator=g)
    for off, n, p in zip(offsets, lengths, padded):
        codes[off + n : off + p] = N_CODE
    genome = GenomeTensors(names, codes, offsets.astype(np.int32), lengths.astype(np.int32))

    cohort = make_cohort(codes, offsets, lengths, names, N_DONORS, g)
    return genome, cohort, make_regions(lengths, N_REGIONS, seed)


def make_cohort(codes: torch.Tensor, offsets: np.ndarray, lengths: np.ndarray,
                names: list[str], n_donors: int, g: torch.Generator) -> CohortTensors:
    """``n_donors`` donors with SNVs at ``SNV_PER_BP`` on every chromosome of
    a genome (flat ``codes`` on the device, chromosome ``offsets`` and
    ``lengths``), drawn from ``g``: REF is the genome's base, ALT another
    code, phases uniform."""
    device = codes.device
    # positions: a cumulative sum of gaps uniform on [1, 2/rate - 1] (mean
    # 1/rate), so rows come sorted; V leaves room for +0.5% on the longest
    C = len(names)
    V = -(-int(lengths.max() * SNV_PER_BP * 1.005) // 128) * 128
    gap_hi = round(2 / SNV_PER_BP) - 1
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
        r = codes[off_t + torch.minimum(p, len_t - 1)]  # REF is the genome's base
        a = (r + torch.randint(1, 4, (C, V), dtype=torch.int8, device=device, generator=g)) % 4
        ph = torch.randint(0, 2, (2, C, V), dtype=torch.int8, device=device, generator=g)
        pos[d] = torch.where(valid, p, INT32_MAX)
        ref[d] = torch.where(valid, r, 0)
        alt[d] = torch.where(valid, a, 0)
        p1[d] = torch.where(valid, ph[0], 0)
        p2[d] = torch.where(valid, ph[1], 0)
        counts[d] = valid.sum(dim=1, dtype=torch.int32)
    donors = [f"donor{d:03d}" for d in range(n_donors)]
    return CohortTensors(donors, list(names), pos, ref, alt, p1, p2, counts)


def make_regions(lengths: np.ndarray, n_regions: int, seed: int) -> np.ndarray:
    """``(n_regions, 2)`` int64 BED spans of 200-2,000 bp on chromosomes drawn
    by length, uniform within each (every chromosome longer than 2,000 bp)."""
    rng = np.random.default_rng(seed)
    rc = rng.choice(len(lengths), size=n_regions, p=lengths / lengths.sum())
    s = (rng.random(n_regions) * (lengths[rc] - 2000)).astype(np.int64)
    return np.stack([s, s + rng.integers(200, 2001, n_regions)], axis=1)
