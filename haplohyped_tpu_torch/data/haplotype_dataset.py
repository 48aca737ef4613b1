"""Random variant-aware haplotype windows as a torch ``Dataset`` (the host
path, for ``DataLoader`` users).

The constructor and the draws of the JAX package's ``RandomHaplotypeDataset``:
``np.random.RandomState(seed)`` draws a region, a donor and a chromosome for
each window, in that order; the window is the region's midpoint crop,
clamped inside the chromosome; it starts from the reference codes, and each
in-window SNV takes its ALT where the phase bit is 1, else its REF.  Items
are ``(hap1, hap2)`` CPU float32 one-hot tensors of (B, L, 5).  Its device
twin is :class:`haplohyped_tpu_torch.data.sampler.DeviceHaplotypeSampler`,
which draws the same windows on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import Dataset

from haplohyped_tpu_torch.core.constants import BASE_LUT, NUM_CHANNELS
from haplohyped_tpu_torch.data.regions import calculate_midpoint_region, load_bed_regions
from haplohyped_tpu_torch.storage.h5_reader import VCFH5Reader
from haplohyped_tpu_torch.storage.reference import ReferenceGenomeReader
from haplohyped_tpu_torch.utils.common_utils import parse_encode_dict


def encode_haplotypes_host(
    ref_codes: np.ndarray,  # (L,) int8 window codes
    genotype_struct: np.ndarray,  # SNP_STRUCT_DTYPE rows of one (donor, chrom)
    start: int,
    end: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The variant-aware window encode in numpy: ``(hap1, hap2)`` int8 codes.

    On a duplicate position the later row wins, as numpy's fancy assignment
    resolves it (``torch.Tensor.index_put_`` does not promise an order)."""
    L = end - start
    hap1 = np.array(ref_codes[:L], dtype=np.int8, copy=True)
    hap2 = hap1.copy()
    pos = genotype_struct["start"].astype(np.int64)
    in_win = (pos >= start) & (pos < end)
    if in_win.any():
        t = genotype_struct[in_win]
        rel = t["start"].astype(np.int64) - start
        ref_b = np.frombuffer(t["ref"].tobytes(), dtype=np.uint8).reshape(-1, 10)[:, 0]
        alt_b = np.frombuffer(t["alt"].tobytes(), dtype=np.uint8).reshape(-1, 10)[:, 0]
        ref_c = BASE_LUT[ref_b]
        alt_c = BASE_LUT[alt_b]
        hap1[rel] = np.where(t["phase1"] == 1, alt_c, ref_c)
        hap2[rel] = np.where(t["phase2"] == 1, alt_c, ref_c)
    return hap1, hap2


class RandomHaplotypeDataset(Dataset):
    """Random variant-aware haplotype windows as CPU float32 tensors."""

    def __init__(
        self,
        bed_file: str,
        hdf5_genotype_file: str,
        hdf5_reference_file: str,
        samples_file: str,
        encode_spec=None,
        seed: int = 42,
        batch_size: int = 1,
        seq_length: int = 1000,
    ):
        _, self.region_spans, _ = load_bed_regions(bed_file)
        self.vcf_reader = VCFH5Reader(hdf5_genotype_file)
        self.reference_genome = ReferenceGenomeReader(hdf5_reference_file, encode_spec)
        self.encode_spec = parse_encode_dict(encode_spec)
        self.donor_ids = self.read_samples(samples_file)
        self.chromosomes = [
            f"chr{c}" for c in sorted(
                {c for d in self.donor_ids for c in self.vcf_reader.chromosomes(d)},
                key=lambda x: (len(x), x),
            )
        ]
        self.batch_size = batch_size
        self.seq_length = seq_length
        self._rng = np.random.RandomState(seed)
        self.num_samples = int(self.region_spans.shape[0])
        self._geno_cache: dict[tuple[str, str], np.ndarray] = {}

    def read_samples(self, samples_file: str) -> list[str]:
        with open(samples_file) as f:
            return [line.strip() for line in f if line.strip()]

    def set_random_seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.num_samples

    def _fetch_genotypes(self, donor_id: str, chrom: str) -> np.ndarray:
        key = (donor_id, chrom)
        if key not in self._geno_cache:
            self._geno_cache[key] = self.vcf_reader.fetch_genotypes(
                donor_id, chrom.removeprefix("chr")
            )
        return self._geno_cache[key]

    def sample_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """One batch as numpy float32 one-hot arrays (B, L, C)."""
        eye = np.eye(NUM_CHANNELS, dtype=np.float32)
        hap1_batch, hap2_batch = [], []
        for _ in range(self.batch_size):
            region_idx = self._rng.randint(0, self.num_samples)
            donor_idx = self._rng.randint(0, len(self.donor_ids))
            chrom_idx = self._rng.randint(0, len(self.chromosomes))

            start, end = self.region_spans[region_idx]
            donor_id = self.donor_ids[donor_idx]
            chrom = self.chromosomes[chrom_idx]

            new_start, _ = calculate_midpoint_region(start, end, self.seq_length)
            chrom_len = self.reference_genome.length(chrom)
            # clamp the fixed-length window inside the chromosome
            new_start = min(new_start, max(0, chrom_len - self.seq_length))
            new_end = new_start + self.seq_length

            ref_codes = self.reference_genome.get_codes(chrom, new_start, new_end)
            genotype_data = self._fetch_genotypes(donor_id, chrom)
            hap1, hap2 = encode_haplotypes_host(ref_codes, genotype_data, new_start, new_end)
            hap1_batch.append(eye[hap1])
            hap2_batch.append(eye[hap2])
        return np.stack(hap1_batch), np.stack(hap2_batch)

    def __getitem__(self, idx):
        """``idx`` is ignored: every item is a random draw, as in the JAX
        package."""
        hap1, hap2 = self.sample_numpy()
        return torch.from_numpy(hap1), torch.from_numpy(hap2)

    def close(self) -> None:
        self.vcf_reader.close()
        self.reference_genome.close()
