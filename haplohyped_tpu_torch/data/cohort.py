"""Cohort variant tensors.

Lifts the cohort HDF5 (``donor_{id}/chr_{n}/snp_data`` structured arrays)
into dense, padded arrays indexed ``(donor, chrom, variant)`` so the sampler
can gather any (donor, chrom) span on the device.  Ragged variant counts
become a ``counts`` array plus ``INT32_MAX`` position padding, which keeps
every (d, c) position row sorted for the window searches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.constants import BASE_LUT, INT32_MAX


@dataclass
class CohortTensors:
    """Arrays are numpy on the host; a container may also hold torch tensors
    already on their device (``device_arrays`` then returns them as they
    are)."""

    donors: list[str]
    chrom_names: list[str]  # index space of the chrom axis, e.g. ["chr21", "chr22"]
    pos: np.ndarray | torch.Tensor  # (D, C, V) int32, sorted per (d, c), padded INT32_MAX
    ref_code: np.ndarray | torch.Tensor  # (D, C, V) int8
    alt_code: np.ndarray | torch.Tensor  # (D, C, V) int8
    phase1: np.ndarray | torch.Tensor  # (D, C, V) int8
    phase2: np.ndarray | torch.Tensor  # (D, C, V) int8
    counts: np.ndarray | torch.Tensor  # (D, C) int32

    @property
    def num_donors(self) -> int:
        return len(self.donors)

    @property
    def max_variants(self) -> int:
        return int(self.pos.shape[2])

    @classmethod
    def from_structs(
        cls,
        tables: dict[tuple[str, str], np.ndarray],
        donors: list[str],
        chrom_names: list[str],
        pad_to: int | None = None,
    ) -> "CohortTensors":
        """Build from ``{(donor, chrom_name): snp_struct}`` tables."""
        D, C = len(donors), len(chrom_names)
        vmax = max((t.shape[0] for t in tables.values()), default=0)
        if pad_to is not None:
            vmax = max(vmax, pad_to)
        vmax = max(vmax, 1)
        # V rounded up to a multiple of 128, as in the JAX package
        vmax = -(-vmax // 128) * 128

        pos = np.full((D, C, vmax), INT32_MAX, dtype=np.int32)
        ref_code = np.zeros((D, C, vmax), dtype=np.int8)
        alt_code = np.zeros((D, C, vmax), dtype=np.int8)
        phase1 = np.zeros((D, C, vmax), dtype=np.int8)
        phase2 = np.zeros((D, C, vmax), dtype=np.int8)
        counts = np.zeros((D, C), dtype=np.int32)

        for (donor, chrom), t in tables.items():
            d = donors.index(donor)
            c = chrom_names.index(chrom)
            n = t.shape[0]
            if n == 0:
                continue
            starts = t["start"].astype(np.int64)
            order = np.argsort(starts, kind="stable")
            starts = starts[order]
            ref_b = np.frombuffer(t["ref"][order].tobytes(), dtype=np.uint8).reshape(n, 10)[:, 0]
            alt_b = np.frombuffer(t["alt"][order].tobytes(), dtype=np.uint8).reshape(n, 10)[:, 0]
            pos[d, c, :n] = starts.astype(np.int32)
            ref_code[d, c, :n] = BASE_LUT[ref_b]
            alt_code[d, c, :n] = BASE_LUT[alt_b]
            phase1[d, c, :n] = t["phase1"][order]
            phase2[d, c, :n] = t["phase2"][order]
            counts[d, c] = n

        return cls(
            donors=list(donors),
            chrom_names=list(chrom_names),
            pos=pos,
            ref_code=ref_code,
            alt_code=alt_code,
            phase1=phase1,
            phase2=phase2,
            counts=counts,
        )

    @classmethod
    def from_h5(
        cls,
        cohort_h5: str,
        donors: list[str] | None = None,
        chrom_names: list[str] | None = None,
    ) -> "CohortTensors":
        """Load a cohort HDF5 produced by the converter (or the reference)."""
        from haplohyped_tpu_torch.storage.h5_reader import VCFH5Reader

        with VCFH5Reader(cohort_h5) as reader:
            if donors is None:
                donors = sorted(reader.donors())
            if chrom_names is None:
                nums = sorted(
                    {c for d in donors for c in reader.chromosomes(d)},
                    key=lambda x: (len(x), x),
                )
                chrom_names = [f"chr{c}" for c in nums]
            tables = {}
            for d in donors:
                for c in reader.chromosomes(d):
                    name = f"chr{c}"
                    if name in chrom_names:
                        tables[(d, name)] = reader.fetch_genotypes(d, c)
        return cls.from_structs(tables, donors, chrom_names)

    def device_arrays(self, device: str | torch.device = "cuda"):
        """``(pos, ref_code, alt_code, phase1, phase2, counts)`` as tensors on
        ``device``."""
        dev = resolve_device(device)
        return tuple(
            torch.as_tensor(a, device=dev)
            for a in (
                self.pos, self.ref_code, self.alt_code,
                self.phase1, self.phase2, self.counts,
            )
        )
