"""Cohort genotype HDF5 reader (read side of ``VCFH5Reader``).

Reads the ``donor_{id}/chr_{n}/snp_data`` structured arrays the converter
writes.  Blosc-compressed datasets register the filter at first read.
"""

from __future__ import annotations

import numpy as np

from haplohyped_tpu_torch.core.constants import SNP_DATASET_NAME, cohort_group_path
from haplohyped_tpu_torch.storage.blosc import read_dataset


class VCFH5Reader:
    """Read SNP structured arrays from a cohort HDF5 file."""

    def __init__(self, h5_file: str):
        import h5py

        self.h5_path = h5_file
        self.h5_file = h5py.File(h5_file, "r")

    def fetch_genotypes(self, donor_id: str, chromosome: int | str) -> np.ndarray:
        """The SNP structured array of one (donor, chromosome)."""
        group_path = cohort_group_path(donor_id, chromosome)
        if group_path not in self.h5_file:
            raise KeyError(f"No data found for {group_path}")
        return read_dataset(self.h5_file[group_path][SNP_DATASET_NAME])

    def donors(self) -> list[str]:
        return [k[len("donor_") :] for k in self.h5_file.keys() if k.startswith("donor_")]

    def chromosomes(self, donor_id: str) -> list[str]:
        g = self.h5_file.get(f"donor_{donor_id}", {})
        return [k[len("chr_") :] for k in g.keys() if k.startswith("chr_")]

    def close(self) -> None:
        self.h5_file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
