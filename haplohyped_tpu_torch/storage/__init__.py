"""storage layer of haplohyped_tpu_torch (h5py is imported only where a file
is read or written)."""

from haplohyped_tpu_torch.storage.blosc import (
    blosc_available,
    cohort_compression_kwargs,
    reference_compression_kwargs,
    register_blosc_filter,
)
from haplohyped_tpu_torch.storage.h5_reader import VCFH5Reader
from haplohyped_tpu_torch.storage.reference import ReferenceGenomeReader

__all__ = [
    "blosc_available",
    "cohort_compression_kwargs",
    "reference_compression_kwargs",
    "register_blosc_filter",
    "VCFH5Reader",
    "ReferenceGenomeReader",
]
