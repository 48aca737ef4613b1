"""Frozen format constants of the PyTorch port.

The port's own copy of the values it shares with ``haplohyped_tpu.core.
constants`` (and ``INT32_MAX`` from ``haplohyped_tpu.data.cohort``).  The two
packages must agree on every value here: they read and write the same files
and the tests hold their tensors bit-equal.
"""

from __future__ import annotations

import numpy as np

#: Base -> integer code (column order of the one-hot channels).
DEFAULT_ENCODE_LIST: tuple[str, ...] = ("A", "C", "G", "T", "N")
DEFAULT_ENCODE_DICT: dict[str, int] = {b: i for i, b in enumerate(DEFAULT_ENCODE_LIST)}

#: Number of one-hot channels under the default spec.
NUM_CHANNELS: int = len(DEFAULT_ENCODE_LIST)

#: Code assigned to any base outside {A, C, G, T} (after uppercasing).
N_CODE: int = DEFAULT_ENCODE_LIST.index("N")

#: 256-entry ASCII byte -> code lookup table (both cases; everything else N).
BASE_LUT: np.ndarray = np.full(256, N_CODE, dtype=np.int8)
for _i, _b in enumerate(DEFAULT_ENCODE_LIST):
    BASE_LUT[ord(_b)] = _i
    BASE_LUT[ord(_b.lower())] = _i

#: Structured dtype of one SNP record in a cohort HDF5 (``snp_data``).
SNP_STRUCT_DTYPE = np.dtype(
    [
        ("chrom", "S5"),
        ("start", np.uint32),
        ("stop", np.uint32),
        ("ref", "S10"),
        ("alt", "S10"),
        ("phase1", np.int8),
        ("phase2", np.int8),
    ]
)

#: HDF5 filter id of Blosc.
BLOSC_FILTER_ID: int = 32001

#: cd_values of the cohort writer: (filter_version, blosc_version, typesize,
#: chunksize, clevel, shuffle, compcode) -- clevel 5, byte shuffle, LZ4HC.
#: The filter's ``set_local`` overwrites the first four at dataset creation.
COHORT_COMPRESSION_OPTS: tuple[int, ...] = (2, 2, 0, 0, 5, 1, 2)

#: cd_values of the per-chromosome reference writer (filter version 0).
REFERENCE_COMPRESSION_OPTS: tuple[int, ...] = (0, 2, 0, 0, 5, 1, 2)

#: Autosomes a conversion processes by default.
AUTOSOMES: tuple[int, ...] = tuple(range(1, 23))

#: Input VCF filename pattern: one file per chromosome, every sample inside.
VCF_FILENAME_PATTERN: str = "chr{chromosome}.filtered.vcf.gz"

#: Dataset holding SNP records inside a donor/chrom group.
SNP_DATASET_NAME: str = "snp_data"

#: Dataset holding the one-hot sequence inside a chromosome group.
SEQUENCE_DATASET_NAME: str = "sequence"

#: Optional dataset holding int8 base codes inside a chromosome group.
CODES_DATASET_NAME: str = "codes"

#: Default training window length.
DEFAULT_SEQ_LENGTH: int = 1000

#: Position padding of the cohort tensors (keeps every row sorted).
INT32_MAX: int = int(np.iinfo(np.int32).max)


def cohort_group_path(donor_id: str, chromosome: int | str) -> str:
    """HDF5 group path for one (donor, chromosome) SNP table."""
    return f"donor_{donor_id}/chr_{chromosome}"


def reference_dataset_path(chrom: str) -> str:
    """HDF5 dataset path for one chromosome's one-hot sequence."""
    return f"{chrom}/{SEQUENCE_DATASET_NAME}"
