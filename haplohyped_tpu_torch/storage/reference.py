"""Reference-genome HDF5 reader (read side of ``ReferenceGenomeReader``).

Reads the ``{chrom}/sequence`` one-hot layout the FASTA encoder writes, and
the optional ``{chrom}/codes`` int8 dataset beside it.
"""

from __future__ import annotations

import numpy as np

from haplohyped_tpu_torch.core.constants import (
    CODES_DATASET_NAME,
    SEQUENCE_DATASET_NAME,
)
from haplohyped_tpu_torch.storage.blosc import read_dataset
from haplohyped_tpu_torch.utils.common_utils import parse_encode_dict


class ReferenceGenomeReader:
    def __init__(self, h5_file: str, encode_spec=None):
        import h5py

        self.h5_path = h5_file
        self.h5_file = h5py.File(h5_file, "r")
        #: the channel order of the one-hot the file was written with
        self.encode_spec = parse_encode_dict(encode_spec)

    def chromosomes(self) -> list[str]:
        return list(self.h5_file.keys())

    def length(self, chrom: str) -> int:
        return self.h5_file[chrom][SEQUENCE_DATASET_NAME].shape[0]

    def get_sequence(self, chrom: str, start: int, end: int) -> np.ndarray:
        """One-hot slice ``(end-start, channels)`` (int8)."""
        seq = read_dataset(self.h5_file[chrom][SEQUENCE_DATASET_NAME], slice(start, end))
        return np.asarray(seq, dtype=np.int8)

    def get_codes(self, chrom: str, start: int | None = None, end: int | None = None) -> np.ndarray:
        """Int8 base codes: the ``codes`` dataset where there is one, else the
        argmax over the one-hot ``sequence``."""
        grp = self.h5_file[chrom]
        sl = slice(start, end)
        if CODES_DATASET_NAME in grp:
            return np.asarray(read_dataset(grp[CODES_DATASET_NAME], sl), dtype=np.int8)
        onehot = np.asarray(read_dataset(grp[SEQUENCE_DATASET_NAME], sl))
        return np.argmax(onehot, axis=1).astype(np.int8)

    def close(self) -> None:
        self.h5_file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
