"""Reference-genome tensors.

All chromosomes live as one flat int8 code array (concatenated, each padded
to a multiple of 128 with N), so a window is one slice from
``offsets[chrom] + start``.  ``offsets`` and ``lengths`` are int32, as in the
JAX package; flat addresses are formed in 64 bits where they are used.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.constants import BASE_LUT, N_CODE


@dataclass
class GenomeTensors:
    chrom_names: list[str]
    #: (G,) int8 — a numpy array, or a torch tensor already on its device
    codes_flat: np.ndarray | torch.Tensor
    offsets: np.ndarray  # (C,) int32 — start of each chrom in codes_flat
    lengths: np.ndarray  # (C,) int32 — true base count per chrom

    @classmethod
    def from_code_arrays(cls, chroms: dict[str, np.ndarray]) -> "GenomeTensors":
        names = list(chroms.keys())
        offsets, lengths, parts = [], [], []
        cursor = 0
        for name in names:
            codes = np.asarray(chroms[name], dtype=np.int8).ravel()
            offsets.append(cursor)
            lengths.append(codes.size)
            pad = (-codes.size) % 128
            if pad:
                codes = np.concatenate([codes, np.full(pad, N_CODE, np.int8)])
            parts.append(codes)
            cursor += codes.size
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int8)
        return cls(
            chrom_names=names,
            codes_flat=flat,
            offsets=np.asarray(offsets, np.int32),
            lengths=np.asarray(lengths, np.int32),
        )

    @classmethod
    def from_h5(cls, reference_h5: str, chrom_names: list[str] | None = None) -> "GenomeTensors":
        """Load from a reference-genome HDF5 (``{chrom}/sequence`` layout)."""
        from haplohyped_tpu_torch.storage.reference import ReferenceGenomeReader

        with ReferenceGenomeReader(reference_h5) as ref:
            if chrom_names is None:
                chrom_names = ref.chromosomes()
            chroms = {name: ref.get_codes(name) for name in chrom_names}
        return cls.from_code_arrays(chroms)

    @classmethod
    def from_fasta(cls, fasta_path: str, chrom_names: list[str] | None = None) -> "GenomeTensors":
        """Load from a FASTA (every record by default), bases through
        ``BASE_LUT`` on the host."""
        from haplohyped_tpu_torch.hostio.fasta import FastaReader

        with FastaReader(fasta_path) as fa:
            if chrom_names is None:
                chrom_names = fa.names()
            chroms = {
                name: BASE_LUT[np.frombuffer(fa.fetch(name), dtype=np.uint8)]
                for name in chrom_names
            }
        return cls.from_code_arrays(chroms)

    def device_arrays(self, device: str | torch.device = "cuda"):
        """``(codes_flat, offsets, lengths)`` as tensors on ``device``."""
        dev = resolve_device(device)
        return tuple(
            torch.as_tensor(a, device=dev)
            for a in (self.codes_flat, self.offsets, self.lengths)
        )
