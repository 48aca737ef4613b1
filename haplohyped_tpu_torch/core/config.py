"""Sampler, converter, FASTA-encoder and mesh configuration, and device resolution."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Sequence

import torch

from haplohyped_tpu_torch.core.constants import (
    AUTOSOMES,
    DEFAULT_SEQ_LENGTH,
    VCF_FILENAME_PATTERN,
)

#: window-encode implementations the port has
WINDOW_KERNELS = ("auto", "baseline", "kernel")

#: names the JAX package accepts that this package does not, with the reason
_NOT_PORTED = {
    "pallas": "'pallas' is the JAX package's TPU kernel; its counterpart here "
    "is window_kernel='kernel' (the hand-written Hopper kernel)",
    "fast": "'fast' (encode_haplotype_windows_fast) restructures the encode "
    "for TPU gather cost and is not ported; use window_kernel='kernel' (the "
    "Hopper kernel) or 'baseline' (the plain PyTorch version)",
}


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh layout for sharded conversion and training.

    Axis semantics:
      - ``data``:  batch / donor-shard data parallelism
      - ``model``: tensor parallelism of the flagship model
    """

    data: int = 1
    model: int = 1
    axis_names: tuple[str, str] = ("data", "model")

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class SamplerConfig:
    """On-device haplotype window sampler configuration."""

    seq_length: int = DEFAULT_SEQ_LENGTH
    batch_size: int = 1
    seed: int = 42
    #: cap on variants applied per window; windows with more in-window SNPs
    #: apply the first ``max_variants_per_window`` and report the rest as
    #: overflow
    max_variants_per_window: int = 128
    #: window encode and draws: "kernel" (the Hopper kernels), "baseline"
    #: (their plain PyTorch versions), or "auto" — the kernels on a CUDA
    #: device, the baseline on the CPU
    window_kernel: str = "auto"

    def __post_init__(self):
        if self.window_kernel in _NOT_PORTED:
            raise ValueError(_NOT_PORTED[self.window_kernel])
        if self.window_kernel not in WINDOW_KERNELS:
            raise ValueError(
                f"unknown window_kernel {self.window_kernel!r}; "
                f"expected one of {WINDOW_KERNELS}"
            )

    def resolved_kernel(self, device: torch.device) -> str:
        """The implementation ``window_kernel`` selects on ``device``."""
        if self.window_kernel == "auto":
            return "kernel" if device.type == "cuda" else "baseline"
        return self.window_kernel


@dataclass(frozen=True)
class ConvertConfig:
    """Configuration of the VCF -> cohort-HDF5 conversion (the JAX
    package's ``ConvertConfig``, field for field)."""

    cohort_name: str
    vcf_dir: str
    out_dir: str
    sample_list_path: str
    #: host worker threads fanning out over donors
    cores: int = field(default_factory=lambda: os.cpu_count() or 1)
    #: native decompression/framing threads per task
    cxx_threads: int = 4
    chromosomes: tuple[int, ...] = AUTOSOMES
    vcf_pattern: str = VCF_FILENAME_PATTERN
    #: skip (donor, chrom) shards whose temp artifact already exists
    resume: bool = False
    #: decode the framed records on the converter's device (torch ops and
    #: the Hopper kernels on CUDA, the kernels' plain versions on the CPU)
    #: instead of numpy
    device_decode: bool = True
    #: where the 12-byte framer refuses a file (> 255 contigs), tokenize its
    #: raw text on the device (``ops/vcf_tokenize.py``) before the 64-byte
    #: route; off by default, as in the JAX package
    use_tokenizer: bool = False
    #: frame each chromosome once for every donor (False: once per donor)
    single_pass: bool = True
    #: stream datasets into the final file (single-pass only)
    direct_write: bool = True

    @property
    def tmp_dir(self) -> str:
        return os.path.join(self.out_dir, "tmp_files")

    @property
    def final_h5_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.cohort_name}.h5")

    def vcf_path(self, chromosome: int | str) -> str:
        return os.path.join(self.vcf_dir, self.vcf_pattern.format(chromosome=chromosome))

    def replace(self, **kw) -> "ConvertConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FastaEncodeConfig:
    """Configuration of the FASTA -> one-hot reference-genome HDF5 encoding."""

    fasta_path: str
    out_dir: str
    cores: int = field(default_factory=lambda: os.cpu_count() or 1)
    chromosomes: tuple[str, ...] = tuple(f"chr{i}" for i in AUTOSOMES)
    #: additionally store int8 base-code datasets for fast device loading
    write_codes: bool = True

    @property
    def tmp_dir(self) -> str:
        return os.path.join(self.out_dir, "tmp_chrom_files")

    @property
    def final_h5_path(self) -> str:
        return os.path.join(self.out_dir, "reference_genome.h5")

    def replace(self, **kw) -> "FastaEncodeConfig":
        return dataclasses.replace(self, **kw)


def chrom_list(chromosomes: Sequence[int | str]) -> list[str]:
    """Chromosome identifiers in the ``chr{n}`` form."""
    return [s if s.startswith("chr") else f"chr{s}" for s in map(str, chromosomes)]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without a usable card raises: nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
