"""BCF (binary VCF) input.

The port's copy of ``haplohyped_tpu.hostio.bcf``: the native BCF parser
(``cpp/bcf.cpp``) read into the decode schemas the VCF paths produce, so
struct assembly and everything after it does not know the input's format.
BCF decoding is host work, as in the JAX package.
"""

from __future__ import annotations

import gzip

import numpy as np

from haplohyped_tpu_torch.core.constants import BASE_LUT
from haplohyped_tpu_torch.hostio import native


def is_bcf(path: str) -> bool:
    """True if the file is a BCF2, plain or BGZF-wrapped (its bytes, or its
    first gzip member's, start with ``BCF\\x02``).  Reads 4 bytes of the
    file or of its inflated start (the native ``hh_is_bcf`` reads the whole
    file, so it is not bound), and raises ``FileNotFoundError`` for a
    missing file."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(b"\x1f\x8b"):
        try:
            with gzip.open(path, "rb") as f:
                head = f.read(4)
        except (OSError, EOFError):
            return False
    return head == b"BCF\x02"


def bcf_samples(path: str, threads: int = 1) -> list[str]:
    return native.bcf_samples(path, threads)


def bcf_decoded_v2(
    path: str, samples: list[str], threads: int = 1
) -> tuple[dict[str, np.ndarray], list[str]]:
    """One parse of the file for every donor in ``samples``, in the schema
    of ``decode_frames_v2`` (host numpy; genotype columns ``(N, S)``): the
    BCF leg of the single-pass converter.  Returns ``(decoded, chrom_table)``."""
    header = native.bcf_samples(path, threads)
    index_of = {s: i for i, s in enumerate(header)}
    missing = [s for s in samples if s not in index_of]
    if missing:
        raise RuntimeError(f"sample not found in BCF header: {missing[0]}")
    raw = native.bcf_parse_v2(path, np.asarray([index_of[s] for s in samples], np.int32),
                              threads)
    contigs = raw["contigs"]
    rid = np.clip(raw["rid"], 0, max(len(contigs) - 1, 0))
    decoded = {
        "start": raw["start"].astype(np.uint32),
        "stop": raw["stop"].astype(np.uint32),
        "ref_char": raw["ref_char"],
        "alt_char": raw["alt_char"],
        "snp_mask": (raw["snp_flags"] & 1) != 0,
        "chrom_id": rid.astype(np.uint8),
        "valid": raw["valid"] != 0,
        "phase1": raw["phase1"],
        "phase2": raw["phase2"],
    }
    return decoded, contigs


def bcf_decoded_columns(path: str, sample: str | None, threads: int = 1) -> dict[str, np.ndarray]:
    """One sample's parse of a BCF, in the per-donor decode schema with the
    64-byte frames' zero-padded ``chrom`` bytes."""
    raw = native.bcf_parse(path, sample, threads)
    n = raw["start"].shape[0]
    contigs = raw["contigs"]
    names = np.zeros((max(len(contigs), 1), 8), np.uint8)
    for i, c in enumerate(contigs):
        b = c.encode()[:8]
        names[i, :len(b)] = np.frombuffer(b, np.uint8)
    chrom = names[np.clip(raw["rid"], 0, names.shape[0] - 1)]
    flags = raw["bcf_flags"]
    return {
        "start": raw["start"].astype(np.uint32),
        "stop": raw["stop"].astype(np.uint32),
        "ref_char": raw["ref_char"],
        "alt_char": raw["alt_char"],
        "ref_code": BASE_LUT[raw["ref_char"]],
        "alt_code": BASE_LUT[raw["alt_char"]],
        "phase1": raw["phase1"],
        "phase2": raw["phase2"],
        "phased": (flags & 8) != 0,
        "missing": (flags & 4) != 0,
        "snp_mask": (flags & 1) != 0,
        "valid": (flags & 2) != 0,
        "chrom": chrom,
        "chrom_len": (chrom != 0).sum(axis=1).astype(np.int32),
        "long_line": np.zeros(n, bool),
    }
