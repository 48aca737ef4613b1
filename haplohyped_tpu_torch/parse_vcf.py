"""Tuple-level API of the reference's native ``parse_vcf`` module.

The port of ``haplohyped_tpu.parse_vcf``.  The reference exposes
``VCFLoader.load_vcf(in_vcf, sample, chrom)`` and
``VCFLoader.load_vcf_without_sample(in_vcf, chrom)`` from a pybind11 module
(``cpp/parse_vcf.cpp:116-124``), returning lists of
``(CHROM, Start, End, REF, ALT, phase1, phase2)`` and 5-tuples.  Here the
native framer and the numpy decode back them, on the host as in the JAX
package; the class methods and the module-level functions are both given.
"""

from __future__ import annotations

from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.ops.vcf_decode import decode_frames_numpy
from haplohyped_tpu_torch.pipeline.records import snp_struct_from_frames


def _load_struct(in_vcf: str, sample: str | None, chrom: str, threads: int = 1):
    framed = VCFSource(in_vcf, threads=threads).frame(sample=sample or None,
                                                       region=chrom or None)
    decoded = decode_frames_numpy(framed.records, with_sample=sample is not None)
    return snp_struct_from_frames(framed.records, decoded, with_sample=sample is not None)


def load_vcf(in_vcf: str, sample: str, chrom: str = "") -> list[tuple]:
    """SNP 7-tuples for one sample: (chrom, start, stop, ref, alt, p1, p2)."""
    return [
        (r["chrom"].decode(), int(r["start"]), int(r["stop"]), r["ref"].decode(),
         r["alt"].decode(), int(r["phase1"]), int(r["phase2"]))
        for r in _load_struct(in_vcf, sample, chrom)
    ]


def load_vcf_without_sample(in_vcf: str, chrom: str = "") -> list[tuple]:
    """SNP 5-tuples without genotypes: (chrom, start, stop, ref, alt)."""
    return [
        (r["chrom"].decode(), int(r["start"]), int(r["stop"]), r["ref"].decode(),
         r["alt"].decode())
        for r in _load_struct(in_vcf, None, chrom)
    ]


class VCFLoader:
    """Class form of the loader (the reference's binding surface)."""

    @staticmethod
    def load_vcf(in_vcf: str, sample: str, chrom: str = "") -> list[tuple]:
        return load_vcf(in_vcf, sample, chrom)

    @staticmethod
    def load_vcf_without_sample(in_vcf: str, chrom: str = "") -> list[tuple]:
        return load_vcf_without_sample(in_vcf, chrom)
