"""Host I/O: VCF framing, BGZF and VCF/BCF writing, the variant table and
FASTA access (the native library built from ``cpp/``)."""
from haplohyped_tpu_torch.hostio.frame_format import (
    REC_SIZE,
    FramedRecords,
    frames_to_fields,
)
from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.hostio.fasta import FastaReader
from haplohyped_tpu_torch.hostio.native import native_available
from haplohyped_tpu_torch.hostio.bgzf import BgzfWriter, bgzf_compress, bgzf_write
from haplohyped_tpu_torch.hostio.writer import BcfWriter, VcfHeader, VcfWriter
from haplohyped_tpu_torch.hostio.variants import VariantTable

__all__ = [
    "REC_SIZE",
    "FramedRecords",
    "frames_to_fields",
    "VCFSource",
    "FastaReader",
    "native_available",
    "BgzfWriter",
    "bgzf_compress",
    "bgzf_write",
    "BcfWriter",
    "VcfHeader",
    "VcfWriter",
    "VariantTable",
]
