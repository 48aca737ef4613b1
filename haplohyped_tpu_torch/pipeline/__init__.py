"""Pipelines: the VCF -> cohort-HDF5 converter and the FASTA -> reference-HDF5
encoder."""

from haplohyped_tpu_torch.pipeline.fasta_encoder import HDF5Handler, ReferenceGenome
from haplohyped_tpu_torch.pipeline.records import snp_struct_from_frames
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import VCFtoHDF5Converter

__all__ = [
    "snp_struct_from_frames",
    "VCFtoHDF5Converter",
    "ReferenceGenome",
    "HDF5Handler",
]
