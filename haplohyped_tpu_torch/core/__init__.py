"""core layer of haplohyped_tpu_torch: format constants and configuration."""
from haplohyped_tpu_torch.core.constants import (
    AUTOSOMES,
    BLOSC_FILTER_ID,
    COHORT_COMPRESSION_OPTS,
    DEFAULT_ENCODE_DICT,
    DEFAULT_ENCODE_LIST,
    REFERENCE_COMPRESSION_OPTS,
    SNP_STRUCT_DTYPE,
    cohort_group_path,
    reference_dataset_path,
)
from haplohyped_tpu_torch.core.config import (
    ConvertConfig,
    FastaEncodeConfig,
    MeshConfig,
    SamplerConfig,
)

__all__ = [
    "AUTOSOMES",
    "BLOSC_FILTER_ID",
    "COHORT_COMPRESSION_OPTS",
    "DEFAULT_ENCODE_DICT",
    "DEFAULT_ENCODE_LIST",
    "REFERENCE_COMPRESSION_OPTS",
    "SNP_STRUCT_DTYPE",
    "cohort_group_path",
    "reference_dataset_path",
    "ConvertConfig",
    "FastaEncodeConfig",
    "MeshConfig",
    "SamplerConfig",
]
