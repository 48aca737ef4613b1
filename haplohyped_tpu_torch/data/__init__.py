"""data layer of haplohyped_tpu_torch."""

from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.data.haplotype_dataset import RandomHaplotypeDataset
from haplohyped_tpu_torch.data.regions import calculate_midpoint_region, load_bed_regions
from haplohyped_tpu_torch.data.sampler import DeviceHaplotypeSampler

__all__ = [
    "RandomHaplotypeDataset",
    "CohortTensors",
    "GenomeTensors",
    "load_bed_regions",
    "calculate_midpoint_region",
    "DeviceHaplotypeSampler",
]
