"""haplohyped_tpu_torch — the PyTorch/CUDA port of haplohyped_tpu for one
NVIDIA H100.

It holds the training path (cohort and reference HDF5 to device tensors,
the variant-aware haplotype window encode on a hand-written Hopper kernel
beside its plain PyTorch version, the on-device sampler, and the
HaploFormer model with its train step, fused sample-into-train step,
checkpoints and ``train_on_sampler`` in ``models/``) and the VCF/BCF ->
cohort-HDF5 converter (``pipeline.vcf_to_h5.VCFtoHDF5Converter``: the
single pass, every donor of a chromosome from one framing decoded by torch
ops, and the per-donor path, its record decode on two more Hopper
kernels), the FASTA -> reference-HDF5 encoder (``pipeline.fasta_encoder``:
the one-hot as torch ops) with its FASTA readers and faidx index, the genome
codecs (``ops.pack``), the host ``data.RandomHaplotypeDataset``, an
argparse CLI with a doctor (``pipeline.main``), and the parallel layer on
``torch.distributed`` (``parallel``: a ``('data', 'model')`` process mesh
with its parameter rules, collectives, a position-sharded genome, the
sharded converter and multi-process set-up; the train step's ``mesh=``).  It imports torch and numpy (h5py and libblosc only where
an HDF5 file is read or written), and nothing of JAX or ``haplohyped_tpu``.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

from haplohyped_tpu_torch.core.config import MeshConfig, SamplerConfig
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.data.regions import load_bed_regions
from haplohyped_tpu_torch.data.sampler import DeviceHaplotypeSampler, HaplotypeBatch
from haplohyped_tpu_torch.models.enformer import Enformer, EnformerConfig
from haplohyped_tpu_torch.models.granite_hybrid import GraniteHybrid, GraniteHybridConfig
from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.models.nemotron_h import NemotronH, NemotronHConfig
from haplohyped_tpu_torch.models.train import train_on_sampler
from haplohyped_tpu_torch.version import __version__

__all__ = [
    "CohortTensors",
    "DeviceHaplotypeSampler",
    "Enformer",
    "EnformerConfig",
    "GenomeTensors",
    "GraniteHybrid",
    "GraniteHybridConfig",
    "HaploFormer",
    "HaploFormerConfig",
    "HaplotypeBatch",
    "MeshConfig",
    "NemotronH",
    "NemotronHConfig",
    "SamplerConfig",
    "load_bed_regions",
    "train_on_sampler",
    "__version__",
]
