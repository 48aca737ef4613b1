"""Basic pipeline on the PyTorch port: VCF cohort + FASTA -> HDF5 artifacts ->
genotype tables read back.

The counterpart of ``examples/01_basic_pipeline.py``, through
``haplohyped_tpu_torch`` alone: the converter decodes every donor of a
chromosome from one framing (torch ops on ``--device``), and the FASTA
encoder one-hots the reference on the same device.

Run from the repo root:
    python examples/torch/01_basic_pipeline.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from haplohyped_tpu_torch.core.config import FastaEncodeConfig
    from haplohyped_tpu_torch.pipeline import VCFtoHDF5Converter
    from haplohyped_tpu_torch.pipeline.fasta_encoder import encode_fasta
    from haplohyped_tpu_torch.storage import VCFH5Reader

    outdir = tempfile.mkdtemp(prefix="hh_torch_example_")
    print(f"output -> {outdir}")

    # 1. cohort VCF -> genotype HDF5 --------------------------------------
    converter = VCFtoHDF5Converter(
        cohort_name="example_cohort",
        vcf_dir=DATA,
        out_dir=outdir,
        sample_list_path=os.path.join(DATA, "ipscs_samples_test.txt"),
        cores=2,
        cxx_threads=2,
        chromosomes=[22],
        device=args.device,
    )
    results = converter.run()
    print(f"converted {sum(r.n_snps for r in results)} SNPs "
          f"across {len(results)} (donor, chromosome) tasks")

    # 2. reference FASTA -> one-hot HDF5 ----------------------------------
    ref_h5 = encode_fasta(
        FastaEncodeConfig(
            fasta_path=os.path.join(DATA, "chr22.fasta"),
            out_dir=outdir,
            cores=2,
            chromosomes=("chr22",),
        ),
        device=args.device,
    )
    print(f"reference genome -> {ref_h5}")

    # 3. read back --------------------------------------------------------
    with VCFH5Reader(converter.config.final_h5_path) as reader:
        donor = reader.donors()[0]
        table = reader.fetch_genotypes(donor, 22)
        print(f"donor {donor}: {table.shape[0]} SNPs, first: {table[0]}")


if __name__ == "__main__":
    main()
