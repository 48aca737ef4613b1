"""On-device sampling + training on the PyTorch port, end to end.

The counterpart of ``examples/02_device_sampler_training.py``: the port's
converter and FASTA encoder write the HDF5 artifacts, ``DeviceHaplotypeSampler``
holds the genome and cohort on ``--device`` and draws variant-aware
haplotype windows there (the Hopper window kernel on a card, its plain
version on the CPU), and ``train_on_sampler`` trains a HaploFormer on them
with no host data path.  ``sample_chain`` then runs dependent sampling links
(one CUDA graph on a card) and returns one digest.

Run from the repo root:
    python examples/torch/02_device_sampler_training.py [--device cuda|cpu] [--steps N]
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
    ap.add_argument("--steps", type=int, default=100, help="train steps (default 100)")
    args = ap.parse_args()

    from haplohyped_tpu_torch import DeviceHaplotypeSampler, HaploFormerConfig, SamplerConfig
    from haplohyped_tpu_torch.core.config import FastaEncodeConfig
    from haplohyped_tpu_torch.models.train import train_on_sampler
    from haplohyped_tpu_torch.pipeline import VCFtoHDF5Converter
    from haplohyped_tpu_torch.pipeline.fasta_encoder import encode_fasta

    outdir = tempfile.mkdtemp(prefix="hh_torch_train_")
    samples = os.path.join(DATA, "ipscs_samples_test.txt")
    converter = VCFtoHDF5Converter(
        cohort_name="train_cohort",
        vcf_dir=DATA,
        out_dir=outdir,
        sample_list_path=samples,
        cores=2,
        cxx_threads=2,
        chromosomes=[22],
        device=args.device,
    )
    converter.run()
    ref_h5 = encode_fasta(
        FastaEncodeConfig(
            fasta_path=os.path.join(DATA, "chr22.fasta"),
            out_dir=outdir,
            cores=2,
            chromosomes=("chr22",),
        ),
        device=args.device,
    )

    sampler = DeviceHaplotypeSampler.from_files(
        bed_file=os.path.join(DATA, "test_regions.bed"),
        cohort_h5=converter.config.final_h5_path,
        reference_h5=ref_h5,
        samples_file=samples,
        config=SamplerConfig(seq_length=1000, batch_size=16, seed=0),
        device=args.device,
    )
    cfg = HaploFormerConfig(d_model=128, num_heads=4, num_layers=2)
    state, losses = train_on_sampler(sampler, cfg, steps=args.steps,
                                     log_every=max(1, args.steps // 5))
    print(f"trained {state.step} steps on {sampler.device}; "
          f"losses: {[round(v, 4) for v in losses]}")

    digest = sampler.sample_chain(4, 2)
    print(f"sample_chain(4, 2): digest {int(digest)} over "
          f"{4 * 2 * sampler.config.batch_size} device-resident windows")


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO)
    main()
