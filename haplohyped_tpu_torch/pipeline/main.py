"""The umbrella CLI of the port: one subcommand a tool.

    python -m haplohyped_tpu_torch.pipeline.main {vcf_to_h5,fasta_encoder,doctor,faidx} ...

Each subcommand hands its arguments to that tool's own ``main``.
"""

from __future__ import annotations

import argparse
import sys

from haplohyped_tpu_torch.hostio.fai import build_fai
from haplohyped_tpu_torch.pipeline import doctor, fasta_encoder, vcf_to_h5


def _faidx(argv) -> None:
    """Build a samtools-compatible ``.fai`` index for a plain FASTA."""
    ap = argparse.ArgumentParser(prog="haplohyped_torch faidx", description=_faidx.__doc__)
    ap.add_argument("fasta", help="Plain (uncompressed) FASTA")
    args = ap.parse_args(argv)
    records = build_fai(args.fasta)
    print(f"{args.fasta}.fai: {len(records)} sequences indexed")


#: subcommand -> (its main, one line of help)
COMMANDS = {
    "vcf_to_h5": (vcf_to_h5.main, "Convert per-chromosome cohort VCFs to a genotype HDF5"),
    "fasta_encoder": (fasta_encoder.main, "Encode a reference FASTA into a one-hot HDF5"),
    "doctor": (doctor.main, "Check the runtime environment"),
    "faidx": (_faidx, "Build a samtools-compatible .fai index for a plain FASTA"),
}


def main(argv=None) -> None:
    """haplohyped_tpu_torch — the PyTorch/CUDA genotype-tensor engine."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="haplohyped_torch", description=main.__doc__)
    sub = ap.add_subparsers(dest="command", required=True, metavar="COMMAND")
    for name, (_, text) in COMMANDS.items():
        sub.add_parser(name, help=text, add_help=False)
    args = ap.parse_args(argv[:1])
    COMMANDS[args.command][0](argv[1:])


if __name__ == "__main__":
    main()
