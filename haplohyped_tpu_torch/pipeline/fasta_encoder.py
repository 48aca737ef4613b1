"""FASTA -> one-hot reference-genome HDF5.

The JAX package's layout, dataset for dataset: one temp file a chromosome,
``{chrom}.h5`` under ``{out_dir}/tmp_chrom_files``, holding a ``sequence``
(N, 5) uint8 one-hot (channels in encode-spec order ``[A, C, G, T, N]``) and
a ``codes`` (N,) int8 dataset, both Blosc 32001 with cd_values
``(0, 2, 0, 0, 5, 1, 2)`` (gzip where Blosc is unavailable), merged into
``{out_dir}/reference_genome.h5`` under ``{chrom}/``; chr1..chr22 by
default; the chromosomes fan out over threads; the temp directory is
removed.

The encode runs as torch ops on ``device`` (:func:`encode_onehot_and_codes`);
``device="cpu"`` runs the same ops on the CPU.  A CUDA failure raises: there
is no probe of the link and no fall-back to numpy.  :func:`encode_host` is
the numpy version the tests hold it against.  h5py is imported only where a
file is read or written, so :func:`encode_onehot_and_codes` runs on a machine
without it.

    python -m haplohyped_tpu_torch.pipeline.fasta_encoder --fasta hg38.fa --outdir out
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import FastaEncodeConfig, resolve_device
from haplohyped_tpu_torch.core.constants import CODES_DATASET_NAME, SEQUENCE_DATASET_NAME
from haplohyped_tpu_torch.hostio.fasta import FastaReader
from haplohyped_tpu_torch.ops.onehot import ascii_to_codes, codes_to_onehot
from haplohyped_tpu_torch.storage.blosc import (
    read_dataset,
    reference_compression_kwargs,
    set_blosc_nthreads,
)
from haplohyped_tpu_torch.storage.fastwrite import write_dataset_direct
from haplohyped_tpu_torch.utils.bitpack import index_to_onehot
from haplohyped_tpu_torch.utils.common_utils import (
    encode_sequence,
    nucleotide_to_index,
    parse_encode_dict,
)

logger = logging.getLogger("haplohyped_tpu_torch.fasta_encoder")

#: chunk rows of the ``sequence`` datasets (``codes``: 4x) — keeps random
#: window reads cheap
_SEQ_CHUNK_ROWS = 1 << 16


def encode_host(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 ASCII bytes -> (one-hot uint8 (N, 5), codes int8 (N,)) in numpy."""
    codes = nucleotide_to_index(arr.view("|S1"))
    return index_to_onehot(codes), codes


def encode_onehot_and_codes(
    raw: bytes | np.ndarray, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """ASCII bytes -> (one-hot uint8 (N, 5), codes int8 (N,)) as host arrays,
    encoded by torch ops on ``device``."""
    dev = resolve_device(device)
    arr = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, bytes) else raw
    # the host bytes are only read: copy a read-only buffer rather than share it
    src = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    codes = ascii_to_codes(src.to(dev))
    onehot = codes_to_onehot(codes)
    return onehot.cpu().numpy(), codes.cpu().numpy()


class ReferenceGenome:
    """Encode a reference FASTA into per-chromosome one-hot HDF5 files."""

    def __init__(
        self,
        fasta_file: str | None = None,
        encode_spec=None,
        output_dir: str | None = None,
        write_codes: bool = True,
        write_workers: int | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.encode_spec = parse_encode_dict(encode_spec)
        self.output_dir = output_dir
        self.fasta_file = fasta_file
        self.write_codes = write_codes
        self.write_workers = write_workers or (os.cpu_count() or 4)
        self.genome_files: list[tuple[str, str]] = []

    def encode_sequence(self, seq_data, ignore_case: bool = True) -> np.ndarray:
        return encode_sequence(seq_data, self.encode_spec, ignore_case)

    def load_chromosome(self, chrom: str) -> tuple[str, str]:
        """Encode one chromosome into ``{output_dir}/{chrom}.h5``."""
        import h5py

        logger.info("Encoding chromosome %s from FASTA file %s", chrom, self.fasta_file)
        with FastaReader(self.fasta_file) as fasta:
            raw = fasta.fetch(chrom)
        onehot, codes = encode_onehot_and_codes(raw, self.device)
        tmp_h5_file = os.path.join(self.output_dir, f"{chrom}.h5")
        n_ch = onehot.shape[1] if onehot.size else len(self.encode_spec)
        with h5py.File(tmp_h5_file, "w") as f:
            # the direct-chunk writer compresses outside the HDF5 lock, which
            # the per-chromosome threads would otherwise queue on
            write_dataset_direct(
                f, SEQUENCE_DATASET_NAME, onehot,
                reference_compression_kwargs(
                    chunks=(min(_SEQ_CHUNK_ROWS, max(1, onehot.shape[0])), n_ch)),
                workers=self.write_workers,
            )
            if self.write_codes:
                write_dataset_direct(
                    f, CODES_DATASET_NAME, codes,
                    reference_compression_kwargs(
                        chunks=(min(_SEQ_CHUNK_ROWS * 4, max(1, codes.shape[0])),)),
                    workers=self.write_workers,
                )
        logger.info("Finished encoding and saving chromosome %s to %s", chrom, tmp_h5_file)
        return chrom, tmp_h5_file

    def load_genome_parallel(self, chromosomes=None, cores: int | None = None):
        chrom_list = list(chromosomes) if chromosomes else [f"chr{i}" for i in range(1, 23)]
        logger.info("Starting parallel encoding of genome")
        with ThreadPoolExecutor(max_workers=cores or os.cpu_count()) as executor:
            self.genome_files = list(executor.map(self.load_chromosome, chrom_list))
        logger.info("Finished parallel encoding of genome")
        return self.genome_files

    def get_sequence(self, chrom: str, start: int, end: int) -> np.ndarray:
        import h5py

        path = dict(self.genome_files)[chrom]
        with h5py.File(path, "r") as f:
            return np.array(read_dataset(f[SEQUENCE_DATASET_NAME], slice(start, end)),
                            dtype=np.int8)


class HDF5Handler:
    """Merge per-chromosome temp files into one reference HDF5."""

    @staticmethod
    def merge_h5_files(tmp_dir: str, final_h5_file: str) -> None:
        """Copy every ``{chrom}.h5`` of ``tmp_dir`` into ``{chrom}/`` of
        ``final_h5_file`` (the h5py copy keeps each dataset's filters)."""
        import h5py

        logger.info("Merging HDF5 files from %s to %s", tmp_dir, final_h5_file)
        with h5py.File(final_h5_file, "a") as final_file:
            for tmp_file in sorted(os.listdir(tmp_dir)):
                if not tmp_file.endswith(".h5"):
                    continue
                chrom = tmp_file[: -len(".h5")]
                with h5py.File(os.path.join(tmp_dir, tmp_file), "r") as tmp:
                    grp = final_file.require_group(chrom)
                    for dset in tmp.keys():
                        if dset in grp:
                            del grp[dset]
                        tmp.copy(dset, grp, name=dset)
        logger.info("Finished merging HDF5 files")

    @staticmethod
    def load_from_hdf5(hdf5_file: str) -> dict[str, np.ndarray]:
        import h5py

        with h5py.File(hdf5_file, "r") as f:
            return {chrom: read_dataset(f[chrom][SEQUENCE_DATASET_NAME]) for chrom in f.keys()}


def encode_fasta(cfg: FastaEncodeConfig, device: str | torch.device = "cuda") -> str:
    """Run the whole FASTA encode under ``cfg``; returns the final file's path."""
    dev = resolve_device(device)
    set_blosc_nthreads(cfg.cores)
    os.makedirs(cfg.tmp_dir, exist_ok=True)
    # the merge appends into the final file: a leftover file from an earlier
    # run would contribute stale chromosome groups
    if os.path.exists(cfg.final_h5_path):
        os.remove(cfg.final_h5_path)
    try:
        ref = ReferenceGenome(fasta_file=cfg.fasta_path, output_dir=cfg.tmp_dir,
                              write_codes=cfg.write_codes, device=dev)
        with FastaReader(cfg.fasta_path) as fasta:
            present = set(fasta.names())
        chroms = [c for c in cfg.chromosomes if c in present]
        missing = [c for c in cfg.chromosomes if c not in present]
        if missing:
            logger.warning("chromosomes absent from FASTA, skipped: %s", missing)
        ref.load_genome_parallel(chromosomes=chroms, cores=cfg.cores)
        HDF5Handler.merge_h5_files(cfg.tmp_dir, cfg.final_h5_path)
    finally:
        shutil.rmtree(cfg.tmp_dir, ignore_errors=True)
    logger.info("Reference genome HDF5 file created at %s", cfg.final_h5_path)
    return cfg.final_h5_path


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m haplohyped_tpu_torch.pipeline.fasta_encoder",
        description="Encode a reference genome FASTA into a one-hot HDF5.",
    )
    ap.add_argument("--fasta", required=True, help="Reference FASTA (plain or gzip)")
    ap.add_argument("--outdir", required=True, help="Output folder")
    ap.add_argument("--cores", type=int, default=os.cpu_count(), help="Worker threads")
    ap.add_argument("--chromosomes", default=None,
                    help="Comma-separated chromosome names (default chr1..chr22)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> None:
    """Encode a reference genome FASTA into a one-hot HDF5."""
    ap = _parser()
    args = ap.parse_args(argv)
    if not os.path.exists(args.fasta):
        ap.error(f"--fasta {args.fasta!r} does not exist")
    logging.basicConfig(level=logging.INFO)
    cfg = FastaEncodeConfig(fasta_path=args.fasta, out_dir=args.outdir, cores=args.cores)
    if args.chromosomes:
        cfg = cfg.replace(chromosomes=tuple(args.chromosomes.split(",")))
    encode_fasta(cfg, device=args.device)


if __name__ == "__main__":
    main()
