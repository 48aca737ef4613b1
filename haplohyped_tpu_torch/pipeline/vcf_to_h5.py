"""VCF -> cohort-HDF5 conversion, the per-donor path, on PyTorch.

The port of ``haplohyped_tpu.pipeline.vcf_to_h5`` for ``single_pass=False``
(the reference's shape): one task per (donor, chromosome) frames that
donor's records, decodes them, assembles the SNP struct and writes a temp
shard ``{cohort}_tmp_donor_{id}_chr_{n}.h5`` with group
``donor_{id}/chr_{n}/snp_data``; :meth:`VCFtoHDF5Converter.merge_h5_files`
copies the shards into ``{out_dir}/{cohort}.h5``.  Donors fan out over a
thread pool; every failed task is recorded, and ``resume=True`` skips shards
whose temp file exists.

The decode runs on ``device`` (CUDA unless the caller asks for the CPU):

- 12-byte frames (the default): upload, the decode12 Hopper kernel
  (``ops/decode_kernel.py``), three int32 columns back, unpack on the host;
- 64-byte frames, where the 12-byte framer refuses more than 255 contigs
  (a :meth:`~VCFtoHDF5Converter.parse_snps` without a region, of a file
  with that many): the same with the decode64 kernel and seven columns;
- an empty frame, and ``device_decode=False``, decode with numpy.

On ``device="cpu"`` the kernels' plain PyTorch versions run instead.  There
is no device probe and no host rerouting: a CUDA failure raises.  Not
ported yet, each raising ``NotImplementedError``: ``single_pass=True`` and
BCF input (``ROADMAP.md``).  The raw-text tokenizer route is not ported.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import ConvertConfig, resolve_device
from haplohyped_tpu_torch.core.constants import (
    AUTOSOMES,
    SNP_DATASET_NAME,
    VCF_FILENAME_PATTERN,
    cohort_group_path,
)
from haplohyped_tpu_torch.core.metrics import GLOBAL_METRICS
from haplohyped_tpu_torch.hostio.vcf import VCFSource, is_bcf
from haplohyped_tpu_torch.ops.decode_kernel import (
    decode_frames12_kernel,
    decode_frames_kernel,
)
from haplohyped_tpu_torch.ops.vcf_decode import (
    decode_frames12_numpy,
    decode_frames_numpy,
    unpack12_columns,
    unpack64_columns,
)
from haplohyped_tpu_torch.pipeline.records import (
    snp_struct_from_frames,
    snp_struct_from_frames12,
)
from haplohyped_tpu_torch.storage.blosc import cohort_compression_kwargs, set_blosc_nthreads
from haplohyped_tpu_torch.storage.fastwrite import write_dataset_direct

logger = logging.getLogger("haplohyped_tpu_torch.vcf_to_h5")

SINGLE_PASS_NOT_PORTED = (
    "single_pass=True (the single-pass v2 converter) is not ported yet; it is "
    "the next item of ROADMAP.md. Pass single_pass=False (--per-donor)."
)
BCF_NOT_PORTED = "BCF input is not ported yet; it is queued in ROADMAP.md."

#: serialises device decodes across the donor threads (one upload, launch
#: and copy back at a time; the launch counters stay exact)
_device_lock = threading.Lock()


@dataclass
class TaskResult:
    donor_id: str
    chromosome: int | str
    n_records: int = 0
    n_snps: int = 0
    seconds: float = 0.0
    skipped: bool = False
    error: Exception | None = None


def _decode12(frames12: np.ndarray, device: torch.device) -> dict[str, np.ndarray]:
    """Decode compact frames on ``device``: upload the ``(N, 12)`` frames,
    run the decode12 kernel (its plain version on the CPU), copy the three
    packed int32 columns back and unpack them on the host."""
    frames = torch.from_numpy(frames12).to(device)
    start, meta, ref_len = (c.cpu().numpy() for c in decode_frames12_kernel(frames))
    return unpack12_columns(start, meta, ref_len)


def _decode(frames: np.ndarray, device: torch.device | None) -> dict[str, np.ndarray]:
    """Decode ``(N, 64)`` frames on ``device`` with the decode64 kernel (its
    plain version on the CPU), or with numpy where ``device`` is None or the
    frame is empty."""
    if device is None or frames.shape[0] == 0:
        return decode_frames_numpy(frames)
    cols = decode_frames_kernel(torch.from_numpy(frames).to(device))
    return unpack64_columns(*(c.cpu().numpy() for c in cols))


class VCFtoHDF5Converter:
    """Convert per-chromosome cohort VCFs into one genotype HDF5."""

    def __init__(
        self,
        cohort_name: str,
        vcf_dir: str,
        out_dir: str,
        sample_list_path: str,
        cores: int,
        cxx_threads: int,
        *,
        resume: bool = False,
        device_decode: bool = True,
        chromosomes=None,
        single_pass: bool = True,
        direct_write: bool = True,
        device: str | torch.device = "cuda",
    ):
        if single_pass:
            raise NotImplementedError(SINGLE_PASS_NOT_PORTED)
        self.device = resolve_device(device)
        cfg = ConvertConfig(
            cohort_name=cohort_name,
            vcf_dir=vcf_dir,
            out_dir=out_dir,
            sample_list_path=sample_list_path,
            cores=cores,
            cxx_threads=cxx_threads,
            resume=resume,
            device_decode=device_decode,
            single_pass=single_pass,
            direct_write=direct_write,
        )
        if chromosomes is not None:
            cfg = cfg.replace(chromosomes=tuple(chromosomes))
        self.config = cfg

        self.cohort_name = cfg.cohort_name
        self.vcf_dir = cfg.vcf_dir
        self.out_dir = cfg.out_dir
        self.sample_list_path = cfg.sample_list_path
        self.cores = cfg.cores
        self.cxx_threads = cfg.cxx_threads
        self.donor_ids = self.read_sample_list(cfg.sample_list_path)
        self.chromosomes = cfg.chromosomes
        self.tmp_dir = cfg.tmp_dir
        os.makedirs(self.tmp_dir, exist_ok=True)
        set_blosc_nthreads(cfg.cxx_threads)
        self.results: list[TaskResult] = []

    # -- inputs ---------------------------------------------------------

    def read_sample_list(self, sample_list_path: str) -> list[str]:
        """One donor ID per line."""
        with open(sample_list_path, "r") as f:
            return [line.strip() for line in f]

    # -- per-task unit --------------------------------------------------

    def tmp_h5_path(self, donor_id: str, chromosome: int | str) -> str:
        return os.path.join(
            self.tmp_dir,
            f"{self.cohort_name}_tmp_donor_{donor_id}_chr_{chromosome}.h5",
        )

    def genotype_vcf_to_hdf5(
        self, data_path: str, donor_id: str, chromosome: int | str
    ) -> TaskResult:
        """Convert one (donor, chromosome) into its temp HDF5 shard."""
        import h5py

        res = TaskResult(donor_id=donor_id, chromosome=chromosome)
        t0 = time.time()
        tmp_h5_file = self.tmp_h5_path(donor_id, chromosome)
        if self.config.resume and os.path.exists(tmp_h5_file):
            res.skipped = True
            return res
        try:
            chrom_str = f"chr{chromosome}"
            if donor_id:
                with GLOBAL_METRICS.timer("parse"):
                    snp_struct, n_records = self.parse_snps(data_path, donor_id, chrom_str)
                res.n_records = n_records
                res.n_snps = int(snp_struct.shape[0])
                GLOBAL_METRICS.count("records_seen", n_records)
                GLOBAL_METRICS.count("snps", res.n_snps)

                with GLOBAL_METRICS.timer("h5_write"), h5py.File(tmp_h5_file, "w") as h5f:
                    group = h5f.create_group(cohort_group_path(donor_id, chromosome))
                    write_dataset_direct(
                        group,
                        SNP_DATASET_NAME,
                        snp_struct,
                        cohort_compression_kwargs(snp_struct.shape[0]),
                        workers=self.cxx_threads,
                    )
                GLOBAL_METRICS.count("h5_bytes", snp_struct.nbytes)
                logger.info(
                    "Loaded %d SNPs for sample %s and chromosome %s",
                    res.n_snps, donor_id, chrom_str,
                )
        except Exception as e:
            logger.error("An error occurred while processing VCF file: %s", e)
            res.error = e
            raise
        finally:
            res.seconds = time.time() - t0
        return res

    def parse_snps(self, data_path: str, donor_id: str, chrom_str: str | None):
        """Parse one sample's SNPs: frame, decode, and assemble the SNP
        struct.  Returns ``(snp_struct, n_records)``.

        ``chrom_str`` restricts framing to one chromosome, as every task of
        :meth:`run` does; ``None`` frames every contig of the file.  The
        12-byte route refuses more than 255 distinct contigs *after* that
        filter, so only a parse without a region of such a file takes the
        64-byte route (as in the JAX package)."""
        if is_bcf(data_path):
            raise NotImplementedError(BCF_NOT_PORTED)
        src = VCFSource(data_path, threads=self.cxx_threads)
        if self.config.device_decode:
            try:
                rec12, chrom_table, seen = src.frame12(sample=donor_id, region=chrom_str)
            except ValueError:
                logger.info(
                    "compact framer refused %s (>255 chroms); using the 64-byte layout",
                    data_path,
                )
            else:
                if rec12.shape[0] == 0:
                    decoded = decode_frames12_numpy(rec12)
                else:
                    with _device_lock:
                        decoded = _decode12(rec12, self.device)
                return snp_struct_from_frames12(decoded, chrom_table), seen

        framed = src.frame(sample=donor_id, region=chrom_str)
        if self.config.device_decode:
            with _device_lock:
                decoded = _decode(framed.records, self.device)
        else:
            decoded = _decode(framed.records, None)
        return snp_struct_from_frames(framed.records, decoded), framed.n

    def process_donor(self, donor_id: str) -> list[TaskResult]:
        """All chromosomes for one donor."""
        logger.info("Processing donor %s", donor_id)
        return [
            self.genotype_vcf_to_hdf5(self.config.vcf_path(c), donor_id, c)
            for c in self.chromosomes
        ]

    # -- merge ----------------------------------------------------------

    def merge_h5_files(self, mode: str = "w") -> None:
        """Merge the temp shards into ``{out_dir}/{cohort_name}.h5`` (the h5py
        copy keeps each dataset's compression pipeline)."""
        import h5py

        final_h5_file = self.config.final_h5_path
        logger.info("Merging HDF5 files from %s to %s", self.tmp_dir, final_h5_file)
        with h5py.File(final_h5_file, mode) as final_file:
            for tmp_file in sorted(os.listdir(self.tmp_dir)):
                if not tmp_file.endswith(".h5"):
                    continue
                with h5py.File(os.path.join(self.tmp_dir, tmp_file), "r") as tmp:
                    for donor in tmp.keys():
                        donor_group = final_file.require_group(donor)
                        for chrom in tmp[donor].keys():
                            chrom_group = donor_group.require_group(chrom)
                            for dset_name in tmp[donor][chrom].keys():
                                if dset_name in chrom_group:
                                    del chrom_group[dset_name]
                                tmp.copy(f"{donor}/{chrom}/{dset_name}", chrom_group)
        logger.info("Finished merging HDF5 files")

    # -- run ------------------------------------------------------------

    def run(self, cleanup: bool = True) -> list[TaskResult]:
        """Convert every donor (a thread pool of ``cores``), merge, and
        remove the temp shards unless a task failed."""
        start_time = time.time()
        try:
            donor_ids = [d for d in self.donor_ids if d]
            with ThreadPoolExecutor(max_workers=self.cores) as executor:
                futures = {executor.submit(self.process_donor, d): d for d in donor_ids}
                failed = []
                for fut in as_completed(futures):
                    donor = futures[fut]
                    try:
                        self.results.extend(fut.result())
                    except Exception as exc:
                        logger.error("donor %s failed: %s", donor, exc)
                        self.results.append(TaskResult(donor_id=donor, chromosome="*", error=exc))
                        failed.append(donor)
                if failed:
                    logger.error("%d/%d donors failed: %s", len(failed), len(donor_ids), failed)

            merge_start = time.time()
            self.merge_h5_files()
            wall = time.time() - start_time
            n_var = sum(r.n_snps for r in self.results)
            logger.info("Time taken to merge HDF5 files: %.2f seconds", time.time() - merge_start)
            logger.info(
                "Converted %d SNP records in %.2fs (%.0f variants/sec)",
                n_var, wall, n_var / wall if wall > 0 else 0,
            )
            GLOBAL_METRICS.log_summary("vcf_to_h5")
            return self.results
        finally:
            had_errors = any(r.error is not None for r in self.results)
            if cleanup and not had_errors:
                shutil.rmtree(self.tmp_dir, ignore_errors=True)
            elif had_errors:
                logger.warning(
                    "temp shards kept in %s — rerun with resume=True to skip "
                    "completed (donor, chromosome) tasks",
                    self.tmp_dir,
                )


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m haplohyped_tpu_torch.pipeline.vcf_to_h5",
        description="Convert a cohort of per-chromosome VCFs to a genotype HDF5.",
    )
    ap.add_argument("--cohort_name", required=True, help="Cohort specific name")
    ap.add_argument("--vcf", required=True, help="Path to VCF files directory")
    ap.add_argument("--outdir", required=True, help="Path to results save folder")
    ap.add_argument("--sample_list", required=True, help="Path to sample list file")
    ap.add_argument("--cores", type=int, default=os.cpu_count(), help="Number of CPU cores to use")
    ap.add_argument("--cxx_threads", type=int, default=4,
                    help="Native decompression/framing threads")
    ap.add_argument("--resume", action="store_true", help="Skip existing temp shards")
    ap.add_argument("--device-decode", dest="device_decode",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="Decode on --device (the Hopper kernels on CUDA) instead of numpy")
    ap.add_argument("--chromosomes", default="auto",
                    help="Comma-separated chromosome numbers, or 'auto' to use the "
                    "chr{N}.filtered.vcf.gz files present in --vcf (default)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--single-pass", dest="single_pass", action="store_true", default=True,
                      help="Frame each chromosome once for every donor (not ported yet)")
    mode.add_argument("--per-donor", dest="single_pass", action="store_false",
                      help="One parse per donor, the reference's shape")
    write = ap.add_mutually_exclusive_group()
    write.add_argument("--direct-write", dest="direct_write", action="store_true", default=True,
                       help="Stream datasets into the final file (single-pass only)")
    write.add_argument("--merge-write", dest="direct_write", action="store_false",
                       help="Temp file per shard + merge")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> None:
    """Convert a cohort of per-chromosome VCFs to a genotype HDF5."""
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.chromosomes == "auto":
        chrom_list = [
            c for c in AUTOSOMES
            if os.path.exists(os.path.join(args.vcf, VCF_FILENAME_PATTERN.format(chromosome=c)))
        ]
        if not chrom_list:
            raise SystemExit(f"no chr{{N}}.filtered.vcf.gz files found in {args.vcf}")
        logger.info("auto-discovered chromosomes: %s", chrom_list)
    else:
        chrom_list = [int(c) if c.isdigit() else c for c in args.chromosomes.split(",")]
    converter = VCFtoHDF5Converter(
        cohort_name=args.cohort_name,
        vcf_dir=args.vcf,
        out_dir=args.outdir,
        sample_list_path=args.sample_list,
        cores=args.cores,
        cxx_threads=args.cxx_threads,
        resume=args.resume,
        device_decode=args.device_decode,
        chromosomes=chrom_list,
        single_pass=args.single_pass,
        direct_write=args.direct_write,
        device=args.device,
    )
    results = converter.run()
    n_err = sum(1 for r in results if r.error is not None)
    if n_err:
        raise SystemExit(f"{n_err} conversion tasks failed (see log)")


if __name__ == "__main__":
    main()
