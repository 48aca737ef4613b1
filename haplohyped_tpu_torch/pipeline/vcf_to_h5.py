"""VCF -> cohort-HDF5 conversion on PyTorch.

The port of ``haplohyped_tpu.pipeline.vcf_to_h5``.  The output is
``{out_dir}/{cohort}.h5`` with one dataset ``donor_{id}/chr_{n}/snp_data``
per (donor, chromosome), Blosc-compressed as the reference writes it.  Two
paths make it:

- **single pass** (``single_pass=True``, the default): one task per
  chromosome frames that chromosome's file ONCE for every donor (the v2
  layout; only the BGZF blocks of the chromosome where a ``.tbi``/``.csi``
  sits beside the file), decodes it with torch ops on ``device``, assembles
  every donor's SNP struct from that one decode, and writes them: straight
  into the final file under a lock (``direct_write=True``, the default), or
  into temp shards that :meth:`VCFtoHDF5Converter.merge_h5_files` copies
  (``direct_write=False``, and always with ``resume=True``).  Chromosomes
  fan out over a thread pool.  A BCF input is parsed once for every donor
  on the host and goes through the same struct assembly and writes.
- **per donor** (``single_pass=False``, the reference's shape): one task per
  (donor, chromosome) frames that donor's records (12-byte frames, the
  decode12 Hopper kernel; 64-byte frames and the decode64 kernel where a
  parse without a region meets more than 255 contigs), assembles the struct
  and writes a temp shard ``{cohort}_tmp_donor_{id}_chr_{n}.h5``; donors fan
  out over a thread pool and the shards are merged.  A BCF input is parsed
  on the host.  With ``use_tokenizer=True`` (off by default, as in the JAX
  package), a file the 12-byte framer refuses goes through the raw-text
  tokenizer (``ops/vcf_tokenize.py``, torch ops on ``device``) before the
  64-byte route, which then takes only files with a line past the window.

Every failed task is recorded and the rest of the cohort converts;
``resume=True`` skips (donor, chromosome) shards whose temp file exists.
On ``device="cpu"`` the kernels' plain PyTorch versions run.  An empty frame,
and ``device_decode=False``, decode with numpy.  There is no device probe
and no host rerouting: a CUDA failure raises.  ``h5py`` is imported only
where a file is written, so ``convert_chromosome(c, writer=...)`` runs
without it.
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
from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.bcf import (
    bcf_decoded_columns,
    bcf_decoded_v2,
    bcf_samples,
    is_bcf,
)
from haplohyped_tpu_torch.hostio.frame_format import FrameV2
from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.ops.decode_kernel import (
    decode_frames12_kernel,
    decode_frames_kernel,
)
from haplohyped_tpu_torch.ops.vcf_decode import (
    decode_frames12_numpy,
    decode_frames_numpy,
    decode_frames_v2_numpy,
    decode_v2_genotypes,
    decode_v2_records,
    unpack12_columns,
    unpack64_columns,
)
from haplohyped_tpu_torch.ops.vcf_tokenize import tokenize_vcf_device
from haplohyped_tpu_torch.pipeline.records import (
    snp_struct_from_decoded,
    snp_struct_from_frames,
    snp_struct_from_frames12,
    snp_structs_from_v2,
)
from haplohyped_tpu_torch.storage.blosc import cohort_compression_kwargs, set_blosc_nthreads
from haplohyped_tpu_torch.storage.fastwrite import write_dataset_direct
from haplohyped_tpu_torch.utils.malloc_tune import prefault_arena, tune_malloc

logger = logging.getLogger("haplohyped_tpu_torch.vcf_to_h5")

#: serialises device decodes across the worker threads (one upload, decode
#: and copy back at a time; the launch counters stay exact)
_device_lock = threading.Lock()

#: bytes of one sample block of the v2 genotype decode (records x samples):
#: a block's ~10 temporaries of that size stay on the card beside the frame,
#: so a 1000 Genomes chromosome (chr1: 6.5 M records x 2,504 donors, 16.2 GB
#: of genotype bytes) decodes within the card's memory
GT_BLOCK_BYTES = 1 << 30

#: the v2 decode's columns that struct assembly reads: per record, and
#: per (record, sample)
V2_RECORD_COLUMNS = ("start", "stop", "ref_char", "alt_char", "chrom_id", "snp_mask",
                     "well_formed")
V2_GENOTYPE_COLUMNS = {"phase1": np.int8, "phase2": np.int8, "valid": np.bool_}


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


def upload_v2(frame: FrameV2, device: torch.device) -> tuple[torch.Tensor, ...]:
    """h2d: a v2 frame's arrays on ``device``, ``(fixed, gt, exc_idx,
    exc_pos, run_counts, run_ids)`` (``exc_pos`` as int64)."""
    arrays = (frame.fixed, frame.gt, frame.exc_idx, frame.exc_pos.astype(np.int64),
              frame.run_counts, frame.run_ids)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def decode_v2_to_host(fixed, gt, exc_idx, exc_pos, run_counts, run_ids) -> dict[str, np.ndarray]:
    """Decode an uploaded v2 frame on its device and copy back the columns
    struct assembly reads.

    The per-record columns decode once.  The genotype columns decode a block
    of samples at a time (``GT_BLOCK_BYTES``), each block transposed on the
    device to ``(samples, N)`` and copied into ``(S, N)`` host arrays: the
    ``(N, S)`` columns returned are views of those, so each donor's column is
    contiguous for struct assembly."""
    rec = decode_v2_records(fixed, exc_idx, exc_pos, run_counts, run_ids)
    out = {k: rec[k].cpu().numpy() for k in V2_RECORD_COLUMNS}
    out["start"], out["stop"] = out["start"].astype(np.uint32), out["stop"].astype(np.uint32)
    n, s = gt.shape
    host = {k: np.empty((s, n), dtype) for k, dtype in V2_GENOTYPE_COLUMNS.items()}
    step = max(1, GT_BLOCK_BYTES // max(n, 1))
    well_formed = rec["well_formed"][None, :]
    for a in range(0, s, step):
        block = decode_v2_genotypes(gt[:, a:a + step].t().contiguous(), well_formed)
        for k, arr in host.items():
            torch.from_numpy(arr[a:a + step]).copy_(block[k])
    return out | {k: arr.T for k, arr in host.items()}


def _decode_v2(frame: FrameV2, device: torch.device | None) -> dict[str, np.ndarray]:
    """Decode a v2 frame (every sample at once) on ``device``, or with
    numpy where ``device`` is None or the frame is empty."""
    if device is None or frame.n == 0:
        return decode_frames_v2_numpy(frame.fixed, frame.gt, frame.exc_idx, frame.exc_pos,
                                      frame.run_counts, frame.run_ids)
    return decode_v2_to_host(*upload_v2(frame, device))


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
        use_tokenizer: bool = False,
        device: str | torch.device = "cuda",
    ):
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
            use_tokenizer=use_tokenizer,
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
        # keep freed frame/decode/struct buffers in the malloc arena, and pay
        # their first-touch page faults now, in the background, while framing
        # runs: peak arena need is ~10x the compressed input
        tune_malloc()
        try:
            total_gz = sum(os.path.getsize(cfg.vcf_path(c)) for c in cfg.chromosomes
                           if os.path.exists(cfg.vcf_path(c)))
        except OSError:
            total_gz = 0
        if total_gz:
            prefault_arena(min(max(10 * total_gz, 64 << 20), 3 << 29))
        self.results: list[TaskResult] = []

    # -- inputs ---------------------------------------------------------

    def read_sample_list(self, sample_list_path: str) -> list[str]:
        """One donor ID per line."""
        with open(sample_list_path, "r") as f:
            return [line.strip() for line in f]

    # -- per-donor unit -------------------------------------------------

    def tmp_h5_path(self, donor_id: str, chromosome: int | str) -> str:
        return os.path.join(
            self.tmp_dir,
            f"{self.cohort_name}_tmp_donor_{donor_id}_chr_{chromosome}.h5",
        )

    def _write_shard(self, donor_id: str, chromosome: int | str, snp_struct: np.ndarray) -> None:
        """One (donor, chromosome) struct into its temp HDF5 shard."""
        import h5py

        with h5py.File(self.tmp_h5_path(donor_id, chromosome), "w") as h5f:
            group = h5f.create_group(cohort_group_path(donor_id, chromosome))
            write_dataset_direct(group, SNP_DATASET_NAME, snp_struct,
                                 cohort_compression_kwargs(snp_struct.shape[0]),
                                 workers=self.cxx_threads)

    def genotype_vcf_to_hdf5(
        self, data_path: str, donor_id: str, chromosome: int | str
    ) -> TaskResult:
        """Convert one (donor, chromosome) into its temp HDF5 shard."""
        res = TaskResult(donor_id=donor_id, chromosome=chromosome)
        t0 = time.time()
        if self.config.resume and os.path.exists(self.tmp_h5_path(donor_id, chromosome)):
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
                with GLOBAL_METRICS.timer("h5_write"):
                    self._write_shard(donor_id, chromosome, snp_struct)
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
        filter, so only a parse without a region of such a file leaves it
        (as in the JAX package): for the tokenizer where ``use_tokenizer``
        is on, then for the 64-byte route where a line is longer than the
        tokenizer's window, or the tokenizer is off.  A BCF is parsed on the
        host."""
        if is_bcf(data_path):
            decoded = bcf_decoded_columns(data_path, donor_id, threads=self.cxx_threads)
            struct = snp_struct_from_decoded(decoded, decoded["chrom"], chrom_filter=chrom_str)
            return struct, int(decoded["start"].shape[0])
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

        if self.config.device_decode and self.config.use_tokenizer:
            with native.vcf_text(data_path, threads=self.cxx_threads) as text:
                with _device_lock:
                    decoded = tokenize_vcf_device(text, donor_id, device=self.device)
            if not decoded["long_line"].any():
                struct = snp_struct_from_decoded(decoded, decoded["chrom"], chrom_filter=chrom_str)
                return struct, int(decoded["start"].shape[0])
            logger.info("lines exceed the tokenizer's window; using the 64-byte layout for %s",
                        data_path)

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

    # -- single-pass unit -----------------------------------------------

    def convert_chromosome(self, chromosome: int | str, writer=None) -> list[TaskResult]:
        """Frame one chromosome's file ONCE (v2 layout), take every donor's
        genotypes from that pass, decode on the converter's device, and
        write every donor's struct.

        ``writer(donor_id, chromosome, snp_struct)`` is the destination (the
        direct-to-final writer of :meth:`run`, or any callable); None writes
        the per-(donor, chromosome) temp shards that :meth:`merge_h5_files`
        copies.  Donors whose shard exists are skipped under ``resume``;
        donors missing from the file's header fail alone.  Replaces the
        reference's loop that re-reads the whole file for every donor
        (``vcf_to_h5.py:142-152``)."""
        data_path = self.config.vcf_path(chromosome)
        chrom_str = f"chr{chromosome}"
        donors = [d for d in self.donor_ids if d]
        t0 = time.time()
        results: list[TaskResult] = []
        todo = donors
        if self.config.resume:
            todo = [d for d in donors if not os.path.exists(self.tmp_h5_path(d, chromosome))]
            results += [TaskResult(donor_id=d, chromosome=chromosome, skipped=True)
                        for d in donors if d not in todo]
            if not todo:
                return results

        if is_bcf(data_path):
            # one native record walk for every donor; the per-donor path only
            # where the chrom-id table overflows (>255 contigs)
            try:
                return self._convert_chromosome_bcf(
                    data_path, chromosome, chrom_str, todo, results, writer, t0)
            except ValueError as exc:
                logger.info("BCF single-pass unavailable for %s (%s); using the per-donor path",
                            data_path, exc)
            for d in todo:
                results.append(self.genotype_vcf_to_hdf5(data_path, d, chromosome))
            return results

        src = VCFSource(data_path, threads=self.cxx_threads)
        todo = self._isolate_missing(todo, src.samples(), chromosome, results, "VCF")
        if not todo:
            return results
        with GLOBAL_METRICS.timer("parse"):
            frame = src.frame_v2(samples=todo, region=chrom_str)
            if self.config.device_decode:
                with _device_lock:
                    decoded = _decode_v2(frame, self.device)
            else:
                decoded = _decode_v2(frame, None)
            structs = snp_structs_from_v2(decoded, frame.chroms, frame.samples,
                                          chrom_filter=chrom_str)
        GLOBAL_METRICS.count("records_seen", frame.total_seen)
        self._write_donor_structs(structs, todo, chromosome, chrom_str, frame.total_seen,
                                  results, writer, t0)
        return results

    def _isolate_missing(self, todo, header, chromosome, results, kind: str) -> list[str]:
        """Record a failed task for each donor of ``todo`` absent from the
        file's ``header``; returns the donors present."""
        present = set(header)
        for d in todo:
            if d not in present:
                err = RuntimeError(f"sample not found in {kind} header: {d}")
                logger.error("donor %s chr%s: %s", d, chromosome, err)
                results.append(TaskResult(donor_id=d, chromosome=chromosome, error=err))
        return [d for d in todo if d in present]

    def _convert_chromosome_bcf(
        self, data_path, chromosome, chrom_str, todo, results, writer, t0
    ) -> list[TaskResult]:
        """The BCF leg of the single-pass unit: one native record walk gives
        every donor's genotypes; struct assembly and writes are the VCF
        leg's.  Raises ``ValueError`` past 255 contigs."""
        todo = self._isolate_missing(todo, bcf_samples(data_path, self.cxx_threads), chromosome,
                                     results, "BCF")
        if not todo:
            return results
        with GLOBAL_METRICS.timer("parse"):
            decoded, contigs = bcf_decoded_v2(data_path, todo, self.cxx_threads)
            if len(contigs) > 255:
                raise ValueError(f"{len(contigs)} contigs exceeds the chrom-id table")
            structs = snp_structs_from_v2(decoded, contigs, todo, chrom_filter=chrom_str)
        n_seen = int(decoded["start"].shape[0])
        GLOBAL_METRICS.count("records_seen", n_seen)
        self._write_donor_structs(structs, todo, chromosome, chrom_str, n_seen, results,
                                  writer, t0)
        return results

    def _write_donor_structs(
        self, structs, todo, chromosome, chrom_str, total_seen, results, writer, t0
    ) -> None:
        """Write each donor's struct (``writer``, or a temp shard), a failed
        write failing that donor alone."""
        per_donor_s = (time.time() - t0) / max(len(todo), 1)
        with GLOBAL_METRICS.timer("h5_write"):
            for d in todo:
                res = TaskResult(donor_id=d, chromosome=chromosome, n_records=total_seen,
                                 seconds=per_donor_s)
                try:
                    snp_struct = structs[d]
                    res.n_snps = int(snp_struct.shape[0])
                    GLOBAL_METRICS.count("snps", res.n_snps)
                    if writer is not None:
                        writer(d, chromosome, snp_struct)
                    else:
                        self._write_shard(d, chromosome, snp_struct)
                    GLOBAL_METRICS.count("h5_bytes", snp_struct.nbytes)
                    logger.info("Loaded %d SNPs for sample %s and chromosome %s",
                                res.n_snps, d, chrom_str)
                except Exception as e:
                    logger.error("donor %s chr%s write failed: %s", d, chromosome, e)
                    res.error = e
                results.append(res)

    # -- merge ----------------------------------------------------------

    def merge_h5_files(self, mode: str = "w") -> None:
        """Merge the temp shards into ``{out_dir}/{cohort_name}.h5`` (the h5py
        copy keeps each dataset's compression pipeline).  ``mode="a"`` adds
        them to a file the direct writer already filled."""
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

    def _fan_out(self, fn, items, kind: str, *args) -> None:
        """``fn(item, *args)`` for every item on ``cores`` threads; a failed
        item is recorded as one failed TaskResult and the rest go on."""
        failed = []
        with ThreadPoolExecutor(max_workers=self.cores) as executor:
            futures = {executor.submit(fn, x, *args): x for x in items}
            for fut in as_completed(futures):
                x = futures[fut]
                try:
                    self.results.extend(fut.result())
                except Exception as exc:
                    logger.error("%s %s failed: %s", kind, x, exc)
                    donor, chrom = ("*", x) if kind == "chromosome" else (x, "*")
                    self.results.append(TaskResult(donor_id=donor, chromosome=chrom, error=exc))
                    failed.append(x)
        if failed:
            logger.error("%d/%d %ss failed: %s", len(failed), len(items), kind, failed)

    def run(self, cleanup: bool = True) -> list[TaskResult]:
        """Convert every chromosome for every donor (single pass: a thread
        pool of ``cores`` over chromosomes; per donor: over donors), write
        the cohort file, and remove the temp shards unless a task failed.

        The single pass with ``direct_write`` (and no ``resume``) streams each
        dataset into the final file under one lock, and merges only what a
        BCF fallback left in temp shards; otherwise the shards are merged."""
        start_time = time.time()
        cfg = self.config
        direct = cfg.single_pass and cfg.direct_write and not cfg.resume
        final_file = None
        writer = None
        if direct:
            import h5py

            final_file = h5py.File(cfg.final_h5_path, "w")
            write_lock = threading.Lock()

            def writer(donor_id, chromosome, snp_struct):
                with write_lock:
                    group = final_file.require_group(cohort_group_path(donor_id, chromosome))
                    if SNP_DATASET_NAME in group:
                        del group[SNP_DATASET_NAME]
                    write_dataset_direct(group, SNP_DATASET_NAME, snp_struct,
                                         cohort_compression_kwargs(snp_struct.shape[0]),
                                         workers=self.cxx_threads)

        try:
            if cfg.single_pass:
                self._fan_out(self.convert_chromosome, list(self.chromosomes), "chromosome",
                              writer)
            else:
                self._fan_out(self.process_donor, [d for d in self.donor_ids if d], "donor")

            merge_start = time.time()
            if direct:
                final_file.close()
                final_file = None
                if any(f.endswith(".h5") for f in os.listdir(self.tmp_dir)):
                    self.merge_h5_files(mode="a")
            else:
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
            if final_file is not None:  # an exception left the file open
                final_file.close()
            had_errors = any(r.error is not None for r in self.results)
            if cleanup and not had_errors:
                shutil.rmtree(self.tmp_dir, ignore_errors=True)
            elif had_errors and direct:
                logger.warning(
                    "direct-write output %s is incomplete; rerun with resume=True "
                    "(redoes every task through temp shards, then rebuilds the cohort file)",
                    cfg.final_h5_path,
                )
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
                    help="Decode on --device (torch ops, and the Hopper kernels of the "
                    "per-donor path, on CUDA) instead of numpy")
    ap.add_argument("--chromosomes", default="auto",
                    help="Comma-separated chromosome numbers, or 'auto' to use the "
                    "chr{N}.filtered.vcf.gz files present in --vcf (default)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--single-pass", dest="single_pass", action="store_true", default=True,
                      help="Frame each chromosome once for every donor (default)")
    mode.add_argument("--per-donor", dest="single_pass", action="store_false",
                      help="One parse per donor, the reference's shape")
    write = ap.add_mutually_exclusive_group()
    write.add_argument("--direct-write", dest="direct_write", action="store_true", default=True,
                       help="Stream datasets into the final file (single-pass only; default)")
    write.add_argument("--merge-write", dest="direct_write", action="store_false",
                       help="Temp file per shard + merge (implied by --resume)")
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
