"""VCF record source: the native framer, or the pure-Python one on request.

The port's ``VCFSource`` (``haplohyped_tpu.hostio.vcf``): sample names,
contig names, and framing into the 64-byte or the 12-byte layout (one
sample's records) or the v2 layout (every requested sample's records in one
pass), optionally restricted to a region (``chrom`` or ``chrom:beg-end``).
A v2 framing of a region that a sibling ``.tbi``/``.csi`` indexes inflates
only the BGZF blocks that cover it.  The native framer is built from
``cpp/`` at first use and a failed build raises; the pure-Python framer
runs only when the caller passes ``use_native=False``.  ``FRAME_COUNTS``
counts the framing passes of each file.
"""

from __future__ import annotations

import gzip
import threading
from collections import Counter

import numpy as np

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.frame_format import (
    REC_SIZE,
    FrameV2,
    FramedRecords,
    frame_v2_py,
    frames12_from_frames64,
    pack_frame,
)
from haplohyped_tpu_torch.hostio.tabix import region_block_range

#: framing passes by file path: each ``frame``, ``frame12`` and ``frame_v2``
#: call reads the file once (an indexed region read inflates only the
#: blocks that cover it, and still counts one).  The tests count a sharded
#: conversion's passes through it: one a (chromosome, shard), not one a donor.
FRAME_COUNTS: Counter = Counter()
_frame_counts_lock = threading.Lock()  # converters frame from worker threads


def _count_pass(path: str) -> None:
    with _frame_counts_lock:
        FRAME_COUNTS[path] += 1


def _read_text(path: str) -> bytes:
    """Decompress a VCF to raw text bytes."""
    with open(path, "rb") as f:
        head = f.read(2)
    opener = gzip.open if head == b"\x1f\x8b" else open
    with opener(path, "rb") as f:
        return f.read()


def _parse_region(region: str | None) -> tuple[str, int, int]:
    if not region:
        return "", -1, -1
    if ":" in region and "-" in region.split(":")[-1]:
        chrom, span = region.rsplit(":", 1)
        b, e = span.split("-", 1)
        return chrom, (int(b) - 1) if b else -1, int(e) if e else -1
    return region, -1, -1


class VCFSource:
    """One VCF file, framed on demand into fixed-shape record buffers."""

    def __init__(self, path: str, threads: int = 1, use_native: bool = True):
        self.path = path
        self.threads = max(1, int(threads))
        self.use_native = use_native

    # -- header ---------------------------------------------------------

    def samples(self) -> list[str]:
        """Sample names from the ``#CHROM`` header line."""
        if self.use_native:
            return native.vcf_samples(self.path, self.threads)
        for line in _read_text(self.path).split(b"\n"):
            if line.startswith(b"#CHROM"):
                return [f.decode() for f in line.rstrip(b"\r").split(b"\t")[9:]]
            if not line.startswith(b"#"):
                break
        raise RuntimeError("VCF has no #CHROM header line")

    def seqnames(self) -> list[str]:
        """Contig names from the ``##contig`` header lines."""
        out = []
        for line in _read_text(self.path).split(b"\n"):
            if not line.startswith(b"#"):
                break
            if line.startswith(b"##contig=<"):
                body = line[len(b"##contig=<"):].rstrip(b"\r>")
                out += [part[3:].decode() for part in body.split(b",")
                        if part.startswith(b"ID=")]
        return out

    # -- framing --------------------------------------------------------

    def frame(self, sample: str | None = None, region: str | None = None) -> FramedRecords:
        """Frame data lines into (n, 64) uint8 records.

        ``sample`` selects whose GT subfield is packed; ``region`` filters by
        chromosome (optionally ``chrom:beg-end``, 1-based inclusive)."""
        _count_pass(self.path)
        if self.use_native:
            records, seen = native.vcf_frame(self.path, sample, region, self.threads)
            return FramedRecords(records=records, total_seen=seen)
        return self._py_frame(sample, region)

    def frame12(
        self, sample: str | None = None, region: str | None = None
    ) -> tuple[np.ndarray, list[str], int]:
        """Frame data lines into compact (n, 12) records + a chrom table.

        Returns (records, chrom_table, total_seen).  Raises ``ValueError``
        where the records ``region`` keeps hold > 255 distinct chroms (route
        those through :meth:`frame`)."""
        _count_pass(self.path)
        if self.use_native:
            return native.vcf_frame12(self.path, sample, region, self.threads)
        framed = self._py_frame(sample, region)
        records, chroms = frames12_from_frames64(framed.records)
        return records, chroms, framed.total_seen

    def frame_v2(
        self,
        samples: list[str] | str | None = None,
        region: str | None = None,
        use_index: bool = True,
    ) -> FrameV2:
        """Frame data lines into the v2 layout: 5-byte records and an
        ``(n, S)`` GT byte matrix, every requested sample in ONE pass of the
        file (the reference re-reads it per donor, ``vcf_to_h5.py:142-152``).

        ``samples``: None = no genotypes, ``"*"`` = every header sample, a
        name or a list = those samples in slot order.  Where ``region`` names
        a chromosome that a sibling ``.tbi``/``.csi`` indexes and
        ``use_index`` is on, only the BGZF blocks covering it are inflated
        (``FrameV2.blocks_decoded`` says how many).  Raises ``ValueError``
        where the records kept hold > 255 distinct chroms."""
        _count_pass(self.path)
        c_lo, u_skip, c_hi = -1, 0, -1
        if use_index and region:
            chrom, beg, end = _parse_region(region)
            span = region_block_range(self.path, chrom, beg, end) if chrom else None
            if span is not None:
                c_lo, u_skip, c_hi = span[0] >> 16, span[0] & 0xFFFF, span[1] >> 16
        if self.use_native:
            return native.vcf_frame_v2(self.path, samples, region, self.threads,
                                       c_lo=c_lo, u_skip=u_skip, c_hi=c_hi)
        if isinstance(samples, str):
            samples = [samples]
        return frame_v2_py(_read_text(self.path), samples, region)

    def _py_frame(self, sample: str | None, region: str | None) -> FramedRecords:
        text = _read_text(self.path)
        chrom_f, beg, end = _parse_region(region)
        chrom_b = chrom_f.encode()
        sample_col = -1
        recs: list[np.ndarray] = []
        seen = 0
        for line in text.split(b"\n"):
            line = line.rstrip(b"\r")
            if not line:
                continue
            if line.startswith(b"#"):
                if line.startswith(b"#CHROM") and sample is not None:
                    cols = line.split(b"\t")[9:]
                    try:
                        sample_col = cols.index(sample.encode())
                    except ValueError:
                        raise RuntimeError(f"sample not found in VCF header: {sample}")
                continue
            seen += 1
            fields = line.split(b"\t")
            if len(fields) < 8:
                continue
            if chrom_b and fields[0] != chrom_b:
                continue
            if beg >= 0 or end >= 0:
                try:
                    start0 = int(fields[1]) - 1
                except ValueError:
                    continue
                if (beg >= 0 and start0 < beg) or (end >= 0 and start0 >= end):
                    continue
            gt = None
            if sample is not None and sample_col >= 0 and len(fields) > 9 + sample_col:
                fmt = fields[8].split(b":")
                try:
                    gt_idx = fmt.index(b"GT")
                except ValueError:
                    continue
                subfields = fields[9 + sample_col].split(b":")
                if gt_idx < len(subfields):
                    gt = subfields[gt_idx]
            recs.append(pack_frame(fields[0], fields[1], fields[3], fields[4], gt))
        records = np.stack(recs) if recs else np.zeros((0, REC_SIZE), dtype=np.uint8)
        return FramedRecords(records=records, total_seen=seen)

    def count_variants(self, region: str | None = None) -> int:
        """Records in the file, or in ``region`` (``BcfReader::getVariantsCount``)."""
        return self.frame(None, region).n
