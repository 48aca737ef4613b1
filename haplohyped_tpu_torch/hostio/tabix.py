"""Tabix (``.tbi``) and CSI (``.csi``) indexes: readers and builder.

The port's copy of ``haplohyped_tpu.hostio.tabix``.  The reference's region
queries need an index built by other tools (htslib ``setRegion``,
``vcfpp.h:1424-1453``); here:

- :class:`TabixIndex` and :class:`CSIIndex` read ``.tbi`` and ``.csi``
  files (gzip-compressed binary: hierarchical bins of BGZF virtual-offset
  chunks, plus a 16 kb linear index (tbi) or per-bin first offsets (csi));
- :func:`build_index` writes either for a BGZF, position-sorted VCF, with
  the canonical reg2bin bins, so other tools read it and it reads theirs;
- :func:`region_block_range` and :func:`region_virtual_offset` give the
  span and the seek point of a region from a sibling index, so
  ``VCFSource.frame_v2`` inflates only the blocks that cover it.

A BGZF *virtual offset* packs (compressed block offset << 16 | offset within
the inflated block).
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

TBI_MAGIC = b"TBI\x01"
CSI_MAGIC = b"CSI\x01"
LINEAR_SHIFT = 14  # 16 kb linear-index bins


def reg2bin_csi(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    """CSI binning: reg2bin with a configurable geometry."""
    end -= 1
    for level in range(depth, -1, -1):  # deepest level first
        shift = min_shift + 3 * (depth - level)
        if beg >> shift == end >> shift:
            return ((1 << (3 * level)) - 1) // 7 + (beg >> shift)
    return 0


def reg2bin(beg: int, end: int) -> int:
    """Canonical UCSC binning: the smallest bin that holds [beg, end)."""
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """Every bin that overlaps [beg, end)."""
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


@dataclass
class RefIndex:
    bins: dict[int, list[tuple[int, int]]] = field(default_factory=dict)
    linear: list[int] = field(default_factory=list)


@dataclass
class TabixIndex:
    names: list[str]
    refs: list[RefIndex]
    col_seq: int = 1
    col_beg: int = 2
    col_end: int = 0
    meta_char: int = ord("#")

    @classmethod
    def load(cls, path: str) -> "TabixIndex":
        with gzip.open(path, "rb") as f:
            data = f.read()
        if data[:4] != TBI_MAGIC:
            raise ValueError(f"not a tabix index: {path}")
        off = 4
        n_ref, _fmt, col_seq, col_beg, col_end, meta, _skip, l_nm = struct.unpack_from(
            "<8i", data, off)
        off += 32
        names = [n.decode() for n in data[off:off + l_nm].rstrip(b"\x00").split(b"\x00") if n]
        off += l_nm
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            ref = RefIndex()
            for _ in range(n_bin):
                bin_no, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                ref.bins[bin_no] = [struct.unpack_from("<QQ", data, off + 16 * k)
                                    for k in range(n_chunk)]
                off += 16 * n_chunk
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ref.linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            refs.append(ref)
        return cls(names=names, refs=refs, col_seq=col_seq, col_beg=col_beg,
                   col_end=col_end, meta_char=meta)

    def min_offset(self, chrom: str, beg: int) -> int | None:
        """The least virtual offset where records at positions >= ``beg``
        (0-based) can start; None where ``chrom`` is unknown or empty."""
        if chrom not in self.names:
            return None
        ref = self.refs[self.names.index(chrom)]
        if not ref.linear:
            return None
        return ref.linear[min(beg >> LINEAR_SHIFT, len(ref.linear) - 1)]

    def query_chunks(self, chrom: str, beg: int, end: int) -> list[tuple[int, int]]:
        """Candidate (voffset_beg, voffset_end) chunks for [beg, end)."""
        if chrom not in self.names:
            return []
        ref = self.refs[self.names.index(chrom)]
        min_off = self.min_offset(chrom, beg) or 0
        out = [(max(cb, min_off), ce) for b in reg2bins(beg, end)
               for cb, ce in ref.bins.get(b, []) if ce > min_off]
        out.sort()
        return out


@dataclass
class CSIIndex:
    """A ``.csi`` index: tabix's variable-geometry successor.  Seeks use
    each bin's ``loffset`` (the virtual offset of its first record) where
    tabix has the linear index."""

    names: list[str]
    min_shift: int
    depth: int
    #: per ref: {bin: (loffset, [(cb, ce), ...])}
    refs: list[dict[int, tuple[int, list[tuple[int, int]]]]]

    @classmethod
    def load(cls, path: str) -> "CSIIndex":
        with gzip.open(path, "rb") as f:
            data = f.read()
        if data[:4] != CSI_MAGIC:
            raise ValueError(f"not a CSI index: {path}")
        off = 4
        min_shift, depth, l_aux = struct.unpack_from("<3i", data, off)
        off += 12
        names: list[str] = []
        if l_aux >= 28:  # tabix-style aux: 7 int32 parameters, then the names
            l_nm = struct.unpack_from("<i", data, off + 24)[0]
            names = [n.decode() for n in data[off + 28:off + 28 + l_nm].split(b"\x00") if n]
        off += l_aux
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, tuple[int, list[tuple[int, int]]]] = {}
            for _ in range(n_bin):
                bin_no, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                bins[bin_no] = (loffset, [struct.unpack_from("<QQ", data, off + 16 * k)
                                          for k in range(n_chunk)])
                off += 16 * n_chunk
            refs.append(bins)
        return cls(names=names, min_shift=min_shift, depth=depth, refs=refs)

    def min_offset(self, chrom: str, beg: int) -> int | None:
        if chrom not in self.names:
            return None
        bins = self.refs[self.names.index(chrom)]
        if not bins:
            return None
        # the deepest bin holding [beg, beg + 1), then its ancestors
        b = reg2bin_csi(beg, beg + 1, self.min_shift, self.depth)
        while True:
            if b in bins:
                return bins[b][0]
            if b == 0:
                break
            b = (b - 1) >> 3
        offs = [v[0] for v in bins.values() if v[0] > 0]
        return min(offs) if offs else None


def _write_gzip(path: str, payload: bytearray) -> str:
    with gzip.open(path, "wb") as f:
        f.write(bytes(payload))
    return path


def write_csi(names: list[str], refs: list[RefIndex], out_path: str, min_shift: int = 14,
              depth: int = 5) -> str:
    """Serialise bins of the tabix geometry as a standard ``.csi`` file."""
    payload = bytearray(CSI_MAGIC)
    nm = b"".join(n.encode() + b"\x00" for n in names)
    aux = struct.pack("<7i", 2, 1, 2, 0, ord("#"), 0, len(nm)) + nm
    payload += struct.pack("<3i", min_shift, depth, len(aux)) + aux
    payload += struct.pack("<i", len(refs))
    for ref in refs:
        payload += struct.pack("<i", len(ref.bins))
        for bin_no in sorted(ref.bins):
            chunks = ref.bins[bin_no]
            payload += struct.pack("<IQi", bin_no, min(cb for cb, _ in chunks), len(chunks))
            for cb, ce in chunks:
                payload += struct.pack("<QQ", cb, ce)
    return _write_gzip(out_path, payload)


def _write_tbi(names: list[str], refs: list[RefIndex], out_path: str) -> str:
    payload = bytearray(TBI_MAGIC)
    nm = b"".join(n.encode() + b"\x00" for n in names)
    payload += struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0, len(nm)) + nm
    for ref in refs:
        payload += struct.pack("<i", len(ref.bins))
        for bin_no in sorted(ref.bins):
            chunks = ref.bins[bin_no]
            payload += struct.pack("<Ii", bin_no, len(chunks))
            for cb, ce in chunks:
                payload += struct.pack("<QQ", cb, ce)
        payload += struct.pack("<i", len(ref.linear))
        payload += struct.pack(f"<{len(ref.linear)}Q", *ref.linear)
    return _write_gzip(out_path, payload)


def build_index(bgzf_vcf: str, out_path: str | None = None, fmt: str = "tbi") -> str:
    """Build a ``.tbi`` (or ``.csi``) for a BGZF, position-sorted VCF, next
    to it unless ``out_path`` is given.  Returns the index's path."""
    from haplohyped_tpu_torch.hostio.native import BgzfRangeReader

    if fmt not in ("tbi", "csi"):
        raise ValueError("fmt must be 'tbi' or 'csi'")
    out_path = out_path or bgzf_vcf + "." + fmt
    names: list[str] = []
    refs: list[RefIndex] = []

    def add_line(line: bytes, voff_start: int, voff_end: int) -> None:
        if not line or line.startswith(b"#"):
            return
        f0 = line.split(b"\t", 2)
        chrom = f0[0].decode()
        pos0 = int(f0[1]) - 1
        if not names or names[-1] != chrom:
            if chrom in names:
                raise ValueError("VCF not sorted by chromosome")
            names.append(chrom)
            refs.append(RefIndex())
        cur = refs[-1]
        chunks = cur.bins.setdefault(reg2bin(pos0, pos0 + 1), [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        li = pos0 >> LINEAR_SHIFT
        while len(cur.linear) <= li:
            cur.linear.append(0)
        if cur.linear[li] == 0 or voff_start < cur.linear[li]:
            cur.linear[li] = voff_start

    # walk the blocks in order, following each line's virtual offsets
    with BgzfRangeReader(bgzf_vcf) as reader:
        coffs = [reader.coffset(i) for i in range(reader.n_blocks)]
        carry, carry_voff = b"", 0
        buf = np.empty(1 << 16, dtype=np.uint8)
        for bi in range(reader.n_blocks):
            size = reader.uoffset(bi + 1) - reader.uoffset(bi)
            if size == 0:
                continue
            if buf.shape[0] < size:
                buf = np.empty(size, dtype=np.uint8)
            reader.decode_range(bi, bi + 1, 1, buf)
            data = buf[:size].tobytes()
            upos = 0
            while (nl := data.find(b"\n", upos)) >= 0:
                voff_start = carry_voff if carry else ((coffs[bi] << 16) | upos)
                line = carry + data[upos:nl]
                carry = b""
                upos = nl + 1
                add_line(line.rstrip(b"\r"), voff_start, (coffs[bi] << 16) | upos)
            if upos < len(data):
                if not carry:
                    carry_voff = (coffs[bi] << 16) | upos
                carry += data[upos:]

    # linear-index gaps take the previous value (htslib's convention)
    for ref in refs:
        last = 0
        for i, v in enumerate(ref.linear):
            if v == 0:
                ref.linear[i] = last
            else:
                last = v
    return write_csi(names, refs, out_path) if fmt == "csi" else _write_tbi(names, refs, out_path)


def _span_from_chunks(chunks) -> tuple[int, int] | None:
    if not chunks:
        return None
    return min(cb for cb, _ in chunks), max(ce for _, ce in chunks)


def region_block_range(
    vcf_path: str, chrom: str, beg: int = -1, end: int = -1
) -> tuple[int, int] | None:
    """The (voff_lo, voff_hi) span that covers every record of ``chrom``
    overlapping ``[beg, end)`` (0-based; -1 = unbounded), from a sibling
    ``.tbi`` or ``.csi``.  None where no usable index exists: the caller
    then frames the whole file.  The span may hold more (index chunks are
    bin-sized); the framer's record filter still applies."""
    tbi = vcf_path + ".tbi"
    if os.path.exists(tbi):
        try:
            idx = TabixIndex.load(tbi)
            if chrom not in idx.names:
                return None
            if beg >= 0 and end >= 0:
                return _span_from_chunks(idx.query_chunks(chrom, beg, end))
            ref = idx.refs[idx.names.index(chrom)]
            return _span_from_chunks([c for cl in ref.bins.values() for c in cl])
        except Exception:
            pass
    csi = vcf_path + ".csi"
    if os.path.exists(csi):
        try:
            idx = CSIIndex.load(csi)
            if chrom not in idx.names:
                return None
            bins = idx.refs[idx.names.index(chrom)]
            span = _span_from_chunks([c for _, cl in bins.values() for c in cl])
            if span is None:
                return None
            lo, hi = span
            if beg >= 0:
                mo = idx.min_offset(chrom, beg)
                if mo:
                    lo = max(lo, mo)
            return lo, hi
        except Exception:
            pass
    return None


def region_virtual_offset(vcf_path: str, chrom: str, beg: int = 0) -> int | None:
    """The seek virtual offset of a region, from a sibling ``.tbi`` or ``.csi``."""
    for suffix, cls in ((".tbi", TabixIndex), (".csi", CSIIndex)):
        if os.path.exists(vcf_path + suffix):
            try:
                return cls.load(vcf_path + suffix).min_offset(chrom, beg)
            except Exception:
                pass
    return None
