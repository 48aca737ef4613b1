"""Framed VCF record layouts (must stay in sync with cpp/hostio.cpp).

The port's own copy of ``haplohyped_tpu.hostio.frame_format``: the 64-byte,
12-byte and v2 layouts, and the pure-Python framers' helpers.

A framed record is 64 bytes: the host shim packs the variable-width text
fields the pipeline needs into fixed slots so the accelerator can decode them
with pure vector ops.

    [0:8)   chrom bytes      [8]   chrom_len
    [9:21)  pos ASCII digits [21]  pos_len
    [22:38) ref bytes        [38]  ref_len (true length, capped 255)
    [39:55) alt bytes        [55]  alt_len (true length, capped 255)
    [56:62) gt bytes         [62]  gt_len  (capped 6)
    [63]    flags: bit0 = well-formed line, bit1 = GT subfield present
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REC_SIZE = 64

CHROM_OFF, CHROM_CAP, CHROM_LEN_OFF = 0, 8, 8
POS_OFF, POS_CAP, POS_LEN_OFF = 9, 12, 21
REF_OFF, REF_CAP, REF_LEN_OFF = 22, 16, 38
ALT_OFF, ALT_CAP, ALT_LEN_OFF = 39, 16, 55
GT_OFF, GT_CAP, GT_LEN_OFF = 56, 6, 62
FLAGS_OFF = 63

FLAG_WELL_FORMED = 1
FLAG_HAS_GT = 2

# ---------------------------------------------------------------------
# Compact 12-byte record layout (SNP-pipeline fast path — 5.3x fewer
# bytes shipped to the accelerator; mirrored in cpp/hostio.cpp pack_rec12):
#   [0:5)  POS as 10 BCD nibbles, most-significant first, zero-padded left
#   [5]    ref first byte    [6] alt first byte
#   [7]    ref_len (true length, capped 255)  [8] alt_len (capped 255)
#   [9]    chrom_id (index into the per-call chrom table)
#   [10]   GT nibbles: first-allele class << 4 | second-allele class
#          (digit keeps its value; '.' -> 0xA; anything else -> 0xB)
#   [11]   flags (FLAG12_*)
# Only the first REF/ALT byte is kept: the SNP predicate needs lengths and
# first-ALT-base identity, and post-filter records are single-base by
# definition (reference cpp/vcfpp.h:990-1000 isSNP).  The host only
# tokenizes and re-codes bytes; POS integer value, the SNP predicate, and
# genotype presence/missing/phase semantics decode on the accelerator.
# ---------------------------------------------------------------------

REC12_SIZE = 12

R12_POS_OFF, R12_POS_BYTES, R12_POS_NIBBLES = 0, 5, 10
R12_REF_OFF, R12_ALT_OFF = 5, 6
R12_REF_LEN_OFF, R12_ALT_LEN_OFF = 7, 8
R12_CHROM_ID_OFF = 9
R12_GT_OFF = 10
R12_FLAGS_OFF = 11

FLAG12_WELL_FORMED = 1  # >= 8 fields AND POS is 1-10 digits
FLAG12_HAS_GT = 2
FLAG12_DIPLOID_LEN = 4  # GT subfield has >= 3 chars
FLAG12_SEP_PIPE = 8  # GT separator is '|'
FLAG12_SEP_SLASH = 16  # GT separator is '/'

GT_NIBBLE_MISSING = 0xA
GT_NIBBLE_OTHER = 0xB


def frames12_to_fields(records: np.ndarray) -> dict[str, np.ndarray]:
    """Destructure an (n, 12) compact frame matrix into named column views."""
    r = np.ascontiguousarray(records, dtype=np.uint8)
    return {
        "pos_bcd": r[:, R12_POS_OFF : R12_POS_OFF + R12_POS_BYTES],
        "ref": r[:, R12_REF_OFF],
        "ref_len": r[:, R12_REF_LEN_OFF],
        "alt": r[:, R12_ALT_OFF],
        "alt_len": r[:, R12_ALT_LEN_OFF],
        "chrom_id": r[:, R12_CHROM_ID_OFF],
        "gt_nibbles": r[:, R12_GT_OFF],
        "flags": r[:, R12_FLAGS_OFF],
    }


def _gt_nibble_classes(chars: np.ndarray) -> np.ndarray:
    """ASCII GT chars -> 4-bit classes (cpp gt_nibble twin)."""
    is_digit = (chars >= ord("0")) & (chars <= ord("9"))
    return np.where(
        is_digit,
        chars - ord("0"),
        np.where(chars == ord("."), GT_NIBBLE_MISSING, GT_NIBBLE_OTHER),
    ).astype(np.uint8)


def frames12_from_frames64(
    records: np.ndarray,
) -> tuple[np.ndarray, list[str]]:
    """Convert (n, 64) frames to the compact layout (the pure-Python
    framer's 12-byte route).  Returns (records12, chrom_table)."""
    r = np.ascontiguousarray(records, dtype=np.uint8)
    n = r.shape[0]
    out = np.zeros((n, REC12_SIZE), dtype=np.uint8)

    # --- POS ASCII digits -> right-aligned BCD nibbles ------------------
    pos_len = r[:, POS_LEN_OFF].astype(np.int32)
    digits_raw = r[:, POS_OFF : POS_OFF + R12_POS_NIBBLES]
    lane = np.arange(R12_POS_NIBBLES, dtype=np.int32)[None, :]
    in_len = lane < pos_len[:, None]
    all_digits = (
        ((digits_raw >= ord("0")) & (digits_raw <= ord("9"))) | ~in_len
    ).all(axis=1)
    pos_ok = (pos_len >= 1) & (pos_len <= R12_POS_NIBBLES) & all_digits
    # nibble slot = 10 - pos_len + j for source digit j (zero-padded left)
    src = lane - (R12_POS_NIBBLES - pos_len[:, None])  # digit index per slot
    gathered = np.take_along_axis(
        digits_raw, np.clip(src, 0, R12_POS_NIBBLES - 1), axis=1
    )
    nib = np.where((src >= 0) & (src < pos_len[:, None]), gathered - ord("0"), 0)
    nib = np.where(pos_ok[:, None], nib, 0).astype(np.uint8)
    out[:, R12_POS_OFF : R12_POS_OFF + R12_POS_BYTES] = (
        (nib[:, 0::2] << 4) | nib[:, 1::2]
    )

    out[:, R12_REF_OFF] = r[:, REF_OFF]
    out[:, R12_ALT_OFF] = r[:, ALT_OFF]
    out[:, R12_REF_LEN_OFF] = r[:, REF_LEN_OFF]
    out[:, R12_ALT_LEN_OFF] = r[:, ALT_LEN_OFF]

    # --- GT chars -> nibble classes + separator flags -------------------
    g0 = _gt_nibble_classes(r[:, GT_OFF])
    g2 = _gt_nibble_classes(r[:, GT_OFF + 2])
    gt_len = r[:, GT_LEN_OFF].astype(np.int32)
    has_gt = (r[:, FLAGS_OFF] & FLAG_HAS_GT) != 0
    g0 = np.where(gt_len > 0, g0, GT_NIBBLE_OTHER)
    g2 = np.where(gt_len > 2, g2, GT_NIBBLE_OTHER)
    out[:, R12_GT_OFF] = np.where(has_gt, (g0 << 4) | g2, 0)

    well = ((r[:, FLAGS_OFF] & FLAG_WELL_FORMED) != 0) & pos_ok
    dip = has_gt & (gt_len >= 3)
    sep = r[:, GT_OFF + 1]
    flags = (
        well * FLAG12_WELL_FORMED
        + has_gt * FLAG12_HAS_GT
        + dip * FLAG12_DIPLOID_LEN
        + (dip & (sep == ord("|"))) * FLAG12_SEP_PIPE
        + (dip & (sep == ord("/"))) * FLAG12_SEP_SLASH
    )
    out[:, R12_FLAGS_OFF] = flags.astype(np.uint8)

    # --- intern chrom strings -> ids (first-seen order, like native) ----
    chrom_len = np.minimum(r[:, CHROM_LEN_OFF], CHROM_CAP)
    chrom_bytes = r[:, CHROM_OFF : CHROM_OFF + CHROM_CAP].copy()
    chrom_bytes *= np.arange(CHROM_CAP, dtype=np.uint8)[None, :] < chrom_len[:, None]
    keys = chrom_bytes.view(f"S{CHROM_CAP}")[:, 0]
    uniq, first_idx, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)  # restore first-seen order
    if len(uniq) > 255:
        raise ValueError("more than 255 distinct chroms; use the 64-byte framer")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    out[:, R12_CHROM_ID_OFF] = rank[inv].astype(np.uint8)
    table = [uniq[i].decode() for i in order]
    return out, table


# ---------------------------------------------------------------------
# v2 layout (the single-pass converter; mirrored in cpp/hostio.cpp
# frame_range_v2): every requested sample of a record in one pass.
#   fixed (N, 5): [0:2) POS delta from the previous record, u16 LE
#                 [2] ref first byte  [3] alt first byte  [4] flags (V2F_*)
#   gt (N, S):    one byte a (record, sample):
#                 bits 0-1 first-allele class, bits 2-3 second-allele class
#                 (V2_GT_CLASS_*), bits 4-5 separator (V2G_SEP_*),
#                 bit6 HAS_GT    bit7 DIPLOID_LEN (subfield >= 3 chars)
# Side arrays: exc_idx/exc_pos (record index + absolute POS of every
# escaped record: chunk starts, chrom changes, gaps > 65535, malformed POS;
# the decode rebuilds POS as cumsum(delta) plus a scatter/cumsum fix-up)
# and run_counts/run_ids (chrom run-lengths; record index -> chrom id by a
# search over the cumulative counts).  True REF/ALT lengths are reduced to
# the REF1/ALT1 bits: the layout serves the SNP pipeline, whose records
# have length-1 alleles (reference cpp/vcfpp.h:990-1000 isSNP).
# ---------------------------------------------------------------------

V2_FIXED_SIZE = 5
V2_DELTA_OFF, V2_REF_OFF, V2_ALT_OFF, V2_FLAGS_OFF = 0, 2, 3, 4

V2F_WELL_FORMED = 1  # >= 8 fields AND POS is 1-10 digits fitting u32
V2F_REF1 = 2  # ref_len == 1
V2F_ALT1 = 4  # alt_len == 1
V2F_POS_ESCAPE = 8  # absolute POS carried in the exception arrays

#: ``stop`` of v2-decoded rows whose REF is multi-base: the layout carries no
#: REF length, so ``stop = start + 1`` holds only under the ref1 predicate;
#: other rows get this value, and struct assembly refuses to write it
#: (End() = pos + rlen, reference cpp/vcfpp.h:1118-1127)
V2_STOP_SENTINEL = 0xFFFFFFFF

V2_GT_CLASS_ZERO = 0  # '0'
V2_GT_CLASS_NONZERO = 1  # '1'..'9'
V2_GT_CLASS_MISSING = 2  # '.'
V2_GT_CLASS_OTHER = 3  # anything else / absent
V2G_A0_SHIFT, V2G_A2_SHIFT, V2G_SEP_SHIFT = 0, 2, 4
V2G_SEP_NONE, V2G_SEP_PIPE, V2G_SEP_SLASH, V2G_SEP_OTHER = 0, 1, 2, 3
V2G_HAS_GT = 0x40
V2G_DIPLOID = 0x80


@dataclass
class FrameV2:
    """A v2-framed batch: fixed records, the GT matrix and the side arrays."""

    fixed: np.ndarray  # (N, 5) uint8
    gt: np.ndarray  # (N, S) uint8 (S may be 0)
    exc_idx: np.ndarray  # (E,) int64: escaped record indices (sorted)
    exc_pos: np.ndarray  # (E,) uint32: absolute POS (1-based; 0 malformed)
    run_counts: np.ndarray  # (R,) int64: chrom run lengths
    run_ids: np.ndarray  # (R,) uint8: chrom table ids per run
    chroms: list[str]  # chrom table
    samples: list[str]  # GT slot order
    total_seen: int  # data lines inspected (before the region filter)
    blocks_decoded: int = -1  # BGZF blocks inflated (-1 = full scan)

    @property
    def n(self) -> int:
        return int(self.fixed.shape[0])

    @property
    def n_samples(self) -> int:
        return int(self.gt.shape[1]) if self.gt.ndim == 2 else 0

    def wire_bytes(self) -> int:
        """Bytes shipped to the device for this batch."""
        return int(
            self.fixed.nbytes
            + self.gt.nbytes
            + self.exc_idx.nbytes
            + self.exc_pos.nbytes
            + self.run_counts.nbytes
            + self.run_ids.nbytes
        )


def _gt_class2(chars: np.ndarray) -> np.ndarray:
    """ASCII GT chars -> 2-bit classes (cpp gt_class2 twin)."""
    out = np.full(chars.shape, V2_GT_CLASS_OTHER, dtype=np.uint8)
    out[chars == ord("0")] = V2_GT_CLASS_ZERO
    out[(chars >= ord("1")) & (chars <= ord("9"))] = V2_GT_CLASS_NONZERO
    out[chars == ord(".")] = V2_GT_CLASS_MISSING
    return out


def _gt_byte(gt: bytes) -> int:
    """One sample's GT subfield -> its v2 byte."""
    g = V2G_HAS_GT
    g |= int(_gt_class2(np.frombuffer(gt[:1] or b"\0", np.uint8))[0])
    g |= int(_gt_class2(np.frombuffer(gt[2:3] or b"\0", np.uint8))[0]) << V2G_A2_SHIFT
    if len(gt) >= 2:
        sep = gt[1:2]
        sc = V2G_SEP_PIPE if sep == b"|" else (V2G_SEP_SLASH if sep == b"/" else V2G_SEP_OTHER)
        g |= sc << V2G_SEP_SHIFT
    if len(gt) >= 3:
        g |= V2G_DIPLOID
    return g


def frame_v2_py(text: bytes, samples: list[str] | None, region: str | None) -> FrameV2:
    """The pure-Python v2 framer over decompressed VCF text: one pass, every
    requested sample at once.

    ``samples``: None/[] = no genotypes; ``["*"]`` = every header sample;
    else the named samples in the given slot order."""
    chrom_f, beg, end = "", -1, -1
    if region:
        if ":" in region and "-" in region.split(":")[-1]:
            chrom_f, span = region.rsplit(":", 1)
            b, e = span.split("-", 1)
            beg = (int(b) - 1) if b else -1
            end = int(e) if e else -1
        else:
            chrom_f = region
    chrom_fb = chrom_f.encode()

    col_to_slot: dict[int, int] = {}
    order: list[str] = []
    fixed_rows: list[bytes] = []
    gt_rows: list[bytes] = []
    exc_idx: list[int] = []
    exc_pos: list[int] = []
    run_counts: list[int] = []
    run_ids: list[int] = []
    chroms: list[str] = []
    chrom_lut: dict[bytes, int] = {}
    seen = 0
    prev_pos = -1
    last_chrom = -1
    S = 0

    for line in text.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line:
            continue
        if line.startswith(b"#"):
            if line.startswith(b"#CHROM"):
                header_samples = [f.decode() for f in line.split(b"\t")[9:]]
                if samples:
                    if samples == ["*"]:
                        order = list(header_samples)
                        col_to_slot = {i: i for i in range(len(order))}
                    else:
                        for slot, name in enumerate(samples):
                            try:
                                col_to_slot[header_samples.index(name)] = slot
                            except ValueError:
                                raise RuntimeError(f"sample not found in VCF header: {name}")
                        order = list(samples)
                    S = len(order)
            continue
        seen += 1
        fields = line.split(b"\t")
        if len(fields) < 8:
            continue
        if chrom_fb and fields[0] != chrom_fb:
            continue
        pos_b = fields[1]
        pos_ok = 1 <= len(pos_b) <= 10 and pos_b.isdigit()
        pos = int(pos_b) if pos_ok else 0
        if pos_ok and pos > 0xFFFFFFFF:
            pos_ok, pos = False, 0
        if chrom_fb and (beg >= 0 or end >= 0):
            if not pos_ok:
                continue
            start0 = pos - 1
            if (beg >= 0 and start0 < beg) or (end >= 0 and start0 >= end):
                continue

        cid = chrom_lut.get(fields[0])
        if cid is None:
            if len(chroms) >= 255:
                raise ValueError("more than 255 distinct chroms; use the 64-byte framer")
            cid = len(chroms)
            chrom_lut[fields[0]] = cid
            chroms.append(fields[0].decode())

        gt_row = bytearray(S)
        if S:
            fmt = fields[8].split(b":") if len(fields) > 8 else []
            try:
                gt_i = fmt.index(b"GT")
            except ValueError:
                continue  # no GT in FORMAT: the record is skipped, as natively
            for col, slot in col_to_slot.items():
                if len(fields) <= 9 + col:
                    continue
                subs = fields[9 + col].split(b":")
                if gt_i < len(subs):
                    gt_row[slot] = _gt_byte(subs[gt_i])

        flags = 0
        if pos_ok:
            flags |= V2F_WELL_FORMED
        if len(fields[3]) == 1:
            flags |= V2F_REF1
        if len(fields[4]) == 1:
            flags |= V2F_ALT1
        delta = pos - prev_pos if pos_ok else -1
        idx = len(fixed_rows)
        if not pos_ok or prev_pos < 0 or cid != last_chrom or not (0 <= delta <= 0xFFFF):
            flags |= V2F_POS_ESCAPE
            exc_idx.append(idx)
            exc_pos.append(pos if pos_ok else 0)
            delta = 0
        prev_pos = pos if pos_ok else -1
        fixed_rows.append(bytes((
            delta & 0xFF,
            delta >> 8,
            fields[3][0] if fields[3] else 0,
            fields[4][0] if fields[4] else 0,
            flags,
        )))
        gt_rows.append(bytes(gt_row))
        if last_chrom == cid and run_counts:
            run_counts[-1] += 1
        else:
            run_counts.append(1)
            run_ids.append(cid)
        last_chrom = cid

    n = len(fixed_rows)
    fixed = (np.frombuffer(b"".join(fixed_rows), np.uint8).reshape(n, V2_FIXED_SIZE).copy()
             if n else np.zeros((0, V2_FIXED_SIZE), np.uint8))
    gt = (np.frombuffer(b"".join(gt_rows), np.uint8).reshape(n, S).copy()
          if n and S else np.zeros((n, S), np.uint8))
    return FrameV2(
        fixed=fixed,
        gt=gt,
        exc_idx=np.asarray(exc_idx, np.int64),
        exc_pos=np.asarray(exc_pos, np.uint32),
        run_counts=np.asarray(run_counts, np.int64),
        run_ids=np.asarray(run_ids, np.uint8),
        chroms=chroms,
        samples=order,
        total_seen=seen,
    )


@dataclass
class FramedRecords:
    """A batch of framed VCF records plus provenance counts."""

    #: (n, 64) uint8 matrix of framed records
    records: np.ndarray
    #: total data lines inspected by the framer (pre region-filter)
    total_seen: int

    @property
    def n(self) -> int:
        return int(self.records.shape[0])


def frames_to_fields(records: np.ndarray) -> dict[str, np.ndarray]:
    """An (n, 64) frame matrix as named column views."""
    r = np.ascontiguousarray(records, dtype=np.uint8)
    return {
        "chrom": r[:, CHROM_OFF : CHROM_OFF + CHROM_CAP],
        "chrom_len": r[:, CHROM_LEN_OFF],
        "pos": r[:, POS_OFF : POS_OFF + POS_CAP],
        "pos_len": r[:, POS_LEN_OFF],
        "ref": r[:, REF_OFF : REF_OFF + REF_CAP],
        "ref_len": r[:, REF_LEN_OFF],
        "alt": r[:, ALT_OFF : ALT_OFF + ALT_CAP],
        "alt_len": r[:, ALT_LEN_OFF],
        "gt": r[:, GT_OFF : GT_OFF + GT_CAP],
        "gt_len": r[:, GT_LEN_OFF],
        "flags": r[:, FLAGS_OFF],
    }


def pack_frame(
    chrom: bytes,
    pos: bytes,
    ref: bytes,
    alt: bytes,
    gt: bytes | None,
) -> np.ndarray:
    """Build one framed record (the pure-Python framer's helper)."""
    rec = np.zeros(REC_SIZE, dtype=np.uint8)

    def put(data: bytes, off: int, cap: int, len_off: int, true_len_cap=255):
        view = data[:cap]
        rec[off : off + len(view)] = np.frombuffer(view, dtype=np.uint8)
        rec[len_off] = min(len(data), true_len_cap)

    put(chrom, CHROM_OFF, CHROM_CAP, CHROM_LEN_OFF, true_len_cap=CHROM_CAP)
    put(pos, POS_OFF, POS_CAP, POS_LEN_OFF, true_len_cap=POS_CAP)
    put(ref, REF_OFF, REF_CAP, REF_LEN_OFF)
    put(alt, ALT_OFF, ALT_CAP, ALT_LEN_OFF)
    flags = FLAG_WELL_FORMED
    if gt is not None:
        put(gt, GT_OFF, GT_CAP, GT_LEN_OFF, true_len_cap=GT_CAP)
        flags |= FLAG_HAS_GT
    rec[FLAGS_OFF] = flags
    return rec
