"""Framed VCF record layouts (must stay in sync with cpp/hostio.cpp).

The port's own copy of the 64-byte and 12-byte halves of
``haplohyped_tpu.hostio.frame_format`` (the v2 layout comes with the
single-pass converter).

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
