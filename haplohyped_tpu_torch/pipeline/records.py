"""Decode columns -> the reference's SNP structured array.

The port's copy of ``haplohyped_tpu.pipeline.records``: one donor's struct
from a per-donor decode, and every donor's from one single-pass (v2 or BCF)
decode.

The struct layout (``chrom S5, start u4, stop u4, ref S10, alt S10,
phase1 i1, phase2 i1``) is pinned by the reference writer
(``vcf_to_h5.py:119-129``) and is the bit-exactness gate for cohort
artifacts.  Only biallelic SNPs pass, so REF/ALT are single characters here;
the S10 width is preserved for format parity.
"""

from __future__ import annotations

import numpy as np

from haplohyped_tpu_torch.core.constants import SNP_STRUCT_DTYPE
from haplohyped_tpu_torch.hostio.frame_format import CHROM_CAP, CHROM_OFF


def _set_u32(st: np.ndarray, name: str, values: np.ndarray) -> None:
    """Write a u4 field of the packed SNP struct through a uint8 view.

    The struct is PACKED (itemsize 35), so ``start``/``stop`` sit at
    unaligned offsets and numpy's field-assignment path for them is ~100x
    slower than a strided byte copy (measured 1.6s vs 0.018s for 2M rows —
    it dominated whole-genome conversion).  Byte-level copy is exact for
    the little-endian '<u4' fields.

    An empty struct has nothing to write (the JAX package's copy raises
    there, as a view at a field offset past its 0-byte buffer)."""
    if st.shape[0] == 0:
        return
    off = st.dtype.fields[name][1]
    view = np.ndarray(
        (st.shape[0], 4),
        dtype=np.uint8,
        buffer=st,
        offset=off,
        strides=(st.dtype.itemsize, 1),
    )
    view[:] = np.ascontiguousarray(values, dtype="<u4")[:, None].view(np.uint8)


def snp_struct_from_decoded(
    decoded: dict[str, np.ndarray],
    chrom_bytes: np.ndarray,  # (N, 8) uint8, zero-padded
    with_sample: bool = True,
    chrom_filter: str | None = None,
) -> np.ndarray:
    """Assemble the SNP structured array from decode columns.

    Applies validity & SNP masks (streaming order preserved); an optional
    ``chrom_filter`` keeps only records whose CHROM matches (used by the
    tokenizer path, which does not pre-filter by region).
    """
    keep = np.asarray(decoded["valid"]) & np.asarray(decoded["snp_mask"])
    chrom_bytes = np.ascontiguousarray(chrom_bytes, dtype=np.uint8)
    if chrom_filter is not None:
        target = np.zeros(CHROM_CAP, dtype=np.uint8)
        enc = chrom_filter.encode()[:CHROM_CAP]
        target[: len(enc)] = np.frombuffer(enc, dtype=np.uint8)
        keep &= (chrom_bytes == target[None, :]).all(axis=1)
    idx = np.nonzero(keep)[0]
    out = np.empty(idx.shape[0], dtype=SNP_STRUCT_DTYPE)

    # zero-padded fixed-width bytes -> S8 -> truncate to S5 (reference casts
    # chrom to S5, silently truncating longer names — same here)
    out["chrom"] = (
        np.ascontiguousarray(chrom_bytes[idx]).view(f"S{CHROM_CAP}").ravel().astype("S5")
    )
    _set_u32(out, "start", decoded["start"][idx])
    _set_u32(out, "stop", decoded["stop"][idx])
    out["ref"] = np.ascontiguousarray(decoded["ref_char"][idx]).view("S1").astype("S10")
    out["alt"] = np.ascontiguousarray(decoded["alt_char"][idx]).view("S1").astype("S10")
    if with_sample:
        out["phase1"] = decoded["phase1"][idx]
        out["phase2"] = decoded["phase2"][idx]
    else:
        out["phase1"] = 0
        out["phase2"] = 0
    return out


def snp_struct_from_frames(
    frames: np.ndarray,
    decoded: dict[str, np.ndarray],
    with_sample: bool = True,
) -> np.ndarray:
    """Framed-record variant: chrom columns come from the frame matrix."""
    chrom_bytes = frames[:, CHROM_OFF : CHROM_OFF + CHROM_CAP]
    return snp_struct_from_decoded(decoded, chrom_bytes, with_sample)


def snp_structs_from_v2(
    decoded: dict[str, np.ndarray],
    chrom_table: list[str],
    samples: list[str],
    chrom_filter: str | None = None,
) -> dict[str, np.ndarray]:
    """Every donor's SNP struct from ONE decode of all samples.

    ``decoded`` holds host numpy columns in the schema of
    ``decode_frames_v2`` (``phase1``/``phase2``/``valid`` are ``(N, S)``;
    views of ``(S, N)`` arrays make each donor's column contiguous).  The
    shared record columns (chrom, start, stop, ref, alt) of the records that
    pass the SNP predicate are written into one struct once; a donor's
    struct is the rows of it that donor's ``valid`` keeps, with that donor's
    phases.  A donor with no kept SNP gets an empty struct.  Replaces the
    reference's per-donor re-parse (``vcf_to_h5.py:142-152``)."""
    snp = np.asarray(decoded["snp_mask"])
    chrom_id = np.asarray(decoded["chrom_id"])
    if chrom_filter is not None and chrom_table:
        want = np.array([c == chrom_filter for c in chrom_table], dtype=bool)
        snp = snp & want[chrom_id]
    start = np.asarray(decoded["start"])
    stop = np.asarray(decoded["stop"])

    # the v2 layout has no REF length: stop holds only under the ref1
    # predicate (multi-base REFs carry V2_STOP_SENTINEL).  snp_mask implies
    # ref1, so a sentinel past the keep mask means a caller bypassed the
    # predicate: fail instead of writing wrong intervals (End() = pos + rlen,
    # reference cpp/vcfpp.h:1118-1127)
    if snp.any() and (stop[snp] != start[snp] + 1).any():
        raise ValueError(
            "v2 decode: kept rows carry the multi-base-REF stop sentinel; "
            "the SNP predicate was not applied before struct assembly"
        )

    rows = np.nonzero(snp)[0]
    shared = np.zeros(rows.shape[0], dtype=SNP_STRUCT_DTYPE)
    if chrom_table:
        shared["chrom"] = np.array(chrom_table, dtype="S5")[chrom_id[rows]]
    _set_u32(shared, "start", start[rows])
    _set_u32(shared, "stop", stop[rows])
    for field in ("ref", "alt"):
        chars = np.asarray(decoded[f"{field}_char"])[rows]
        shared[field] = np.ascontiguousarray(chars).view("S1").astype("S10")

    valid, phase1, phase2 = (np.asarray(decoded[k]) for k in ("valid", "phase1", "phase2"))
    out: dict[str, np.ndarray] = {}
    for s, donor in enumerate(samples):
        keep = valid[:, s][rows]
        st = shared[keep]
        kept = rows[keep]
        st["phase1"] = phase1[:, s][kept]
        st["phase2"] = phase2[:, s][kept]
        out[donor] = st
    return out


def snp_struct_from_frames12(
    decoded: dict[str, np.ndarray],
    chrom_table: list[str],
    with_sample: bool = True,
    chrom_filter: str | None = None,
) -> np.ndarray:
    """Compact-frame variant: chrom strings come from the framer's table,
    indexed by the decode output's ``chrom_id`` column."""
    keep = np.asarray(decoded["valid"]) & np.asarray(decoded["snp_mask"])
    chrom_id = np.asarray(decoded["chrom_id"])
    if chrom_filter is not None and chrom_table:
        want = np.array([c == chrom_filter for c in chrom_table], dtype=bool)
        keep &= want[chrom_id]
    idx = np.nonzero(keep)[0]
    out = np.empty(idx.shape[0], dtype=SNP_STRUCT_DTYPE)
    # reference casts chrom to S5, silently truncating longer names
    table_s5 = np.array(chrom_table if chrom_table else [""], dtype="S5")
    out["chrom"] = table_s5[chrom_id[idx]] if chrom_table else b""
    _set_u32(out, "start", np.asarray(decoded["start"])[idx])
    _set_u32(out, "stop", np.asarray(decoded["stop"])[idx])
    out["ref"] = (
        np.ascontiguousarray(np.asarray(decoded["ref_char"])[idx]).view("S1").astype("S10")
    )
    out["alt"] = (
        np.ascontiguousarray(np.asarray(decoded["alt_char"])[idx]).view("S1").astype("S10")
    )
    if with_sample:
        out["phase1"] = np.asarray(decoded["phase1"])[idx]
        out["phase2"] = np.asarray(decoded["phase2"])[idx]
    else:
        out["phase1"] = 0
        out["phase2"] = 0
    return out
