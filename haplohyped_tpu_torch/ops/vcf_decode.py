"""VCF record decoding: the plain PyTorch versions and the host helpers.

The port of ``haplohyped_tpu.ops.vcf_decode``:

- :func:`decode_frames` and :func:`decode_frames12` decode ``(N, 64)`` and
  ``(N, 12)`` uint8 frame matrices into variant columns: POS digits ->
  0-based ``start`` and ``stop = start + rlen``, the biallelic-SNP
  predicate, and the genotype's allele presence (a missing genotype is
  coded (1, 0) with a missing flag), phase and validity;
  :func:`decode_planes12` is :func:`decode_frames12` on the transposed
  ``(12, N)`` byte planes.
- :func:`decode_frames_v2` decodes the v2 layout of the single-pass
  converter (every sample of a record at once): POS from u16 deltas and the
  escape arrays, chrom ids from the run lengths, and ``(N, S)`` genotype
  columns.  It is :func:`decode_v2_records` (the per-record columns) and
  :func:`decode_v2_genotypes` (elementwise over a GT byte matrix of any
  shape, so the converter can decode it a sample block at a time).  These
  are torch ops on the frame's device; no hand-written kernel, as the JAX
  package's is XLA code, not a Pallas kernel.
- :func:`decode_frames12_packed` and :func:`decode_frames_packed` give the
  same function in the int32 wire formats of the Hopper kernels in
  :mod:`haplohyped_tpu_torch.ops.decode_kernel` (3 and 7 columns a record).
  They are those kernels' plain versions: the tests and ``chip_smoke.py``
  hold each kernel bit-equal to them.
- numpy helpers: :func:`unpack12_columns` and :func:`unpack64_columns` turn
  the wire formats back into the decode dict on the host
  (:func:`unpack64_decoded` is the 64-byte one on the device);
  :func:`decode_frames12_numpy`, :func:`decode_frames_numpy` and
  :func:`decode_frames_v2_numpy` are the JAX package's numpy twins (the
  converter's ``device_decode=False`` path); :func:`pad_v2_sides` pads a v2
  frame's side arrays with inert entries.

POS arithmetic follows the JAX package's uint32 bit for bit, malformed
records included: the torch versions compute in int64 and keep the low 32
bits (torch's uint32 ops are partial), so a value that wraps in uint32 wraps
here too.  ``start``/``stop`` of the dict outputs are such uint32 values held
in int64; the packed outputs carry their bits as int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from haplohyped_tpu_torch.core.constants import BASE_LUT
from haplohyped_tpu_torch.hostio.frame_format import (
    ALT_LEN_OFF,
    ALT_OFF,
    FLAG12_DIPLOID_LEN,
    FLAG12_HAS_GT,
    FLAG12_SEP_PIPE,
    FLAG12_SEP_SLASH,
    FLAG12_WELL_FORMED,
    FLAG_HAS_GT,
    FLAG_WELL_FORMED,
    FLAGS_OFF,
    GT_LEN_OFF,
    GT_NIBBLE_MISSING,
    GT_OFF,
    POS_CAP,
    POS_LEN_OFF,
    POS_OFF,
    R12_ALT_LEN_OFF,
    R12_ALT_OFF,
    R12_CHROM_ID_OFF,
    R12_FLAGS_OFF,
    R12_GT_OFF,
    R12_POS_BYTES,
    R12_POS_NIBBLES,
    R12_POS_OFF,
    R12_REF_LEN_OFF,
    R12_REF_OFF,
    REC12_SIZE,
    REC_SIZE,
    REF_LEN_OFF,
    REF_OFF,
    V2_ALT_OFF,
    V2_FLAGS_OFF,
    V2_GT_CLASS_MISSING,
    V2_REF_OFF,
    V2_STOP_SENTINEL,
    V2F_ALT1,
    V2F_POS_ESCAPE,
    V2F_REF1,
    V2F_WELL_FORMED,
    V2G_DIPLOID,
    V2G_HAS_GT,
    V2G_SEP_PIPE,
    V2G_SEP_SHIFT,
    V2G_SEP_SLASH,
    V2_FIXED_SIZE,
)
from haplohyped_tpu_torch.ops.onehot import ascii_to_codes

# weights for digit positions; entries beyond 10^9 would overflow uint32 and
# can only arise for out-of-spec >10-digit positions (VCF POS is int32) — zeroed
_POW10 = np.array([10**i if i < 10 else 0 for i in range(POS_CAP)], dtype=np.uint32)

_MASK32 = 0xFFFFFFFF
_ACGT = tuple(b"ACGT")


class DecodedVariants(NamedTuple):
    """Struct-of-arrays decode output; all tensors have leading dim N."""

    start: torch.Tensor  # int64 holding the uint32 0-based start
    stop: torch.Tensor  # int64 holding the uint32 start + rlen
    ref_char: torch.Tensor  # uint8 first REF byte (ASCII)
    alt_char: torch.Tensor  # uint8 first ALT byte (ASCII)
    ref_code: torch.Tensor  # int8 base code of REF (N for non-ACGT)
    alt_code: torch.Tensor  # int8 base code of ALT
    phase1: torch.Tensor  # int8 allele presence, haplotype 1
    phase2: torch.Tensor  # int8 allele presence, haplotype 2
    phased: torch.Tensor  # bool, GT separator was '|'
    missing: torch.Tensor  # bool, genotype was missing
    snp_mask: torch.Tensor  # bool, biallelic SNP predicate
    valid: torch.Tensor  # bool, well-formed (+ diploid GT when requested)


def _frames(frames: torch.Tensor, width: int) -> torch.Tensor:
    if frames.dtype != torch.uint8 or frames.dim() != 2 or frames.shape[1] != width:
        raise ValueError(
            f"frames must be (N, {width}) uint8, got {tuple(frames.shape)} {frames.dtype}"
        )
    return frames


def _is_acgt(alt_char: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(alt_char.shape, dtype=torch.bool, device=alt_char.device)
    for base in _ACGT:
        out |= alt_char == base
    return out


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def decode_frames(frames: torch.Tensor, with_sample: bool = True) -> DecodedVariants:
    """Decode an ``(N, 64)`` uint8 frame matrix into variant columns."""
    f = _frames(frames, REC_SIZE)
    n, dev = f.shape[0], f.device

    # --- POS digits -> uint32 (weight 10^(pos_len-1-i) where that is 10^0..10^9)
    digits = f[:, POS_OFF : POS_OFF + POS_CAP].long() - ord("0")
    pos_len = f[:, POS_LEN_OFF].long()
    exp = pos_len[:, None] - 1 - torch.arange(POS_CAP, device=dev)[None, :]
    weights = torch.where(
        (exp >= 0) & (exp <= 9), torch.pow(10, exp.clamp(0, 9)), torch.zeros_like(exp)
    )
    pos = (digits * weights).sum(dim=1) & _MASK32
    start = (pos - 1) & _MASK32  # VCF POS is 1-based; Start() is 0-based

    # --- REF / ALT ----------------------------------------------------
    ref_len = f[:, REF_LEN_OFF].long()
    alt_len = f[:, ALT_LEN_OFF].long()
    stop = (start + ref_len) & _MASK32  # End() = pos + rlen
    ref_char = f[:, REF_OFF]
    alt_char = f[:, ALT_OFF]
    snp_mask = (ref_len == 1) & (alt_len == 1) & _is_acgt(alt_char)

    flags = f[:, FLAGS_OFF]
    well_formed = (flags & FLAG_WELL_FORMED) != 0

    # --- genotype -----------------------------------------------------
    if with_sample:
        g0, g1, g2 = f[:, GT_OFF], f[:, GT_OFF + 1], f[:, GT_OFF + 2]
        has_gt = (flags & FLAG_HAS_GT) != 0
        sep_ok = (g1 == ord("|")) | (g1 == ord("/"))
        diploid = has_gt & (f[:, GT_LEN_OFF] >= 3) & sep_ok
        missing = diploid & ((g0 == ord(".")) | (g2 == ord(".")))
        phase1 = torch.where(missing, 1, (g0 != ord("0")).to(torch.int8)).to(torch.int8)
        phase2 = torch.where(missing, 0, (g2 != ord("0")).to(torch.int8)).to(torch.int8)
        phased = diploid & (g1 == ord("|"))
        valid = well_formed & diploid
    else:
        phase1 = torch.zeros(n, dtype=torch.int8, device=dev)
        phase2 = torch.zeros(n, dtype=torch.int8, device=dev)
        phased = torch.zeros(n, dtype=torch.bool, device=dev)
        missing = torch.zeros(n, dtype=torch.bool, device=dev)
        valid = well_formed

    return DecodedVariants(
        start=start,
        stop=stop,
        ref_char=ref_char,
        alt_char=alt_char,
        ref_code=ascii_to_codes(ref_char),
        alt_code=ascii_to_codes(alt_char),
        phase1=phase1,
        phase2=phase2,
        phased=phased,
        missing=missing,
        snp_mask=snp_mask,
        valid=valid,
    )


def decode_frames_packed(
    frames: torch.Tensor, with_sample: bool = True
) -> tuple[torch.Tensor, ...]:
    """:func:`decode_frames` in the 64-byte kernel's wire format: seven
    int32 columns ``(start, stop, ref_char, alt_char, phase1, phase2,
    flags)``, ``flags = snp | valid<<1 | missing<<2 | phased<<3`` (the
    outputs of the JAX package's Pallas ``_decode_kernel``).  Unpack with
    :func:`unpack64_columns`."""
    d = decode_frames(frames, with_sample)
    flags = (
        d.snp_mask.int()
        | (d.valid.int() << 1)
        | (d.missing.int() << 2)
        | (d.phased.int() << 3)
    )
    return (
        _as_int32(d.start),
        _as_int32(d.stop),
        d.ref_char.int(),
        d.alt_char.int(),
        d.phase1.int(),
        d.phase2.int(),
        flags,
    )


def decode_frames12(frames: torch.Tensor, with_sample: bool = True) -> dict[str, torch.Tensor]:
    """Decode an ``(N, 12)`` compact frame matrix (pack_rec12 layout).

    Same semantics as :func:`decode_frames`, returned as a dict with the
    extra ``chrom_id`` column (index into the framer's chrom table)."""
    f = _frames(frames, REC12_SIZE)
    n, dev = f.shape[0], f.device

    # --- POS: 10 zero-padded BCD nibbles, most significant first -------
    pos_bytes = f[:, R12_POS_OFF : R12_POS_OFF + R12_POS_BYTES].long()
    nib = torch.stack([pos_bytes >> 4, pos_bytes & 0xF], dim=2).reshape(n, R12_POS_NIBBLES)
    w = torch.pow(10, torch.arange(R12_POS_NIBBLES - 1, -1, -1, device=dev))  # 10^9 .. 10^0
    pos = (nib * w[None, :]).sum(dim=1) & _MASK32
    start = (pos - 1) & _MASK32

    ref_len = f[:, R12_REF_LEN_OFF].long()
    alt_len = f[:, R12_ALT_LEN_OFF].long()
    stop = (start + ref_len) & _MASK32
    ref_char = f[:, R12_REF_OFF]
    alt_char = f[:, R12_ALT_OFF]
    snp_mask = (ref_len == 1) & (alt_len == 1) & _is_acgt(alt_char)

    flags = f[:, R12_FLAGS_OFF]
    well_formed = (flags & FLAG12_WELL_FORMED) != 0

    if with_sample:
        gt = f[:, R12_GT_OFF]
        g0n, g2n = gt >> 4, gt & 0xF
        has_gt = (flags & FLAG12_HAS_GT) != 0
        sep_ok = (flags & (FLAG12_SEP_PIPE | FLAG12_SEP_SLASH)) != 0
        diploid = has_gt & ((flags & FLAG12_DIPLOID_LEN) != 0) & sep_ok
        missing = diploid & ((g0n == GT_NIBBLE_MISSING) | (g2n == GT_NIBBLE_MISSING))
        phase1 = torch.where(missing, 1, (g0n != 0).to(torch.int8)).to(torch.int8)
        phase2 = torch.where(missing, 0, (g2n != 0).to(torch.int8)).to(torch.int8)
        phased = diploid & ((flags & FLAG12_SEP_PIPE) != 0)
        valid = well_formed & diploid
    else:
        phase1 = torch.zeros(n, dtype=torch.int8, device=dev)
        phase2 = torch.zeros(n, dtype=torch.int8, device=dev)
        phased = torch.zeros(n, dtype=torch.bool, device=dev)
        missing = torch.zeros(n, dtype=torch.bool, device=dev)
        valid = well_formed

    return {
        "start": start,
        "stop": stop,
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": ascii_to_codes(ref_char),
        "alt_code": ascii_to_codes(alt_char),
        "phase1": phase1,
        "phase2": phase2,
        "phased": phased,
        "missing": missing,
        "snp_mask": snp_mask,
        "valid": valid,
        "chrom_id": f[:, R12_CHROM_ID_OFF],
    }


def decode_frames12_packed(
    frames: torch.Tensor, with_sample: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_frames12` packed into the 12-byte kernel's wire format,
    three int32 columns ``(start, meta, ref_len)`` with ``meta = ref_char |
    alt_char<<8 | chrom_id<<16 | flags<<24`` and ``flags = snp | valid<<1 |
    missing<<2 | phased<<3 | phase1<<4 | phase2<<5`` (phases masked to bit
    0).  Unpack with :func:`unpack12_columns`."""
    d = decode_frames12(frames, with_sample)
    flags = (
        d["snp_mask"].int()
        | (d["valid"].int() << 1)
        | (d["missing"].int() << 2)
        | (d["phased"].int() << 3)
        | ((d["phase1"].int() & 1) << 4)
        | ((d["phase2"].int() & 1) << 5)
    )
    meta = (
        d["ref_char"].int()
        | (d["alt_char"].int() << 8)
        | (d["chrom_id"].int() << 16)
        | (flags << 24)
    )
    ref_len = _as_int32((d["stop"] - d["start"]) & _MASK32)
    return _as_int32(d["start"]), meta, ref_len


def decode_planes12(planes: torch.Tensor, with_sample: bool = True) -> dict[str, torch.Tensor]:
    """:func:`decode_frames12` on the transposed wire layout: ``(12, N)``
    uint8 byte planes (plane ``k`` is byte ``k`` of every record)."""
    if planes.dim() != 2 or planes.shape[0] != REC12_SIZE:
        raise ValueError(f"planes must be (12, N) uint8, got {tuple(planes.shape)}")
    return decode_frames12(planes.t(), with_sample)


def decode_v2_records(
    fixed: torch.Tensor,
    exc_idx: torch.Tensor,
    exc_pos: torch.Tensor,
    run_counts: torch.Tensor,
    run_ids: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """The per-record columns of the v2 decode, on ``fixed``'s device.

    ``fixed`` is ``(N, 5)`` uint8; ``exc_idx`` the escaped records' indices
    (entries outside ``[0, N)`` are inert pads), ``exc_pos`` their absolute
    POS (uint32 values in any integer dtype torch converts, int64 say),
    ``run_counts``/``run_ids`` the chrom runs (zero-width runs are inert).

    POS: the u16 deltas are summed, and each escaped record re-anchors the
    chain: ``pos = cumsum(delta) + cumsum(scatter(correction))``, the
    correction at an escape being the step from the previous anchor's offset
    to the one that puts POS at ``exc_pos`` (uint32 arithmetic, so a
    "negative" re-anchor wraps: computed here in int64 and masked)."""
    f = _frames(fixed, V2_FIXED_SIZE)
    n, dev = f.shape[0], f.device
    flags = f[:, V2_FLAGS_OFF]
    escape = (flags & V2F_POS_ESCAPE) != 0

    delta = f[:, 0].long() | (f[:, 1].long() << 8)
    base = torch.where(escape, 0, delta).cumsum(0) & _MASK32
    corr = torch.zeros(n, dtype=torch.long, device=dev)
    ei = exc_idx.to(device=dev, dtype=torch.long)
    if n and ei.numel():
        s_tgt = (exc_pos.to(device=dev, dtype=torch.long) - base[ei.clamp(0, n - 1)]) & _MASK32
        c = s_tgt - torch.cat([s_tgt.new_zeros(1), s_tgt[:-1]])
        # pads (index N) add nothing; masking, not selecting, keeps the host
        # out of the decode (a boolean selection waits for the device)
        real = (ei >= 0) & (ei < n)
        corr.index_add_(0, torch.where(real, ei, 0), torch.where(real, c, 0))
    pos = (base + corr.cumsum(0)) & _MASK32
    start = (pos - 1) & _MASK32
    ref1 = (flags & V2F_REF1) != 0
    # multi-base REFs get the sentinel: v2 carries no REF length
    stop = torch.where(ref1, (start + 1) & _MASK32, V2_STOP_SENTINEL)

    ref_char = f[:, V2_REF_OFF]
    alt_char = f[:, V2_ALT_OFF]
    alt1 = (flags & V2F_ALT1) != 0

    # chrom ids from the run lengths
    cum = run_counts.to(device=dev, dtype=torch.long).cumsum(0)
    rid = torch.searchsorted(cum, torch.arange(n, device=dev), right=True)
    ids = run_ids.to(device=dev, dtype=torch.uint8)
    chrom_id = ids[rid.clamp(0, max(ids.shape[0] - 1, 0))]

    return {
        "start": start,
        "stop": stop,
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": ascii_to_codes(ref_char),
        "alt_code": ascii_to_codes(alt_char),
        "ref1": ref1,
        "alt1": alt1,
        "snp_mask": ref1 & alt1 & _is_acgt(alt_char),
        "well_formed": (flags & V2F_WELL_FORMED) != 0,
        "chrom_id": chrom_id,
    }


def decode_v2_genotypes(gt: torch.Tensor, well_formed: torch.Tensor) -> dict[str, torch.Tensor]:
    """The genotype columns of the v2 decode, elementwise over a GT byte
    matrix of any shape (``(N, S)``, or a transposed block ``(s, N)``), with
    ``well_formed`` broadcast against it (``(N, 1)`` or ``(1, N)``): the
    reference's allele-presence semantics (``vcfpp.h:508-531``), a missing
    allele coding (1, 0)."""
    if gt.dtype != torch.uint8:
        raise ValueError(f"gt must be uint8, got {gt.dtype}")
    a0 = gt & 3
    a2 = (gt >> 2) & 3
    sep = (gt >> V2G_SEP_SHIFT) & 3
    has_gt = (gt & V2G_HAS_GT) != 0
    sep_ok = (sep == V2G_SEP_PIPE) | (sep == V2G_SEP_SLASH)
    diploid = has_gt & ((gt & V2G_DIPLOID) != 0) & sep_ok
    missing = diploid & ((a0 == V2_GT_CLASS_MISSING) | (a2 == V2_GT_CLASS_MISSING))
    return {
        "phase1": torch.where(missing, 1, (a0 != 0).to(torch.int8)).to(torch.int8),
        "phase2": torch.where(missing, 0, (a2 != 0).to(torch.int8)).to(torch.int8),
        "phased": diploid & (sep == V2G_SEP_PIPE),
        "missing": missing,
        "valid": well_formed & diploid,
    }


def decode_frames_v2(
    fixed: torch.Tensor,
    gt: torch.Tensor,
    exc_idx: torch.Tensor,
    exc_pos: torch.Tensor,
    run_counts: torch.Tensor,
    run_ids: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Decode a v2 frame, ``(N, 5)`` fixed records and an ``(N, S)`` GT
    matrix, on the frame's device: the per-record columns of
    :func:`decode_v2_records` and the ``(N, S)`` columns of
    :func:`decode_v2_genotypes`, with the JAX package's keys.  ``stop`` is
    ``start + 1`` under the ref1 predicate and ``V2_STOP_SENTINEL`` else."""
    rec = decode_v2_records(fixed, exc_idx, exc_pos, run_counts, run_ids)
    if gt.dim() != 2 or gt.shape[0] != fixed.shape[0]:
        raise ValueError(f"gt must be (N, S) with N = {fixed.shape[0]}, got {tuple(gt.shape)}")
    return rec | decode_v2_genotypes(gt, rec["well_formed"][:, None])


def decoded_to_numpy(dec: DecodedVariants | dict) -> dict[str, np.ndarray]:
    """Decode output -> host numpy columns in the JAX package's dtypes
    (``start``/``stop`` uint32)."""
    items = dec._asdict().items() if isinstance(dec, tuple) else dec.items()
    out = {k: v.cpu().numpy() for k, v in items}
    for k in ("start", "stop"):
        out[k] = out[k].astype(np.uint32)
    return out


# ---------------------------------------------------------------------------
# host (numpy) helpers
# ---------------------------------------------------------------------------


def unpack12_columns(
    start: np.ndarray, meta: np.ndarray, ref_len: np.ndarray
) -> dict[str, np.ndarray]:
    """Host-side unpack of the packed 3-int32 decode wire format."""
    ref_char = (meta & 0xFF).astype(np.uint8)
    alt_char = ((meta >> 8) & 0xFF).astype(np.uint8)
    chrom_id = ((meta >> 16) & 0xFF).astype(np.uint8)
    flags = (meta >> 24) & 0xFF
    return {
        "start": start.astype(np.uint32),
        "stop": (start + ref_len).astype(np.uint32),
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": BASE_LUT[ref_char],
        "alt_code": BASE_LUT[alt_char],
        "phase1": ((flags >> 4) & 1).astype(np.int8),
        "phase2": ((flags >> 5) & 1).astype(np.int8),
        "phased": (flags & 8) != 0,
        "missing": (flags & 4) != 0,
        "snp_mask": (flags & 1) != 0,
        "valid": (flags & 2) != 0,
        "chrom_id": chrom_id,
    }


def unpack64_columns(
    start: np.ndarray,
    stop: np.ndarray,
    ref_char: np.ndarray,
    alt_char: np.ndarray,
    phase1: np.ndarray,
    phase2: np.ndarray,
    flags: np.ndarray,
) -> dict[str, np.ndarray]:
    """Host-side unpack of the 7-int32 wire format of the 64-byte decode
    (the schema of :func:`decode_frames_numpy`)."""
    ref_char = ref_char.astype(np.uint8)
    alt_char = alt_char.astype(np.uint8)
    return {
        "start": start.astype(np.uint32),
        "stop": stop.astype(np.uint32),
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": BASE_LUT[ref_char],
        "alt_code": BASE_LUT[alt_char],
        "phase1": phase1.astype(np.int8),
        "phase2": phase2.astype(np.int8),
        "phased": (flags & 8) != 0,
        "missing": (flags & 4) != 0,
        "snp_mask": (flags & 1) != 0,
        "valid": (flags & 2) != 0,
    }


def unpack64_decoded(
    start: torch.Tensor,
    stop: torch.Tensor,
    ref_char: torch.Tensor,
    alt_char: torch.Tensor,
    phase1: torch.Tensor,
    phase2: torch.Tensor,
    flags: torch.Tensor,
) -> DecodedVariants:
    """:func:`unpack64_columns` on the device: the 64-byte decode's seven
    int32 columns as the :class:`DecodedVariants` that :func:`decode_frames`
    returns for the same frames."""
    ref_char, alt_char = ref_char.to(torch.uint8), alt_char.to(torch.uint8)
    return DecodedVariants(
        start=start.long() & _MASK32,
        stop=stop.long() & _MASK32,
        ref_char=ref_char,
        alt_char=alt_char,
        ref_code=ascii_to_codes(ref_char),
        alt_code=ascii_to_codes(alt_char),
        phase1=phase1.to(torch.int8),
        phase2=phase2.to(torch.int8),
        phased=(flags & 8) != 0,
        missing=(flags & 4) != 0,
        snp_mask=(flags & 1) != 0,
        valid=(flags & 2) != 0,
    )


def decode_frames12_numpy(
    frames: np.ndarray, with_sample: bool = True
) -> dict[str, np.ndarray]:
    """Pure-numpy twin of :func:`decode_frames12` (the host decode path)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n = frames.shape[0]

    pos_bytes = frames[:, R12_POS_OFF : R12_POS_OFF + R12_POS_BYTES]
    nib = np.stack([pos_bytes >> 4, pos_bytes & 0xF], axis=2).reshape(n, R12_POS_NIBBLES)
    w = _POW10[:R12_POS_NIBBLES][::-1]
    pos = np.sum(nib.astype(np.uint32) * w[None, :], axis=1, dtype=np.uint32)
    start = pos - 1

    ref_len = frames[:, R12_REF_LEN_OFF].astype(np.uint32)
    alt_len = frames[:, R12_ALT_LEN_OFF].astype(np.uint32)
    stop = start + ref_len
    ref_char = frames[:, R12_REF_OFF]
    alt_char = frames[:, R12_ALT_OFF]
    is_acgt = np.isin(alt_char, np.frombuffer(b"ACGT", dtype=np.uint8))
    snp_mask = (ref_len == 1) & (alt_len == 1) & is_acgt

    flags = frames[:, R12_FLAGS_OFF]
    well_formed = (flags & FLAG12_WELL_FORMED) != 0

    if with_sample:
        gt = frames[:, R12_GT_OFF]
        g0n = gt >> 4
        g2n = gt & 0xF
        has_gt = (flags & FLAG12_HAS_GT) != 0
        sep_ok = (flags & (FLAG12_SEP_PIPE | FLAG12_SEP_SLASH)) != 0
        diploid = has_gt & ((flags & FLAG12_DIPLOID_LEN) != 0) & sep_ok
        missing = diploid & ((g0n == GT_NIBBLE_MISSING) | (g2n == GT_NIBBLE_MISSING))
        phase1 = np.where(missing, 1, g0n != 0).astype(np.int8)
        phase2 = np.where(missing, 0, g2n != 0).astype(np.int8)
        phased = diploid & ((flags & FLAG12_SEP_PIPE) != 0)
        valid = well_formed & diploid
    else:
        phase1 = np.zeros(n, np.int8)
        phase2 = np.zeros(n, np.int8)
        phased = np.zeros(n, bool)
        missing = np.zeros(n, bool)
        valid = well_formed

    return {
        "start": start,
        "stop": stop,
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": BASE_LUT[ref_char],
        "alt_code": BASE_LUT[alt_char],
        "phase1": phase1,
        "phase2": phase2,
        "phased": phased,
        "missing": missing,
        "snp_mask": snp_mask,
        "valid": valid,
        "chrom_id": frames[:, R12_CHROM_ID_OFF],
    }


def decode_frames_numpy(frames: np.ndarray, with_sample: bool = True) -> dict[str, np.ndarray]:
    """Pure-numpy twin of :func:`decode_frames` (the host decode path)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n = frames.shape[0]

    digits = frames[:, POS_OFF : POS_OFF + POS_CAP].astype(np.uint32) - ord("0")
    pos_len = frames[:, POS_LEN_OFF].astype(np.int32)
    exp = pos_len[:, None] - 1 - np.arange(POS_CAP, dtype=np.int32)[None, :]
    weights = np.where(exp >= 0, _POW10[np.clip(exp, 0, POS_CAP - 1)], 0).astype(np.uint32)
    pos = np.sum(digits * weights, axis=1, dtype=np.uint32)
    start = pos - 1

    ref_len = frames[:, REF_LEN_OFF].astype(np.uint32)
    alt_len = frames[:, ALT_LEN_OFF].astype(np.uint32)
    stop = start + ref_len
    ref_char = frames[:, REF_OFF]
    alt_char = frames[:, ALT_OFF]
    is_acgt = np.isin(alt_char, np.frombuffer(b"ACGT", dtype=np.uint8))
    snp_mask = (ref_len == 1) & (alt_len == 1) & is_acgt

    flags = frames[:, FLAGS_OFF]
    well_formed = (flags & FLAG_WELL_FORMED) != 0

    if with_sample:
        g0, g1, g2 = frames[:, GT_OFF], frames[:, GT_OFF + 1], frames[:, GT_OFF + 2]
        gt_len = frames[:, GT_LEN_OFF].astype(np.int32)
        has_gt = (flags & FLAG_HAS_GT) != 0
        sep_ok = (g1 == ord("|")) | (g1 == ord("/"))
        diploid = has_gt & (gt_len >= 3) & sep_ok
        missing = diploid & ((g0 == ord(".")) | (g2 == ord(".")))
        phase1 = np.where(missing, 1, (g0 != ord("0"))).astype(np.int8)
        phase2 = np.where(missing, 0, (g2 != ord("0"))).astype(np.int8)
        phased = diploid & (g1 == ord("|"))
        valid = well_formed & diploid
    else:
        phase1 = np.zeros(n, np.int8)
        phase2 = np.zeros(n, np.int8)
        phased = np.zeros(n, bool)
        missing = np.zeros(n, bool)
        valid = well_formed

    return {
        "start": start,
        "stop": stop,
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": BASE_LUT[ref_char],
        "alt_code": BASE_LUT[alt_char],
        "phase1": phase1,
        "phase2": phase2,
        "phased": phased,
        "missing": missing,
        "snp_mask": snp_mask,
        "valid": valid,
    }


def pad_v2_sides(
    frame, bucket: int = 8
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A FrameV2's side arrays padded to power-of-two buckets with inert
    entries (``exc_idx = N`` scatters nothing, ``run_counts = 0`` runs are
    zero-width): ``(exc_idx, exc_pos, run_counts, run_ids)``."""
    n = frame.n

    def bucketed(size: int) -> int:
        b = bucket
        while b < size:
            b *= 2
        return b

    eb = bucketed(max(1, frame.exc_idx.shape[0]))
    rb = bucketed(max(1, frame.run_counts.shape[0]))
    exc_idx = np.full(eb, n, dtype=np.int64)
    exc_idx[: frame.exc_idx.shape[0]] = frame.exc_idx
    exc_pos = np.zeros(eb, dtype=np.uint32)
    exc_pos[: frame.exc_pos.shape[0]] = frame.exc_pos
    run_counts = np.zeros(rb, dtype=np.int64)
    run_counts[: frame.run_counts.shape[0]] = frame.run_counts
    run_ids = np.zeros(rb, dtype=np.uint8)
    run_ids[: frame.run_ids.shape[0]] = frame.run_ids
    return exc_idx, exc_pos, run_counts, run_ids


def decode_frames_v2_numpy(
    fixed: np.ndarray,
    gt: np.ndarray,
    exc_idx: np.ndarray,
    exc_pos: np.ndarray,
    run_counts: np.ndarray,
    run_ids: np.ndarray,
) -> dict[str, np.ndarray]:
    """Pure-numpy twin of :func:`decode_frames_v2` (the host decode path)."""
    fixed = np.ascontiguousarray(fixed, dtype=np.uint8)
    n = fixed.shape[0]
    flags = fixed[:, V2_FLAGS_OFF]
    escape = (flags & V2F_POS_ESCAPE) != 0

    delta = fixed[:, 0].astype(np.uint32) | (fixed[:, 1].astype(np.uint32) << 8)
    d = np.where(escape, np.uint32(0), delta)
    base = np.cumsum(d, dtype=np.uint32)
    real = exc_idx < n
    ei = exc_idx[real].astype(np.int64)
    s_tgt = exc_pos[real].astype(np.uint32) - base[np.clip(ei, 0, max(n - 1, 0))]
    c = s_tgt - np.concatenate([np.zeros(1, np.uint32), s_tgt[:-1]])
    corr = np.zeros(n, np.uint32)
    np.add.at(corr, ei, c)
    pos = base + np.cumsum(corr, dtype=np.uint32)
    start = pos - 1
    ref1 = (flags & V2F_REF1) != 0
    stop = np.where(ref1, start + 1, np.uint32(V2_STOP_SENTINEL))

    ref_char = fixed[:, V2_REF_OFF]
    alt_char = fixed[:, V2_ALT_OFF]
    is_acgt = np.isin(alt_char, np.frombuffer(b"ACGT", dtype=np.uint8))
    alt1 = (flags & V2F_ALT1) != 0
    snp_mask = ref1 & alt1 & is_acgt
    well_formed = (flags & V2F_WELL_FORMED) != 0

    cum = np.cumsum(run_counts.astype(np.int64))
    rid = np.searchsorted(cum, np.arange(n, dtype=np.int64), side="right")
    chrom_id = run_ids[np.clip(rid, 0, max(run_ids.shape[0] - 1, 0))]

    gt = np.ascontiguousarray(gt, dtype=np.uint8)
    a0 = gt & 3
    a2 = (gt >> 2) & 3
    sep = (gt >> V2G_SEP_SHIFT) & 3
    has_gt = (gt & V2G_HAS_GT) != 0
    sep_ok = (sep == V2G_SEP_PIPE) | (sep == V2G_SEP_SLASH)
    diploid = has_gt & ((gt & V2G_DIPLOID) != 0) & sep_ok
    missing = diploid & ((a0 == V2_GT_CLASS_MISSING) | (a2 == V2_GT_CLASS_MISSING))
    phase1 = np.where(missing, 1, a0 != 0).astype(np.int8)
    phase2 = np.where(missing, 0, a2 != 0).astype(np.int8)
    phased = diploid & (sep == V2G_SEP_PIPE)
    valid = well_formed[:, None] & diploid

    return {
        "start": start,
        "stop": stop,
        "ref_char": ref_char,
        "alt_char": alt_char,
        "ref_code": BASE_LUT[ref_char],
        "alt_code": BASE_LUT[alt_char],
        "ref1": ref1,
        "alt1": alt1,
        "snp_mask": snp_mask,
        "well_formed": well_formed,
        "chrom_id": chrom_id,
        "phase1": phase1,
        "phase2": phase2,
        "phased": phased,
        "missing": missing,
        "valid": valid,
    }
