"""The raw-text VCF tokenizer, as torch ops on the text's device.

The port of ``haplohyped_tpu.ops.vcf_tokenize``.  The host only decompresses
the VCF and indexes its data lines (``hostio.native.vcf_text``); everything
else (tab scanning, field segmentation, POS parsing, the SNP predicate and
the genotype decode) runs as dense torch ops over a ``(N, 2W)`` byte window
of each line.  The JAX tokenizer is XLA code and reaches no Pallas kernel,
so these ops are the port; their CPU run is what the tests hold against the
JAX package, column by column and bit for bit.

Three things of the JAX version shape its outputs and are kept:

- **The window's origin.**  A line's window is the two aligned W-byte rows
  from ``offset // W``.  The start of an empty field is 0 (JAX's ``argmax``
  of an all-False row), so the byte read there lies before the line, in the
  aligned row; a line longer than W sees ``[offset, r0 * W + 2W)``.
- **The zeros past the text**, with one zero row of slack for the second
  aligned row: a read two bytes past a short last field lands there.
- **uint32 wraparound** of POS (10-digit place values, ``(byte - '0') &
  0xFF`` digits), ``start = pos - 1`` and ``stop = start + ref_len``: int64
  here, then ``& 0xFFFFFFFF``.

Fields are found from the positions of each line's tabs (a search in the
row's running tab count) instead of one ``(N, 2W)`` mask a field; start and
length are those of JAX's masks.
"""

from __future__ import annotations

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.ops.onehot import ascii_to_codes
from haplohyped_tpu_torch.ops.vcf_decode import decode_frames_numpy

TAB = 9
_MASK32 = 0xFFFFFFFF
#: POS digits that carry a place value (JAX's ``_POW10`` is 0 past 10^9)
_POS_DIGITS = 10
_ACGT = tuple(b"ACGT")


def _as_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` as a uint32 tensor (a view of int32)."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32).view(torch.uint32)


def line_windows(
    text: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor, W: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each line's window: the two aligned W-byte rows from ``offset // W``
    (``(N, 2W)`` uint8), and the line's start and end columns in it."""
    n_rows = text.shape[0] // W
    text2d = text[: n_rows * W].view(n_rows, W)
    offsets, lengths = offsets.to(torch.int64), lengths.to(torch.int64)
    r0 = torch.div(offsets, W, rounding_mode="floor").clamp(0, n_rows - 1)
    win = torch.cat([text2d[r0], text2d[(r0 + 1).clamp(max=n_rows - 1)]], dim=1)
    shift = offsets - r0 * W
    return win, shift, shift + lengths


def tab_counts(win: torch.Tensor, shift: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """``(N, 2W)`` int16: the line's tabs at or before each column (at most
    2W < 2^15)."""
    col = torch.arange(win.shape[1], device=win.device)
    is_tab = (win == TAB) & (col >= shift[:, None]) & (col < end[:, None])
    return torch.cumsum(is_tab, dim=1, dtype=torch.int16)


def tabs_needed(sample_col: int) -> list[int]:
    """The tabs whose columns bound the fields the decode reads (CHROM, POS,
    REF, ALT, FORMAT and the sample's; the 7th for the 8-field rule)."""
    gt = {7, 8, 8 + sample_col, 9 + sample_col} if sample_col >= 0 else set()
    return sorted({0, 1, 2, 3, 4, 6} | gt)


def tab_columns(counts: torch.Tensor, tabs: list[int]) -> dict[int, torch.Tensor]:
    """The column of each line's k-th tab (0-based) for each k of ``tabs``,
    2W where the line has no such tab."""
    absent = counts.shape[1]
    want = torch.tensor([min(k + 1, absent + 1) for k in tabs], dtype=torch.int16,
                        device=counts.device)
    found = torch.searchsorted(counts, want.expand(counts.shape[0], -1).contiguous())
    return dict(zip(tabs, found.unbind(1)))


def line_fields(
    win: torch.Tensor,
    shift: torch.Tensor,
    end: torch.Tensor,
    tab: dict[int, torch.Tensor],
    sample_col: int,
) -> dict[str, torch.Tensor]:
    """The 15 columns from each line's window and tab columns
    (``sample_col`` -1: no genotype)."""
    dev, n, W = win.device, win.shape[0], win.shape[1] // 2
    long_line = end - shift > W
    absent = 2 * W
    vend = end.clamp(max=absent)  # the end of the line's visible bytes

    def field(k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(start, length) of field k: the start 0 where the field is empty."""
        lo = shift if k == 0 else torch.where(tab[k - 1] < absent, tab[k - 1] + 1, absent)
        hi = torch.where(tab[k] < absent, tab[k], vend)
        ln = (hi - lo).clamp(min=0)
        return torch.where(ln > 0, lo, 0), ln

    def char_at(pos: torch.Tensor, delta: int = 0) -> torch.Tensor:
        return win.gather(1, (pos + delta).clamp(0, 2 * W - 1)[:, None])[:, 0]

    # JAX's n_fields >= 8: the 7th tab lies before the last visible byte
    well_formed = (tab[6] < vend - 1) & ~long_line

    # CHROM: the first 8 bytes of field 0
    _, len0 = field(0)
    chrom_len = len0.clamp(max=8).to(torch.int32)
    j8 = torch.arange(8, device=dev)
    chrom_raw = win.gather(1, (shift[:, None] + j8).clamp(0, 2 * W - 1))
    chrom = torch.where(j8 < chrom_len[:, None], chrom_raw, 0).to(torch.uint8)

    # POS: the field's last 10 digits carry 10^0 .. 10^9, in uint32
    s1, len1 = field(1)
    j = torch.arange(_POS_DIGITS, device=dev)
    digit_col = ((s1 + len1 - 1)[:, None] - j).clamp(0, 2 * W - 1)
    digit = (win.gather(1, digit_col).to(torch.int64) - ord("0")) & 0xFF
    pos = torch.where(j < len1[:, None], digit * 10**j, 0).sum(1) & _MASK32
    start = (pos - 1) & _MASK32

    # REF / ALT
    s3, ref_len = field(3)
    s4, alt_len = field(4)
    ref_char, alt_char = char_at(s3), char_at(s4)
    stop = (start + ref_len) & _MASK32
    is_acgt = torch.zeros_like(alt_char, dtype=torch.bool)
    for base in _ACGT:
        is_acgt |= alt_char == base
    snp_mask = (ref_len == 1) & (alt_len == 1) & is_acgt

    if sample_col >= 0:
        s8, len8 = field(8)
        gt_first = ((char_at(s8) == ord("G")) & (char_at(s8, 1) == ord("T"))
                    & ((len8 == 2) | (char_at(s8, 2) == ord(":"))))
        gs, glen = field(9 + sample_col)
        g0, g1, g2 = char_at(gs), char_at(gs, 1), char_at(gs, 2)
        sep_ok = (g1 == ord("|")) | (g1 == ord("/"))
        diploid = (glen > 0) & gt_first & sep_ok & (glen >= 3)
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

    return {
        "start": _as_uint32(start),
        "stop": _as_uint32(stop),
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
        "chrom": chrom,
        "chrom_len": chrom_len,
        "long_line": long_line,
    }


def tokenize_lines(
    text: torch.Tensor,
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    *,
    W: int,
    sample_col: int = -1,
    with_sample: bool = True,
) -> dict[str, torch.Tensor]:
    """Tokenize and decode N data lines on ``text.device``.

    ``text`` (T,) uint8 holds the raw VCF text, zero past its data, with
    ``T`` a multiple of ``W`` and at least one row past the last line's;
    ``offsets``/``lengths`` (N,) are the lines' starts and lengths (no
    newline).  ``W`` is a power of two; lines longer than W are flagged in
    ``long_line``.  Returns the JAX package's 15 columns in its dtypes: the
    decode columns of ``decode_frames_numpy`` plus ``chrom`` (N, 8) uint8,
    ``chrom_len`` int32 and ``long_line`` bool.  The four stages are the
    functions above, each a few torch ops."""
    col = sample_col if with_sample else -1
    win, shift, end = line_windows(text, offsets, lengths, W)
    tab = tab_columns(tab_counts(win, shift, end), tabs_needed(col))
    return line_fields(win, shift, end, tab, col)


def choose_window(max_line_len: int, cap: int = 4096) -> int:
    """Smallest power-of-two window of at least 128 covering the longest
    line (at most ``cap``)."""
    w = 128
    while w < max_line_len and w < cap:
        w *= 2
    return w


def default_chunk_lines(W: int) -> int:
    """Lines a call of :func:`tokenize_lines` takes by default: JAX's bound of
    ~20 bytes a window byte under 2 GiB, floored at 2^14 lines."""
    return max(1 << 14, (1 << 31) // (20 * W))


def empty_decoded() -> dict[str, np.ndarray]:
    """The tokenizer's columns for no line."""
    out = decode_frames_numpy(np.zeros((0, 64), np.uint8))
    out["chrom"] = np.zeros((0, 8), np.uint8)
    out["chrom_len"] = np.zeros((0,), np.int32)
    out["long_line"] = np.zeros((0,), bool)
    return out


def upload_text(text: np.ndarray, W: int, device: torch.device) -> torch.Tensor:
    """``text`` on ``device`` in whole rows of W, zero past its end, with one
    zero row of slack for the second aligned row of the last line."""
    T = text.shape[0]
    out = torch.empty((-(-T // W) + 1) * W, dtype=torch.uint8, device=device)
    out[:T].copy_(torch.from_numpy(text))
    out[T:].zero_()
    return out


def decoded_to_host(chunks: list[dict[str, torch.Tensor]]) -> dict[str, np.ndarray]:
    """The columns of every chunk, in order, as host numpy arrays."""
    host = [{k: v.cpu().numpy() for k, v in c.items()} for c in chunks]
    if len(host) == 1:
        return host[0]
    return {k: np.concatenate([c[k] for c in host]) for k in host[0]}


def sample_column(samples: list[str], sample: str | None) -> int:
    """The header index of ``sample`` (-1 for none); raises if it is absent."""
    if not sample:
        return -1
    try:
        return samples.index(sample)
    except ValueError:
        raise RuntimeError(f"sample not found in VCF header: {sample}") from None


def tokenize_vcf_device(
    vcf_text_obj,
    sample: str | None,
    chunk_lines: int | None = None,
    window_cap: int = 4096,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Ship a VCF's text and line index to ``device`` and tokenize it there,
    ``chunk_lines`` lines a call.

    ``vcf_text_obj`` is a :class:`haplohyped_tpu_torch.hostio.native.VCFText`.
    Returns host decode columns (every line, in order).  Lines longer than
    the window cap are flagged in ``long_line`` (callers take the framed
    route for those).  Raises ``ValueError`` where the text's offsets pass
    the int32 range (use :func:`~haplohyped_tpu_torch.ops.vcf_stream.
    tokenize_vcf_streaming`) and ``RuntimeError`` for a sample the header
    lacks."""
    dev = resolve_device(device)
    sample_col = sample_column(vcf_text_obj.samples, sample)
    n = vcf_text_obj.n_lines
    if n == 0:
        return empty_decoded()
    max_len = int(vcf_text_obj.line_lengths.max())
    W = choose_window(max_len, cap=window_cap)
    if int(vcf_text_obj.line_offsets[-1]) + max_len >= 2**31 - 2 * W:
        # the line offsets go to the device as int32; the streaming path's
        # offsets are relative to a chunk and stay small
        raise ValueError(
            "decompressed VCF exceeds the int32 offset range; use "
            "haplohyped_tpu_torch.ops.vcf_stream.tokenize_vcf_streaming"
        )
    chunk_lines = chunk_lines or default_chunk_lines(W)
    text = upload_text(vcf_text_obj.text, W, dev)
    offs = torch.from_numpy(vcf_text_obj.line_offsets.astype(np.int32)).to(dev)
    lens = torch.from_numpy(np.ascontiguousarray(vcf_text_obj.line_lengths)).to(dev)
    chunks = [
        tokenize_lines(text, offs[lo:lo + chunk_lines], lens[lo:lo + chunk_lines], W=W,
                       sample_col=sample_col, with_sample=sample is not None)
        for lo in range(0, n, chunk_lines)
    ]
    return decoded_to_host(chunks)
