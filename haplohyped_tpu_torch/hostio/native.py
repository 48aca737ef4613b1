"""ctypes bindings of the native VCF/BCF reader (``cpp/hostio.cpp``,
``cpp/bcf.cpp``).

The port binds the functions its converter, tokenizer, variant table and
FASTA readers call: the VCF framers (``hh_vcf_samples``, ``hh_vcf_frame``,
``hh_vcf_frame12``, ``hh_vcf_frame_v2``), the decompressed text with its
line index (``hh_vcf_text``) and tab/POS index (``hh_vcf_index``), the BGZF
block reader behind the tabix index builder and the streaming tokenizer
(``hh_bgzf_*``), the BCF parser (``hh_bcf_samples``, ``hh_bcf_parse``,
``hh_bcf_parse_v2``) and the whole-file FASTA reader (``hh_fasta_*``), of a
library that
:func:`haplohyped_tpu_torch.ops._build.load_hostio` compiles from the
repository's ``cpp/`` into the port's own build directory at first use.  A
failed build raises; there is no silent drop to the Python framer.  Every
buffer the library returns is freed with ``hh_free``, whatever happens.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from haplohyped_tpu_torch.hostio.frame_format import (
    REC12_SIZE,
    REC_SIZE,
    V2_FIXED_SIZE,
    FrameV2,
)
from haplohyped_tpu_torch.ops import _build

_ERR_CAP = 512

#: File decompressions made by framing calls (``vcf_frame``, ``vcf_frame12``,
#: ``vcf_frame_v2``): the tests read it to hold the single-pass converter to
#: one framing of a chromosome's file for every donor.  An indexed range
#: framing counts as one; its block subset is ``FrameV2.blocks_decoded``.
DECOMPRESS_COUNT = 0
_count_lock = threading.Lock()


def _count_decompress() -> None:
    global DECOMPRESS_COUNT
    with _count_lock:
        DECOMPRESS_COUNT += 1


@functools.cache
def _load() -> ctypes.CDLL:
    lib = _build.load_hostio()
    s, i, p = ctypes.c_char_p, ctypes.c_int, ctypes.POINTER
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    out, pi64 = p(vp), p(i64)
    lib.hh_free.argtypes = [vp]
    lib.hh_free.restype = None
    lib.hh_vcf_samples.argtypes = [s, i, out, pi64, s, i]
    lib.hh_vcf_frame.argtypes = [s, s, s, i, out, pi64, pi64, s, i]
    lib.hh_vcf_frame12.argtypes = [s, s, s, i, out, pi64, pi64, out, s, i]
    # path, samples, region, threads, c_lo, u_skip, c_hi, fixed, gt, n, s,
    # exc_idx, exc_pos, n_exc, run_counts, run_ids, n_runs, chroms, samples,
    # total_seen, blocks_decoded, err
    lib.hh_vcf_frame_v2.argtypes = (
        [s, s, s, i, i64, i64, i64, out, out, pi64, p(ctypes.c_int32), out, out, pi64,
         out, out, pi64, out, out, pi64, pi64, s, i])
    # path, threads, text, text_len, line_off, line_len, n_lines, samples, err
    lib.hh_vcf_text.argtypes = [s, i, out, pi64, out, out, pi64, out, s, i]
    # ... n_lines, bounds, pos, samples, err
    lib.hh_vcf_index.argtypes = [s, i, out, pi64, out, out, pi64, out, out, out, s, i]
    lib.hh_bgzf_open.argtypes = [s, pi64, pi64, s, i]
    lib.hh_bgzf_open.restype = vp
    lib.hh_bgzf_close.argtypes = [vp]
    lib.hh_bgzf_close.restype = None
    for fn in (lib.hh_bgzf_uoffset, lib.hh_bgzf_coffset, lib.hh_bgzf_block_at):
        fn.argtypes = [vp, i64]
        fn.restype = i64
    lib.hh_bgzf_decode_range.argtypes = [vp, i64, i64, i, vp, out, pi64, s, i]
    lib.hh_bcf_samples.argtypes = [s, i, out, pi64, s, i]
    lib.hh_bcf_parse.argtypes = [s, s, i] + [out] * 10 + [pi64, out, s, i]
    lib.hh_bcf_parse_v2.argtypes = [s, p(ctypes.c_int32), ctypes.c_int32, i] + [out] * 11 + [
        pi64, out, s, i]
    lib.hh_fasta_open.argtypes = [s, s, i]
    lib.hh_fasta_open.restype = vp
    lib.hh_fasta_close.argtypes = [vp]
    lib.hh_fasta_close.restype = None
    lib.hh_fasta_nseq.argtypes = [vp]
    lib.hh_fasta_nseq.restype = i
    lib.hh_fasta_name.argtypes = [vp, i, s, i]
    lib.hh_fasta_name.restype = i
    lib.hh_fasta_length.argtypes = [vp, s]
    lib.hh_fasta_length.restype = i64
    lib.hh_fasta_fetch.argtypes = [vp, s, i64, i64, vp]
    lib.hh_fasta_fetch.restype = i64
    for fn in (lib.hh_vcf_samples, lib.hh_vcf_frame, lib.hh_vcf_frame12, lib.hh_vcf_frame_v2,
               lib.hh_vcf_text, lib.hh_vcf_index, lib.hh_bgzf_decode_range, lib.hh_bcf_samples, lib.hh_bcf_parse,
               lib.hh_bcf_parse_v2):
        fn.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here.  A route that needs
    it calls it and raises where it cannot: nothing skips on this answer."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _arg(text: str | None) -> bytes | None:
    return text.encode() if text else None


def _free_all(lib, ptrs) -> None:
    for ptr in ptrs:
        lib.hh_free(ptr)


def _array(ptr: ctypes.c_void_p, dtype, count: int) -> np.ndarray:
    """Copy ``count`` items of ``dtype`` out of a native buffer (not freed here)."""
    if count == 0:
        return np.zeros(0, dtype)
    nbytes = count * np.dtype(dtype).itemsize
    view = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_ubyte)),
                                 shape=(nbytes,))
    return view.view(dtype).copy()


def _lines(ptr: ctypes.c_void_p) -> list[str]:
    """A native newline-joined string as a list (not freed here)."""
    raw = ctypes.string_at(ptr) if ptr.value else b""
    return raw.decode().split("\n") if raw else []


def _take(lib, ptr: ctypes.c_void_p, n: int, width: int) -> np.ndarray:
    """Copy ``n`` records of ``width`` bytes out of a native buffer, then free it."""
    try:
        return _array(ptr, np.uint8, n * width).reshape(-1, width)
    finally:
        lib.hh_free(ptr)


def _take_lines(lib, ptr: ctypes.c_void_p) -> list[str]:
    try:
        return _lines(ptr)
    finally:
        lib.hh_free(ptr)


def vcf_samples(path: str, threads: int = 1) -> list[str]:
    """Sample names of the ``#CHROM`` header line."""
    lib = _load()
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = lib.hh_vcf_samples(path.encode(), threads, ctypes.byref(out), ctypes.byref(n),
                            err, _ERR_CAP)
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_vcf_samples failed ({rc})")
    return _take_lines(lib, out)


def vcf_frame(
    path: str, sample: str | None, region: str | None, threads: int = 1
) -> tuple[np.ndarray, int]:
    """Frame a VCF natively; returns ((n, 64) uint8, total_lines_seen)."""
    lib = _load()
    out, n, seen = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    _count_decompress()
    rc = lib.hh_vcf_frame(path.encode(), _arg(sample), _arg(region), threads,
                          ctypes.byref(out), ctypes.byref(n), ctypes.byref(seen),
                          err, _ERR_CAP)
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_vcf_frame failed ({rc})")
    return _take(lib, out, int(n.value), REC_SIZE), int(seen.value)


def vcf_frame12(
    path: str, sample: str | None, region: str | None, threads: int = 1
) -> tuple[np.ndarray, list[str], int]:
    """Frame a VCF natively into compact 12-byte records.

    Returns ((n, 12) uint8, chrom_table, total_lines_seen).  Raises
    ``ValueError`` if the records that ``region`` keeps hold > 255 distinct
    chroms (the framer's rc 3; callers then take :func:`vcf_frame`, whose
    64-byte layout stores chroms inline)."""
    lib = _load()
    out, n, seen = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    chroms = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_CAP)
    _count_decompress()
    rc = lib.hh_vcf_frame12(path.encode(), _arg(sample), _arg(region), threads,
                            ctypes.byref(out), ctypes.byref(n), ctypes.byref(seen),
                            ctypes.byref(chroms), err, _ERR_CAP)
    if rc == 3:
        raise ValueError(err.value.decode())
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_vcf_frame12 failed ({rc})")
    records = _take(lib, out, int(n.value), REC12_SIZE)
    return records, _take_lines(lib, chroms), int(seen.value)


def vcf_frame_v2(
    path: str,
    samples: list[str] | str | None,
    region: str | None,
    threads: int = 1,
    c_lo: int = -1,
    u_skip: int = 0,
    c_hi: int = -1,
) -> FrameV2:
    """Frame a VCF natively into the v2 layout: one pass, every sample asked for.

    ``samples``: None/[] = no genotypes; ``"*"`` = every header sample; a list
    or a single name = those samples in slot order.  ``c_lo >= 0`` selects
    indexed range mode: only the BGZF blocks from compressed offset ``c_lo``
    (records from in-block offset ``u_skip``) to ``c_hi`` are inflated, plus
    the header's.  Raises ``ValueError`` where the records kept hold > 255
    distinct chroms (rc 3), ``RuntimeError`` on any other failure."""
    lib = _load()
    if samples is None or isinstance(samples, str):
        samples_arg = _arg(samples)
    else:
        samples_arg = "\n".join(samples).encode() if samples else None
    fixed, gt, exc_idx, exc_pos = (ctypes.c_void_p() for _ in range(4))
    run_counts, run_ids, chroms, names = (ctypes.c_void_p() for _ in range(4))
    n, n_exc, n_runs, seen, nblk = (ctypes.c_int64() for _ in range(5))
    s = ctypes.c_int32()
    err = ctypes.create_string_buffer(_ERR_CAP)
    _count_decompress()
    rc = lib.hh_vcf_frame_v2(
        path.encode(), samples_arg, _arg(region), threads, c_lo, u_skip, c_hi,
        ctypes.byref(fixed), ctypes.byref(gt), ctypes.byref(n), ctypes.byref(s),
        ctypes.byref(exc_idx), ctypes.byref(exc_pos), ctypes.byref(n_exc),
        ctypes.byref(run_counts), ctypes.byref(run_ids), ctypes.byref(n_runs),
        ctypes.byref(chroms), ctypes.byref(names), ctypes.byref(seen), ctypes.byref(nblk),
        err, _ERR_CAP)
    if rc == 3:
        raise ValueError(err.value.decode())
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_vcf_frame_v2 failed ({rc})")
    try:
        nn, ss, ne, nr = int(n.value), int(s.value), int(n_exc.value), int(n_runs.value)
        return FrameV2(
            fixed=_array(fixed, np.uint8, nn * V2_FIXED_SIZE).reshape(nn, V2_FIXED_SIZE),
            gt=_array(gt, np.uint8, nn * ss).reshape(nn, ss),
            exc_idx=_array(exc_idx, np.int64, ne),
            exc_pos=_array(exc_pos, np.uint32, ne),
            run_counts=_array(run_counts, np.int64, nr),
            run_ids=_array(run_ids, np.uint8, nr),
            chroms=_lines(chroms),
            samples=_lines(names),
            total_seen=int(seen.value),
            blocks_decoded=int(nblk.value),
        )
    finally:
        _free_all(lib, (fixed, gt, exc_idx, exc_pos, run_counts, run_ids, chroms, names))


def _view(ptr: ctypes.c_void_p, ctype, shape: tuple[int, ...]) -> np.ndarray:
    """A numpy view of a native buffer (no copy; the buffer must outlive it)."""
    if 0 in shape:
        return np.zeros(shape, np.dtype(ctype))
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=shape)


class VCFText:
    """A VCF's decompressed text and the offsets and lengths of its data
    lines (no newline, no carriage return), as numpy views over native buffers.

    Keep the object alive while the arrays are used; ``close()`` (or garbage
    collection) frees the native memory and drops the views."""

    def __init__(self, text, line_offsets, line_lengths, samples, _frees):
        self.text: np.ndarray = text  # (T,) uint8
        self.line_offsets: np.ndarray = line_offsets  # (N,) int64
        self.line_lengths: np.ndarray = line_lengths  # (N,) int32
        self.samples: list[str] = samples
        self._lib, self._frees = _load(), _frees

    @property
    def n_lines(self) -> int:
        return int(self.line_offsets.shape[0])

    def close(self) -> None:
        frees, self._frees = self._frees, []
        self.text = self.line_offsets = self.line_lengths = None
        for ptr in frees:
            self._lib.hh_free(ptr)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


class VCFIndex(VCFText):
    """:class:`VCFText` plus each line's first 9 tab positions ``bounds``
    (n, 9) int32, relative to the line's start and clipped to its length
    where it has fewer, and its POS ``pos`` (n,) int64 (0 where malformed or
    longer than 12 digits): the index behind ``hostio.variants.VariantTable``."""

    def __init__(self, text, line_offsets, line_lengths, samples, bounds, pos, _frees):
        super().__init__(text, line_offsets, line_lengths, samples, _frees)
        self.bounds: np.ndarray = bounds  # (n, 9) int32
        self.pos: np.ndarray = pos  # (n,) int64

    def close(self) -> None:
        super().close()
        self.bounds = self.pos = None


def _text_call(fn, path: str, threads: int, extra: int):
    """Call ``hh_vcf_text`` (``extra`` 0) or ``hh_vcf_index`` (``extra`` 2,
    the bounds and POS buffers).  Returns the sizes and every buffer, the
    samples string last; raises (nothing allocated) where the call fails."""
    text, offs, lens, samples = (ctypes.c_void_p() for _ in range(4))
    more = [ctypes.c_void_p() for _ in range(extra)]
    text_len, n_lines = ctypes.c_int64(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = fn(path.encode(), threads, ctypes.byref(text), ctypes.byref(text_len),
            ctypes.byref(offs), ctypes.byref(lens), ctypes.byref(n_lines),
            *(ctypes.byref(p) for p in more), ctypes.byref(samples), err, _ERR_CAP)
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"{fn.__name__} failed ({rc})")
    return int(text_len.value), int(n_lines.value), [text, offs, lens, *more, samples]


def vcf_text(path: str, threads: int = 1) -> VCFText:
    """Decompress a VCF and index its data lines natively (no per-field host
    work): the host half of the tokenizer route."""
    lib = _load()
    t, n, ptrs = _text_call(lib.hh_vcf_text, path, threads, 0)
    try:
        samples = _lines(ptrs[-1])
        return VCFText(_view(ptrs[0], ctypes.c_uint8, (t,)),
                       _view(ptrs[1], ctypes.c_int64, (n,)),
                       _view(ptrs[2], ctypes.c_int32, (n,)),
                       samples, _frees=ptrs[:3])
    except BaseException:
        _free_all(lib, ptrs[:3])
        raise
    finally:
        lib.hh_free(ptrs[-1])


def vcf_index(path: str, threads: int = 1) -> VCFIndex:
    """Decompress a VCF and index its lines, tabs and POS in one threaded
    native pass."""
    lib = _load()
    t, n, ptrs = _text_call(lib.hh_vcf_index, path, threads, 2)
    try:
        samples = _lines(ptrs[-1])
        return VCFIndex(_view(ptrs[0], ctypes.c_uint8, (t,)),
                        _view(ptrs[1], ctypes.c_int64, (n,)),
                        _view(ptrs[2], ctypes.c_int32, (n,)),
                        samples,
                        _view(ptrs[3], ctypes.c_int32, (n, 9)),
                        _view(ptrs[4], ctypes.c_int64, (n,)),
                        _frees=ptrs[:5])
    except BaseException:
        _free_all(lib, ptrs[:5])
        raise
    finally:
        lib.hh_free(ptrs[-1])


def bcf_samples(path: str, threads: int = 1) -> list[str]:
    """Sample names of a BCF header."""
    lib = _load()
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = lib.hh_bcf_samples(path.encode(), threads, ctypes.byref(out), ctypes.byref(n),
                            err, _ERR_CAP)
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_bcf_samples failed ({rc})")
    return _take_lines(lib, out)


#: the shared per-record columns of ``hh_bcf_parse``/``hh_bcf_parse_v2``,
#: in argument order, with their dtypes
_BCF_COLUMNS = (("rid", np.int32), ("start", np.int32), ("stop", np.int32),
                ("ref_char", np.uint8), ("alt_char", np.uint8), ("ref_len", np.int32),
                ("alt_len", np.int32))


def bcf_parse(path: str, sample: str | None, threads: int = 1) -> dict:
    """Parse a BCF into decoded per-record columns for one sample (or none)
    and the contig name table (``"contigs"``)."""
    lib = _load()
    ptrs = [ctypes.c_void_p() for _ in range(10)]
    n, contigs = ctypes.c_int64(), ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = lib.hh_bcf_parse(path.encode(), _arg(sample), threads,
                          *(ctypes.byref(p) for p in ptrs), ctypes.byref(n),
                          ctypes.byref(contigs), err, _ERR_CAP)
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_bcf_parse failed ({rc})")
    try:
        nn = int(n.value)
        names = [k for k, _ in _BCF_COLUMNS] + ["phase1", "phase2", "bcf_flags"]
        dtypes = [d for _, d in _BCF_COLUMNS] + [np.int8, np.int8, np.uint8]
        out = {k: _array(p, d, nn) for k, d, p in zip(names, dtypes, ptrs)}
        out["contigs"] = _lines(contigs)
        return out
    finally:
        _free_all(lib, ptrs + [contigs])


def bcf_parse_v2(path: str, want_idx: np.ndarray, threads: int = 1) -> dict:
    """One-pass multi-sample BCF parse: the shared per-record columns, the
    SNP flags, and ``(N, S)`` ``phase1``/``phase2``/``valid`` for the samples
    at header indices ``want_idx`` (slot order), and the contig table."""
    lib = _load()
    want = np.ascontiguousarray(want_idx, dtype=np.int32)
    S = int(want.shape[0])
    ptrs = [ctypes.c_void_p() for _ in range(11)]
    n, contigs = ctypes.c_int64(), ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = lib.hh_bcf_parse_v2(path.encode(), want.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             S, threads, *(ctypes.byref(p) for p in ptrs), ctypes.byref(n),
                             ctypes.byref(contigs), err, _ERR_CAP)
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_bcf_parse_v2 failed ({rc})")
    try:
        nn = int(n.value)
        out = {k: _array(p, d, nn) for (k, d), p in zip(_BCF_COLUMNS, ptrs)}
        out["snp_flags"] = _array(ptrs[7], np.uint8, nn)
        for k, d, p in zip(("phase1", "phase2", "valid"), (np.int8, np.int8, np.uint8),
                           ptrs[8:]):
            out[k] = _array(p, d, nn * S).reshape(nn, S)
        out["contigs"] = _lines(contigs)
        return out
    finally:
        _free_all(lib, ptrs + [contigs])


class BgzfRangeReader:
    """A BGZF file's block table, and block ranges inflated into numpy
    buffers (with the newline offsets of each range)."""

    def __init__(self, path: str):
        self._lib, self._h = _load(), None
        total, nblocks = ctypes.c_int64(), ctypes.c_int64()
        err = ctypes.create_string_buffer(_ERR_CAP)
        self._h = self._lib.hh_bgzf_open(path.encode(), ctypes.byref(total),
                                         ctypes.byref(nblocks), err, _ERR_CAP)
        if not self._h:
            raise RuntimeError(err.value.decode() or "hh_bgzf_open failed")
        self.total_usize = int(total.value)
        self.n_blocks = int(nblocks.value)

    def uoffset(self, i: int) -> int:
        """Uncompressed offset of block ``i`` (the total size past the last)."""
        return int(self._lib.hh_bgzf_uoffset(self._h, i))

    def coffset(self, i: int) -> int:
        """Compressed offset of block ``i``."""
        return int(self._lib.hh_bgzf_coffset(self._h, i))

    def block_at(self, coffset: int) -> int:
        """Index of the block whose compressed offset contains ``coffset``."""
        return int(self._lib.hh_bgzf_block_at(self._h, coffset))

    def decode_range(self, lo: int, hi: int, threads: int, out: np.ndarray,
                     out_off: int = 0) -> np.ndarray:
        """Inflate blocks ``[lo, hi)`` into ``out[out_off:]``; returns the
        newline offsets relative to the range's start (int64)."""
        size = self.uoffset(hi) - self.uoffset(lo)
        if out.shape[0] - out_off < size:
            raise ValueError(f"buffer holds {out.shape[0] - out_off} bytes, the range {size}")
        nl, n_nl = ctypes.c_void_p(), ctypes.c_int64()
        err = ctypes.create_string_buffer(_ERR_CAP)
        dst = out[out_off:].ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.hh_bgzf_decode_range(self._h, lo, hi, threads, dst, ctypes.byref(nl),
                                            ctypes.byref(n_nl), err, _ERR_CAP)
        try:
            if rc != 0:
                raise RuntimeError(err.value.decode() or "hh_bgzf_decode_range failed")
            return _array(nl, np.int64, int(n_nl.value))
        finally:
            self._lib.hh_free(nl)

    def close(self) -> None:
        if self._h:
            self._lib.hh_bgzf_close(self._h)
            self._h = None

    def __enter__(self) -> "BgzfRangeReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


class NativeFasta:
    """A plain or gzipped FASTA read whole by the native library; fetches
    copy ``[start, end)`` of a record, clamped to it, newlines dropped."""

    _NAME_CAP = 1024

    def __init__(self, path: str):
        self._lib, self._h = _load(), None
        err = ctypes.create_string_buffer(_ERR_CAP)
        self._h = self._lib.hh_fasta_open(path.encode(), err, _ERR_CAP)
        if not self._h:
            raise RuntimeError(err.value.decode() or "hh_fasta_open failed")

    def names(self) -> list[str]:
        buf = ctypes.create_string_buffer(self._NAME_CAP)
        out = []
        for k in range(self._lib.hh_fasta_nseq(self._h)):
            if self._lib.hh_fasta_name(self._h, k, buf, self._NAME_CAP) != 0:
                raise RuntimeError(f"hh_fasta_name failed for record {k}")
            out.append(buf.value.decode())
        return out

    def length(self, name: str) -> int:
        n = self._lib.hh_fasta_length(self._h, name.encode())
        if n < 0:
            raise KeyError(name)
        return int(n)

    def fetch(self, name: str, start: int, end: int) -> bytes:
        out = ctypes.create_string_buffer(max(0, end - start))
        written = self._lib.hh_fasta_fetch(self._h, name.encode(), start, end, out)
        if written < 0:
            raise KeyError(name)
        return out.raw[: int(written)]

    def close(self) -> None:
        if self._h:
            self._lib.hh_fasta_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeFasta":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
