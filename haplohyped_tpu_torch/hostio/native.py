"""ctypes bindings of the native VCF framer (``cpp/hostio.cpp``).

The port binds the four functions its converter calls -- ``hh_free``,
``hh_vcf_samples``, ``hh_vcf_frame`` and ``hh_vcf_frame12`` -- of a library
that :func:`haplohyped_tpu_torch.ops._build.load_hostio` compiles from the
repository's ``cpp/`` into the port's own build directory at first use.  A
failed build raises; there is no silent drop to the Python framer.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from haplohyped_tpu_torch.hostio.frame_format import REC12_SIZE, REC_SIZE
from haplohyped_tpu_torch.ops import _build

_ERR_CAP = 512


@functools.cache
def _load() -> ctypes.CDLL:
    lib = _build.load_hostio()
    s, i, p = ctypes.c_char_p, ctypes.c_int, ctypes.POINTER
    out, i64 = p(ctypes.c_void_p), p(ctypes.c_int64)
    lib.hh_free.argtypes = [ctypes.c_void_p]
    lib.hh_free.restype = None
    lib.hh_vcf_samples.argtypes = [s, i, out, i64, s, i]
    lib.hh_vcf_frame.argtypes = [s, s, s, i, out, i64, i64, s, i]
    lib.hh_vcf_frame12.argtypes = [s, s, s, i, out, i64, i64, out, s, i]
    for fn in (lib.hh_vcf_samples, lib.hh_vcf_frame, lib.hh_vcf_frame12):
        fn.restype = ctypes.c_int
    return lib


def _arg(text: str | None) -> bytes | None:
    return text.encode() if text else None


def _take(lib, ptr: ctypes.c_void_p, n: int, width: int) -> np.ndarray:
    """Copy ``n`` records of ``width`` bytes out of a native buffer, then free it."""
    try:
        buf = ctypes.string_at(ptr, n * width) if n else b""
    finally:
        lib.hh_free(ptr)
    return np.frombuffer(buf, dtype=np.uint8).reshape(-1, width).copy()


def _take_lines(lib, ptr: ctypes.c_void_p) -> list[str]:
    try:
        raw = ctypes.string_at(ptr) if ptr.value else b""
    finally:
        lib.hh_free(ptr)
    return raw.decode().split("\n") if raw else []


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
    rc = lib.hh_vcf_frame12(path.encode(), _arg(sample), _arg(region), threads,
                            ctypes.byref(out), ctypes.byref(n), ctypes.byref(seen),
                            ctypes.byref(chroms), err, _ERR_CAP)
    if rc == 3:
        raise ValueError(err.value.decode())
    if rc != 0:
        raise RuntimeError(err.value.decode() or f"hh_vcf_frame12 failed ({rc})")
    records = _take(lib, out, int(n.value), REC12_SIZE)
    return records, _take_lines(lib, chroms), int(seen.value)
