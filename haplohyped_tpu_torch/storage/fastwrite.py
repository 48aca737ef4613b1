"""Parallel Blosc chunk writer: compress OUTSIDE the HDF5 global lock.

The port's copy of ``haplohyped_tpu.storage.fastwrite``; libblosc and h5py
are found at the first write, so the package imports without them.

HDF5's C library serializes every call (including the filter pipeline that
runs Blosc), so threaded writers — the converter's donor fan-out, the FASTA
encoder's per-chromosome pool (reference ``fasta_encoder.py:98-109``) — all
queue behind ONE LZ4HC stream.  This module compresses each chunk with
``blosc_compress_ctx`` in a thread pool (ctypes releases the GIL, so the
pool scales across cores) and stores the results with
``H5Dwrite_direct_chunk``, leaving only raw chunk IO under the HDF5 lock.

Parity: identical decompressed values, dtype, cd_values metadata, and chunk
layout as the filter-pipeline path (pinned by tests/test_fastwrite.py).
Compressed BYTES are additionally deterministic (per-chunk
``numinternalthreads=1``; blosc's auto blocksize — and therefore its output
stream — varies with its internal thread count, so the in-filter path's
bytes change with the ``set_blosc_nthreads`` knob while this path's never
do).

Used when the first-party Blosc filter (32001) is registered; callers fall
back to a plain ``create_dataset(data=...)`` otherwise.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from haplohyped_tpu_torch.core.constants import BLOSC_FILTER_ID
from haplohyped_tpu_torch.storage.blosc import blosc_available

_BLOSC_MAX_OVERHEAD = 16
_BLOSC_MAX_TYPESIZE = 255

_COMPNAME = {0: b"blosclz", 1: b"lz4", 2: b"lz4hc", 3: b"snappy", 4: b"zlib", 5: b"zstd"}

_lib = None
_lib_lock = threading.Lock()


def _h5_phil():
    """h5py's global API lock.  ``write_direct_chunk`` does not reliably
    hold it against concurrent h5py calls in sibling threads (observed:
    H5C "ring type mismatch" metadata-cache corruption when per-donor /
    per-chromosome writer threads interleave direct-chunk IO with
    ``create_dataset`` — even on DIFFERENT files, because the HDF5 C
    library's internal state is process-global).  Taking phil ourselves
    serializes the microseconds of chunk IO against every other h5py
    call; compression — the expensive part — stays parallel."""
    from h5py._objects import phil

    return phil


def _blosc_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(
                ctypes.util.find_library("blosc") or "libblosc.so.1"
            )
            lib.blosc_compress_ctx.restype = ctypes.c_int
            lib.blosc_compress_ctx.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ]
            _lib = lib
    return _lib


def fastwrite_available() -> bool:
    if not blosc_available():
        return False
    try:
        _blosc_lib()
        return True
    except OSError:
        return False


def _compress_chunk(buf: bytes, typesize: int, clevel: int, shuffle: int,
                    compcode: int) -> bytes:
    lib = _blosc_lib()
    n = len(buf)
    out = ctypes.create_string_buffer(n + _BLOSC_MAX_OVERHEAD)
    r = lib.blosc_compress_ctx(
        clevel, shuffle, typesize, n, buf, out, n + _BLOSC_MAX_OVERHEAD,
        _COMPNAME.get(compcode, b"blosclz"),
        0,  # auto blocksize (with 1 thread: deterministic)
        1,  # single internal thread; parallelism is ACROSS chunks
    )
    if r <= 0:
        raise RuntimeError(f"blosc_compress_ctx failed ({r})")
    return out.raw[:r]


def write_dataset_direct(
    group,
    name: str,
    data: np.ndarray,
    compression_kwargs: dict,
    workers: int = 4,
):
    """``group.create_dataset(name, data=data, **compression_kwargs)`` with
    chunk compression parallelized outside the HDF5 lock.

    ``compression_kwargs`` must carry the Blosc filter
    (``compression=32001``) and an explicit or auto chunk shape; any other
    filter falls back to the plain h5py write.  Only the FIRST axis may be
    chunked finer than the data shape (the converter/encoder layouts);
    anything else falls back too.  Returns the created dataset.
    """
    kw = dict(compression_kwargs)
    if (
        kw.get("compression") != BLOSC_FILTER_ID
        or not fastwrite_available()
        or data.dtype.hasobject
    ):
        return group.create_dataset(name, data=data, **kw)

    dset = group.create_dataset(name, shape=data.shape, dtype=data.dtype, **kw)
    chunks = dset.chunks
    if chunks is None or tuple(chunks[1:]) != tuple(data.shape[1:]):
        # unchunked or multi-axis chunking: not our layout; rewrite plainly
        del group[name]
        return group.create_dataset(name, data=data, **kw)

    cd = dset.compression_opts or kw.get("compression_opts") or ()
    clevel = int(cd[4]) if len(cd) > 4 else 5
    shuffle = int(cd[5]) if len(cd) > 5 else 1
    compcode = int(cd[6]) if len(cd) > 6 else 0
    typesize = data.dtype.itemsize
    if typesize > _BLOSC_MAX_TYPESIZE:
        typesize = 1
    rows = chunks[0]
    n = data.shape[0]
    row_bytes = int(np.prod(data.shape[1:], dtype=np.int64)) * data.dtype.itemsize
    data = np.ascontiguousarray(data)

    def prep(i: int) -> tuple[int, bytes]:
        lo = i * rows
        hi = min(lo + rows, n)
        part = data[lo:hi]
        if hi - lo < rows:
            # HDF5 stores edge chunks full-size, zero-filled past the edge
            pad = np.zeros((rows - (hi - lo),) + data.shape[1:], data.dtype)
            part = np.concatenate([part, pad])
        return i, _compress_chunk(
            part.tobytes(), typesize, clevel, shuffle, compcode
        )

    n_chunks = -(-n // rows) if n else 0
    offsets_tail = (0,) * (data.ndim - 1)
    phil = _h5_phil()
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        for i, payload in ex.map(prep, range(n_chunks)):
            with phil:
                dset.id.write_direct_chunk((i * rows,) + offsets_tail, payload)
    return dset
