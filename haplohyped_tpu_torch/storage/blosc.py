"""Blosc HDF5 filter (id 32001): built and registered at first need, and
the cohort writer's compression settings.

The filter is the repository's own C source, ``cpp/blosc_h5_filter.c``,
linked against the system c-blosc (``libblosc.so.1``).  This package compiles
it into its own git-ignored build directory the first time a dataset needs
it, then registers it with the libhdf5 that h5py loaded (``H5Zregister``).
Gzip and uncompressed datasets never need it.  A dataset that does need it,
on a machine where the plugin cannot be built or registered, raises an error
that says so.  h5py is imported only where a file is read or written, so
the package imports on a machine without it.

Cohort tables and reference sequences are written with Blosc where h5py and
the system libblosc are present, and with gzip where they are not, as the JAX
package chooses (:func:`cohort_compression_kwargs`,
:func:`reference_compression_kwargs`).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import importlib.util
import os
import threading

from haplohyped_tpu_torch.core.constants import (
    BLOSC_FILTER_ID,
    COHORT_COMPRESSION_OPTS,
    REFERENCE_COMPRESSION_OPTS,
)
from haplohyped_tpu_torch.ops._build import PACKAGE_DIR, build_shared_library

#: the plugin's C source, in the repository's ``cpp/`` directory
PLUGIN_SOURCE = PACKAGE_DIR.parent / "cpp" / "blosc_h5_filter.c"

_lock = threading.Lock()
_plugin_handle = None  # keeps the dlopen handle alive


def _find_libhdf5() -> str:
    """The libhdf5 shared object h5py bundles (or a system one)."""
    import h5py

    h5py_dir = os.path.dirname(h5py.__file__)
    for pattern in (
        os.path.join(os.path.dirname(h5py_dir), "h5py.libs", "libhdf5-*.so*"),
        os.path.join(h5py_dir, ".libs", "libhdf5-*.so*"),
    ):
        hits = [h for h in sorted(glob.glob(pattern)) if "hl" not in os.path.basename(h)]
        if hits:
            return hits[0]
    for cand in ("libhdf5.so", "libhdf5.so.310", "libhdf5.so.200"):
        try:
            ctypes.CDLL(cand)
            return cand
        except OSError:
            continue
    raise RuntimeError("could not locate the libhdf5 that h5py uses")


def register_blosc_filter() -> None:
    """Make filter 32001 available to h5py in this process.

    Idempotent and thread-safe.  Raises ``RuntimeError`` if the plugin cannot
    be built or registered."""
    global _plugin_handle
    import h5py

    with _lock:
        if h5py.h5z.filter_avail(BLOSC_FILTER_ID):
            return
        if not PLUGIN_SOURCE.exists():
            raise RuntimeError(
                f"Blosc filter {BLOSC_FILTER_ID} needed but its source "
                f"{PLUGIN_SOURCE} is missing"
            )
        try:
            path = build_shared_library(
                "hh_blosc_h5", [PLUGIN_SOURCE], "cc",
                ("-O3", "-fPIC", "-shared"), ("-l:libblosc.so.1",),
            )
        except (OSError, RuntimeError) as exc:
            raise RuntimeError(
                f"Blosc filter {BLOSC_FILTER_ID} needed but its plugin could "
                f"not be built from {PLUGIN_SOURCE} (needs a C compiler and "
                f"libblosc.so.1): {exc}"
            ) from exc
        # promote libhdf5's symbols to the global namespace so the plugin's
        # undefined H5P*/H5T* references resolve when it is loaded
        libhdf5 = ctypes.CDLL(_find_libhdf5(), mode=ctypes.RTLD_GLOBAL)
        _plugin_handle = ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
        _plugin_handle.H5PLget_plugin_info.restype = ctypes.c_void_p
        libhdf5.H5Zregister.argtypes = [ctypes.c_void_p]
        libhdf5.H5Zregister.restype = ctypes.c_int
        if libhdf5.H5Zregister(_plugin_handle.H5PLget_plugin_info()) < 0:
            raise RuntimeError(f"H5Zregister of Blosc filter {BLOSC_FILTER_ID} failed")
        if not h5py.h5z.filter_avail(BLOSC_FILTER_ID):
            raise RuntimeError(f"Blosc filter {BLOSC_FILTER_ID} not available after registration")


def needs_blosc(dataset) -> bool:
    """Whether reading ``dataset`` goes through filter 32001."""
    plist = dataset.id.get_create_plist()
    return any(
        plist.get_filter(i)[0] == BLOSC_FILTER_ID for i in range(plist.get_nfilters())
    )


def read_dataset(dataset, selection=()):
    """Read ``dataset[selection]``, registering the Blosc filter first when
    the dataset needs it."""
    if needs_blosc(dataset):
        register_blosc_filter()
    return dataset[selection]


@functools.cache
def _libblosc_present() -> bool:
    try:
        ctypes.CDLL("libblosc.so.1")
    except OSError:
        return False
    return True


def blosc_available() -> bool:
    """Whether cohort tables are written with Blosc: h5py is importable and
    the system libblosc loads.  Then the filter is built and registered (a
    failed build raises)."""
    if importlib.util.find_spec("h5py") is None or not _libblosc_present():
        return False
    register_blosc_filter()
    return True


def set_blosc_nthreads(n: int) -> None:
    """Set blosc-internal compression threads (the ``--cxx_threads`` knob)
    of this package's plugin; does nothing where Blosc is unavailable or the
    filter was registered by another plugin."""
    if blosc_available() and _plugin_handle is not None:
        _plugin_handle.hh_blosc_set_nthreads(ctypes.c_int(int(n)))


#: Rows per chunk of cohort SNP tables (the JAX package's choice: ~143 KB
#: chunks, measured there as the best for random-access reads).
COHORT_CHUNK_ROWS = 4096


def cohort_compression_kwargs(n_records: int | None = None) -> dict:
    """``h5py.create_dataset`` kwargs for cohort SNP tables.

    Blosc 32001 with the cohort cd_values where :func:`blosc_available`,
    gzip level 4 otherwise.  With ``n_records``, chunks of
    ``min(COHORT_CHUNK_ROWS, n_records)`` rows; without it, h5py chooses."""
    if n_records is None or n_records <= 0:
        chunks: bool | tuple = True
    else:
        chunks = (min(COHORT_CHUNK_ROWS, n_records),)
    if blosc_available():
        return {
            "compression": BLOSC_FILTER_ID,
            "compression_opts": COHORT_COMPRESSION_OPTS,
            "chunks": chunks,
        }
    return {"compression": "gzip", "compression_opts": 4, "chunks": chunks}


def reference_compression_kwargs(chunks: bool | tuple = True) -> dict:
    """``h5py.create_dataset`` kwargs for reference one-hot sequences and
    codes: Blosc 32001 with the reference cd_values where
    :func:`blosc_available`, gzip level 4 otherwise."""
    if blosc_available():
        return {
            "compression": BLOSC_FILTER_ID,
            "compression_opts": REFERENCE_COMPRESSION_OPTS,
            "chunks": chunks,
        }
    return {"compression": "gzip", "compression_opts": 4, "chunks": chunks}
