"""glibc malloc tuning for hosts where page faults are slow.

Large fresh allocations (frame buffers, decode columns, SNP structs) pay
their first-touch page faults on every task when glibc serves them by
``mmap`` and returns them with ``munmap`` on free, its default above the
mmap threshold.  ``tune_malloc()`` raises ``M_MMAP_THRESHOLD`` and
``M_TRIM_THRESHOLD`` so big buffers come from the main arena and stay there
after free: the first task pays the faults once and later tasks reuse warm
pages.  ``prefault_arena()`` pays them up front in a background thread.
Nothing happens where the C library is not glibc.  The converter calls both
at construction.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import threading

logger = logging.getLogger(__name__)

# glibc mallopt parameter numbers (malloc.h)
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
M_ARENA_MAX = -8

MADV_HUGEPAGE = 14
_HUGE = 2 << 20
#: prefault block size: each stays below the (INT_MAX) mmap threshold, so
#: glibc serves it from the arena, where its pages survive the free
_BLOCK = 1 << 30

_done = False
_prefaulted_bytes = 0
_prefault_lock = threading.Lock()


def _libc() -> ctypes.CDLL:
    return ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)


def tune_malloc(threshold_bytes: int = (1 << 31) - 1) -> bool:
    """Keep freed large buffers in the malloc arena for reuse.

    The default is INT_MAX (``mallopt`` takes an int): with a lower
    threshold, an allocation above it is served by ``mmap`` and unmapped on
    free, which would undo :func:`prefault_arena` for the large cohorts it
    is for.  One shared arena (``M_ARENA_MAX`` 1): worker threads would
    otherwise allocate from fresh per-thread arenas, bypassing the pages the
    main arena prefaulted.  Returns True when applied (glibc found and
    ``mallopt`` succeeded); idempotent."""
    global _done
    if _done:
        return True
    try:
        libc = _libc()
        ok1 = libc.mallopt(M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(M_TRIM_THRESHOLD, threshold_bytes)
        libc.mallopt(M_ARENA_MAX, 1)
    except (OSError, AttributeError) as exc:  # no glibc: nothing to tune
        logger.debug("malloc tuning unavailable: %s", exc)
        return False
    _done = bool(ok1 and ok2)
    return _done


def _touch(n: int) -> None:
    """Allocate ``n`` bytes in arena-sized blocks, advise hugepages, write
    every page, then free them all; a failure gives the bytes back to the
    next call (the prefault is an optimisation, never a requirement)."""
    global _prefaulted_bytes
    ptrs: list[tuple[int, int]] = []
    libc = None
    try:
        libc = _libc()
        libc.malloc.restype = ctypes.c_void_p
        left = n
        while left > 0:
            blk = min(left, _BLOCK)
            ptr = libc.malloc(ctypes.c_size_t(blk))
            if not ptr:
                raise MemoryError(f"malloc of {blk} bytes failed")
            ptrs.append((ptr, blk))
            left -= blk
        for ptr, blk in ptrs:
            a0 = (ptr + _HUGE - 1) & ~(_HUGE - 1)
            end = (ptr + blk) & ~(_HUGE - 1)
            if end > a0:
                libc.madvise(ctypes.c_void_p(a0), ctypes.c_size_t(end - a0), MADV_HUGEPAGE)
            libc.memset(ctypes.c_void_p(ptr), 0, ctypes.c_size_t(blk))
    except (OSError, AttributeError, MemoryError) as exc:
        logger.debug("arena prefault of %d bytes failed: %s", n, exc)
        with _prefault_lock:
            _prefaulted_bytes -= n
    finally:
        for ptr, _ in ptrs:
            libc.free(ctypes.c_void_p(ptr))


def prefault_arena(nbytes: int, background: bool = True) -> threading.Thread | None:
    """Fault ``nbytes`` of arena pages in now (in a background thread by
    default) instead of mid-pipeline when the decode and struct buffers
    first allocate.  The region is ``madvise(MADV_HUGEPAGE)``d before the
    first touch, so it populates as 2 MB pages whatever the system's THP
    setting.  Call :func:`tune_malloc` first, so the touched pages survive
    the free.  Idempotent up to the largest size asked for; returns the
    thread, or None when nothing was left to fault or it ran in place."""
    global _prefaulted_bytes
    with _prefault_lock:
        want = nbytes - _prefaulted_bytes
        if want <= 0:
            return None
        _prefaulted_bytes = nbytes
    if background:
        t = threading.Thread(target=_touch, args=(want,), daemon=True, name="hh-prefault")
        t.start()
        return t
    _touch(want)
    return None


def enable_thp() -> bool:
    """Best-effort system-wide THP enable (for CLI entry points only: a
    library should not flip host-global knobs).  Returns True when the knob
    was written; False without the privilege."""
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled", "w") as f:
            f.write("always")
        return True
    except OSError:
        return False
