"""FASTA access: a fresh faidx index where there is one, else the native
whole-file reader.

Fetches return the raw bytes, case kept; encoding happens in
:mod:`haplohyped_tpu_torch.ops.onehot`.  The pure-Python reader
(``_PyFasta``) runs only when the caller asks for it (``use_native=False``):
a failed native build raises, as everywhere in this package.
"""

from __future__ import annotations

import gzip
import logging
import os

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.fai import FaidxFasta, read_fai

logger = logging.getLogger(__name__)


class _PyFasta:
    """A plain or gzipped FASTA read whole in Python."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            gz = f.read(2) == b"\x1f\x8b"
        with (gzip.open(path, "rb") if gz else open(path, "rb")) as f:
            data = f.read()
        self._seqs: dict[str, bytes] = {}
        name = None
        chunks: list[bytes] = []
        for line in data.split(b"\n"):
            line = line.rstrip(b"\r")
            if line.startswith(b">"):
                if name is not None:
                    self._seqs[name] = b"".join(chunks)
                name = line[1:].split(b" ")[0].split(b"\t")[0].decode()
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            self._seqs[name] = b"".join(chunks)

    def names(self) -> list[str]:
        return list(self._seqs)

    def length(self, name: str) -> int:
        return len(self._seqs[name])

    def fetch(self, name: str, start: int, end: int) -> bytes:
        seq = self._seqs[name]
        return seq[max(0, start) : min(len(seq), end)]

    def close(self) -> None:
        self._seqs = {}


def _fai_fresh(path: str) -> bool:
    """Whether ``{path}.fai`` may serve ``path``: a FASTA rewritten after
    indexing makes the seek math serve wrong bases with no error.  The last
    record's end offset must fit the file size and the index must not be
    older than the FASTA; otherwise a warning, and the whole-file reader."""
    fai = path + ".fai"
    try:
        recs = read_fai(fai)
    except (OSError, ValueError) as exc:
        logger.warning("unreadable .fai index %s (%s); using the whole-file reader", fai, exc)
        return False
    if not recs:
        return False
    last = recs[next(reversed(recs))]
    full_lines, rem = divmod(last.length, max(last.linebases, 1))
    # the least bytes the record's bases need (the final line may lack its newline)
    if rem:
        end = last.offset + full_lines * last.linewidth + rem
    elif full_lines:
        end = last.offset + (full_lines - 1) * last.linewidth + last.linebases
    else:
        end = last.offset
    fsize = os.path.getsize(path)
    fresh = end <= fsize and os.path.getmtime(fai) >= os.path.getmtime(path)
    if not fresh:
        logger.warning(
            ".fai index for %s is stale (indexed end %d vs file size %d, or older "
            "mtime); using the whole-file reader", path, end, fsize,
        )
    return fresh


class FastaReader:
    """One FASTA interface: faidx seek-fetches where a fresh ``.fai`` sits
    next to an uncompressed file (build one with ``faidx``), else the native
    whole-file reader, or ``_PyFasta`` where ``use_native=False``."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        if os.path.exists(path + ".fai"):
            with open(path, "rb") as f:
                gz = f.read(2) == b"\x1f\x8b"
            if not gz and _fai_fresh(path):
                self._impl = FaidxFasta(path)
                return
        self._impl = native.NativeFasta(path) if use_native else _PyFasta(path)

    def names(self) -> list[str]:
        return self._impl.names()

    def length(self, name: str) -> int:
        return self._impl.length(name)

    def fetch(self, name: str, start: int | None = None, end: int | None = None) -> bytes:
        """Bases ``[start, end)`` of ``name`` (the whole record by default),
        clamped to it."""
        if start is None:
            start = 0
        if end is None:
            end = self.length(name)
        return self._impl.fetch(name, start, end)

    def close(self) -> None:
        self._impl.close()

    def __enter__(self) -> "FastaReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
