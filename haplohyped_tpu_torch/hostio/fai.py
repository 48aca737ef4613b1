"""faidx-compatible FASTA indexing.

``build_fai`` writes the samtools ``faidx`` format
(``name<TAB>length<TAB>offset<TAB>linebases<TAB>linewidth``), so indexes
built here are usable by samtools/pysam and the other way round.
``FaidxFasta`` serves range fetches by seeking, without loading the whole
file, so one chromosome of a 3 GB genome costs its own bytes.  Plain
(uncompressed) FASTA only, as samtools without a ``.gzi``; the whole-file
readers of :mod:`haplohyped_tpu_torch.hostio.fasta` read gzipped inputs.
"""

from __future__ import annotations

import os


class FaiRecord:
    __slots__ = ("name", "length", "offset", "linebases", "linewidth")

    def __init__(self, name: str, length: int, offset: int, linebases: int, linewidth: int):
        self.name = name
        self.length = length
        self.offset = offset
        self.linebases = linebases
        self.linewidth = linewidth


def read_fai(path: str) -> dict[str, FaiRecord]:
    """Parse a ``.fai`` file into name -> record (insertion-ordered)."""
    out: dict[str, FaiRecord] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, length, offset, linebases, linewidth = line.split("\t")[:5]
            out[name] = FaiRecord(name, int(length), int(offset), int(linebases), int(linewidth))
    return out


def build_fai(fasta_path: str, fai_path: str | None = None) -> dict[str, FaiRecord]:
    """Index a plain FASTA; write ``{fasta_path}.fai`` (samtools format).

    Rejects what samtools rejects, since a seek-based fetch needs uniform
    lines: gzipped input, a record whose interior lines differ in length, a
    final line longer than the record's line length, and a blank line
    followed by more sequence of the same record.  Trailing blank lines are
    fine.
    """
    with open(fasta_path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            raise ValueError(
                "faidx needs uncompressed FASTA (gzipped inputs use the whole-file reader)"
            )
    records: dict[str, FaiRecord] = {}
    name = None
    length = offset = linebases = linewidth = 0
    prev_line_len = None  # bases on the previous sequence line
    pending_blank = False  # blank line seen inside the current record

    def flush() -> None:
        # the uniformity check lags one line, so a record's final line is
        # checked here: it may be short, but a longer one breaks the seek math
        if prev_line_len is not None and prev_line_len > linebases:
            raise ValueError(
                f"sequence {name!r}: final line ({prev_line_len} bases) exceeds the "
                f"record's line length ({linebases}); cannot faidx-index"
            )
        records[name] = FaiRecord(name, length, offset, linebases, linewidth)

    with open(fasta_path, "rb") as f:
        pos = 0
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if raw.startswith(b">"):
                if name is not None:
                    flush()
                name = raw[1:].split()[0].decode()
                length = linebases = linewidth = 0
                offset = pos + len(raw)
                prev_line_len = None
                pending_blank = False
            elif name is not None:
                if not line:
                    pending_blank = True
                else:
                    if pending_blank:
                        raise ValueError(
                            f"blank line inside sequence {name!r}; cannot faidx-index "
                            "(seek math would serve wrong bases)"
                        )
                    if prev_line_len is not None and prev_line_len != linebases:
                        raise ValueError(
                            f"irregular line length in sequence {name!r}; cannot faidx-index"
                        )
                    if linebases == 0:
                        linebases = len(line)
                        linewidth = len(raw)
                    prev_line_len = len(line)
                    length += len(line)
            pos += len(raw)
        if name is not None:
            flush()

    fai_path = fai_path or fasta_path + ".fai"
    with open(fai_path, "w") as f:
        for r in records.values():
            f.write(f"{r.name}\t{r.length}\t{r.offset}\t{r.linebases}\t{r.linewidth}\n")
    return records


class FaidxFasta:
    """Seek-based range fetches over an indexed plain FASTA (the index is
    built where it does not exist)."""

    def __init__(self, path: str, fai_path: str | None = None):
        fai_path = fai_path or path + ".fai"
        if os.path.exists(fai_path):
            self._idx = read_fai(fai_path)
        else:
            self._idx = build_fai(path, fai_path)
        self._f = open(path, "rb")

    def names(self) -> list[str]:
        return list(self._idx)

    def length(self, name: str) -> int:
        return self._idx[name].length

    def fetch(self, name: str, start: int, end: int) -> bytes:
        """Bases ``[start, end)`` of ``name``, clamped to the record."""
        r = self._idx[name]
        start = max(0, start)
        end = min(r.length, end)
        if end <= start:
            return b""
        # the file span covering [start, end); newlines stripped after the read
        lo = r.offset + (start // r.linebases) * r.linewidth + start % r.linebases
        hi = r.offset + ((end - 1) // r.linebases) * r.linewidth + (end - 1) % r.linebases + 1
        self._f.seek(lo)
        raw = self._f.read(hi - lo)
        return raw.replace(b"\n", b"").replace(b"\r", b"")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "FaidxFasta":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
