"""BGZF block compression (the write side).

The port's copy of ``haplohyped_tpu.hostio.bgzf``.  BGZF is the blocked gzip
of ``.vcf.gz`` and ``.bcf`` files: gzip members of at most 64 KiB with a
``BC`` extra field that carries the compressed block size, ended by a fixed
28-byte EOF member.  The read side is ``hostio/native.py``
(:class:`BgzfRangeReader`); this module writes, for the VCF/BCF writers and
the tabix/CSI index builder.  Blocks are independent, so ``bgzf_compress``
fans them out over threads (``zlib`` releases the GIL while deflating).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

#: Max payload bytes per BGZF block (htslib uses 0xFF00).
BLOCK_PAYLOAD = 0xFF00

#: The fixed 28-byte BGZF EOF marker block (empty deflate member).
EOF_BLOCK = (
    b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00\x1b\x00"
    b"\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00"
)


def _compress_block(chunk: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(chunk) + co.flush()
    bsize = len(comp) + 25 + 1
    if bsize > 0x10000:
        # Incompressible payload: store-only deflate still fits because the
        # payload cap leaves 255 bytes of headroom for framing.
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1
    header = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00" + struct.pack(
        "<H", bsize - 1
    )
    return header + comp + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def bgzf_compress(data: bytes, level: int = 6, threads: int = 1) -> bytes:
    """Compress ``data`` into a complete BGZF stream (with EOF marker)."""
    chunks = [data[lo : lo + BLOCK_PAYLOAD] for lo in range(0, len(data), BLOCK_PAYLOAD)]
    if threads > 1 and len(chunks) > 1:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            blocks = list(ex.map(lambda c: _compress_block(c, level), chunks))
    else:
        blocks = [_compress_block(c, level) for c in chunks]
    return b"".join(blocks) + EOF_BLOCK


def bgzf_write(path: str, data: bytes, level: int = 6, threads: int = 1) -> None:
    """Write ``data`` to ``path`` as a BGZF stream."""
    with open(path, "wb") as f:
        f.write(bgzf_compress(data, level=level, threads=threads))


class BgzfWriter:
    """Streaming BGZF writer with virtual-offset tracking.

    ``tell_virtual()`` returns the htslib virtual offset
    ``(compressed_block_start << 16) | within_block_offset`` of the next byte
    to be written — the currency of tabix/CSI indexes
    (see ``hostio/tabix.py``).
    """

    def __init__(self, path: str, level: int = 6):
        self._f = open(path, "wb")
        self._level = level
        self._buf = bytearray()
        self._coffset = 0  # compressed offset of the block holding _buf
        self._closed = False

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= BLOCK_PAYLOAD:
            self._flush_block(BLOCK_PAYLOAD)

    def tell_virtual(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def _flush_block(self, n: int) -> None:
        block = _compress_block(bytes(self._buf[:n]), self._level)
        self._f.write(block)
        del self._buf[:n]
        self._coffset += len(block)

    def close(self) -> None:
        if self._closed:
            return
        if self._buf:
            self._flush_block(len(self._buf))
        self._f.write(EOF_BLOCK)
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
