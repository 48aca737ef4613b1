"""The streaming tokenizer: host decompression of a chunk overlaps the
device tokenizing the chunk before it.

The port of ``haplohyped_tpu.ops.vcf_stream``, the path for BGZF cohort VCFs
too large to decompress whole: the host inflates a bounded run of BGZF
blocks (threaded, newline scan fused) while the device still tokenizes the
previous run, so the wall time approaches the larger of the two instead of
their sum, and host memory stays bounded by the chunk.

The overlap needs the host never to wait on the device inside the loop: each
chunk is inflated straight into page-locked (pinned) host memory and copied
with ``non_blocking=True``, the line index goes the same way, the outputs
stay on the device until the loop ends, and nothing in the loop reads a
device value.  PyTorch's pinned-memory cache hands a buffer out again only
after the copy that read it has finished.  On the CPU the same loop runs
synchronously.

The JAX version pads each chunk's text and line count to fixed buckets so
XLA compiles once; torch compiles nothing, so the port keeps only what the
outputs see: zeros past the chunk's text and one zero row of slack.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.tabix import region_virtual_offset
from haplohyped_tpu_torch.ops.vcf_tokenize import (
    choose_window,
    decoded_to_host,
    empty_decoded,
    sample_column,
    tokenize_lines,
)


def _parse_header_bytes(text: np.ndarray) -> tuple[int, list[str]]:
    """``(data_start, samples)`` from the first chunk's bytes.

    Raises where the header, or its last line, is cut at the buffer's end,
    so callers retry with a longer prefix: a ``#CHROM`` line cut midway must
    not yield a partial sample list."""
    samples: list[str] = []
    found_chrom = False
    n = text.shape[0]
    buf = text.tobytes()
    off = 0
    while off < n and buf[off:off + 1] == b"#":
        nl = buf.find(b"\n", off)
        if nl < 0:
            raise RuntimeError("VCF header truncated at buffer end")
        line = buf[off:nl].rstrip(b"\r")
        if line.startswith(b"#CHROM"):
            found_chrom = True
            samples = [f.decode() for f in line.split(b"\t")[9:]]
        off = nl + 1
    if not found_chrom:
        raise RuntimeError("VCF has no #CHROM header line in first chunk")
    return off, samples


def _lines_from_newlines(
    text: np.ndarray, nl: np.ndarray, start_from: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """``(line_starts, line_lengths, consumed_end)`` of the complete data
    lines: no header line, no empty line, no carriage return."""
    if nl.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32), start_from
    starts = np.empty_like(nl)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    lens = (nl - starts).astype(np.int32)
    last = np.minimum(starts + lens - 1, text.shape[0] - 1)
    cr = (lens > 0) & (text[last] == 13)
    lens = lens - cr.astype(np.int32)
    first_byte = text[np.minimum(starts, text.shape[0] - 1)]
    keep = (starts >= start_from) & (lens > 0) & (first_byte != ord("#"))
    return starts[keep], lens[keep], int(nl[-1]) + 1


def _read_header_streaming(reader, threads: int) -> tuple[int, list[str]]:
    """Inflate leading blocks until the ``#CHROM`` line is found."""
    nb = reader.n_blocks
    hi = 1
    while True:
        buf = np.empty(reader.uoffset(hi), np.uint8)
        reader.decode_range(0, hi, threads, buf)
        try:
            return _parse_header_bytes(buf)
        except RuntimeError:
            if hi >= nb:
                raise
            hi = min(hi * 4, nb)


def _block_ranges(reader, first: int, chunk_bytes: int) -> list[tuple[int, int]]:
    """Runs of whole blocks from ``first``, each just past ``chunk_bytes``
    of text (one block at least)."""
    ranges, lo, nb = [], first, reader.n_blocks
    while lo < nb:
        hi, base = lo + 1, reader.uoffset(lo)
        while hi < nb and reader.uoffset(hi) - base < chunk_bytes:
            hi += 1
        ranges.append((lo, hi))
        lo = hi
    return ranges


def _upload(host: torch.Tensor, n_text: int, starts, lens, W: int, dev: torch.device):
    """One chunk to ``dev``: its first ``n_text`` bytes in whole rows of W,
    zero past them, with a zero row of slack (``n_text + 1`` where the last
    line has no newline), and the line starts and lengths as int32."""
    rows = -(-n_text // W) + 1
    text = torch.empty(rows * W, dtype=torch.uint8, device=dev)
    n_copy = min(n_text, host.shape[0])
    text[:n_copy].copy_(host[:n_copy], non_blocking=True)
    text[n_copy:].zero_()
    index = torch.from_numpy(np.stack([starts, lens]).astype(np.int32))
    if dev.type == "cuda":
        index = index.pin_memory()
    index = index.to(dev, non_blocking=True)
    return text, index[0], index[1]


def tokenize_vcf_streaming(
    path: str,
    sample: str | None,
    threads: int = 2,
    chunk_bytes: int = 48 << 20,
    window_cap: int = 4096,
    region: tuple[str, int, int] | None = None,
    device: str | torch.device = "cuda",
    *,
    stats: dict | None = None,
) -> dict[str, np.ndarray]:
    """Tokenize a BGZF VCF chunk by chunk on ``device``.

    ``region=(chrom, beg0, end0)`` (0-based half-open; -1 for unbounded)
    seeks through a sibling ``.tbi`` (``hostio/tabix.py``) to the first BGZF
    block that can hold it and stops once a chunk's first record starts past
    its end; filtering by chromosome and position is left to the caller's
    masks (``snp_struct_from_decoded``).  The window W is the widest any
    chunk so far has needed, as in the JAX package.  Where ``stats`` is a
    dict it receives ``chunks``, ``W``, ``host_s`` (host time of the loop:
    inflating, the line scan, staging and enqueueing) and, on CUDA,
    ``device_ms`` (CUDA events from each chunk's copy to its last op).

    Returns host decode columns, the schema of ``tokenize_vcf_device``."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    with native.BgzfRangeReader(path) as reader:
        start_block, skip_bytes = 0, 0
        stop_after = None  # 0-based position past which decoding can stop
        if region is not None:
            chrom_r, beg_r, end_r = region
            voff = region_virtual_offset(path, chrom_r, max(beg_r, 0))
            if voff:
                start_block = reader.block_at(voff >> 16)
                skip_bytes = voff & 0xFFFF
            if end_r is not None and end_r >= 0:
                stop_after = end_r
        ranges = _block_ranges(reader, start_block, chunk_bytes)

        # seeked past the header, also where the region's first record sits
        # in the header's block (the JAX package then looks for the header
        # after the seek and raises)
        seeked = start_block > 0 or skip_bytes > 0
        sample_col = -1
        if sample and seeked:
            sample_col = sample_column(_read_header_streaming(reader, threads)[1], sample)

        data_start = 0 if seeked else None
        carry = np.zeros(0, np.uint8)
        outs: list[dict[str, torch.Tensor]] = []
        events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        W = None
        t_host = time.perf_counter()
        for ri, (blo, bhi) in enumerate(ranges):
            size = reader.uoffset(bhi) - reader.uoffset(blo)
            staged = torch.empty(carry.shape[0] + size, dtype=torch.uint8, pin_memory=pin)
            buf = staged.numpy()
            buf[: carry.shape[0]] = carry
            nl = reader.decode_range(blo, bhi, threads, buf, out_off=carry.shape[0])
            nl = nl + carry.shape[0]
            if ri == 0 and skip_bytes:
                # the tabix offset points at a record start inside the block
                staged, buf = staged[skip_bytes:], buf[skip_bytes:]
                nl = nl[np.searchsorted(nl, skip_bytes):] - skip_bytes

            if data_start is None:
                data_start, samples = _parse_header_bytes(buf)
                sample_col = sample_column(samples, sample)

            is_last = ri == len(ranges) - 1
            if buf.shape[0] == 0:
                continue
            if is_last and (nl.shape[0] == 0 or nl[-1] != buf.shape[0] - 1):
                # trailing bytes without a newline are a last line
                nl = np.concatenate([nl, np.asarray([buf.shape[0]], np.int64)])

            starts, lens, consumed = _lines_from_newlines(buf, nl, data_start)
            carry = buf[consumed:].copy() if not is_last else np.zeros(0, np.uint8)
            data_start = 0  # only the first chunk holds the header

            if starts.shape[0] == 0:
                continue
            if stop_after is not None:
                # records are position-sorted: once a chunk's first record
                # starts past the region's end, stop
                s0 = int(starts[0])
                first_line = bytes(buf[s0:s0 + int(lens[0])])
                try:
                    if int(first_line.split(b"\t", 2)[1]) - 1 > stop_after:
                        break
                except (IndexError, ValueError):
                    pass
            # the widest window seen so far: it sets the lines' origin and
            # long_line, so it is the JAX package's rule, not a tuning
            W = max(W or 0, choose_window(int(lens.max()), cap=window_cap))

            if pin:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            text, offs, lns = _upload(staged, consumed, starts, lens, W, dev)
            outs.append(tokenize_lines(text, offs, lns, W=W, sample_col=sample_col,
                                       with_sample=sample is not None))
            if pin:
                ev[1].record()
                events.append(ev)
        host_s = time.perf_counter() - t_host

    result = decoded_to_host(outs) if outs else empty_decoded()
    if stats is not None:
        stats.update(chunks=len(outs), W=W, host_s=host_s)
        if events:
            stats["device_ms"] = sum(a.elapsed_time(b) for a, b in events)
    return result
