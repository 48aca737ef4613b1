"""The port's streaming tokenizer against the JAX package's.

``tokenize_vcf_streaming`` (torch ops on the CPU here) must give the JAX
function's columns bit for bit, and those of the whole-file
``tokenize_vcf_device``: with one chunk and many, with a window that grows
from chunk to chunk (W is the widest seen so far, which moves each line's
window origin), with and without a region read through a sibling ``.tbi``,
and it must raise for a sample the header lacks.
"""

import gzip

import numpy as np
import pytest

from haplohyped_tpu.ops.vcf_stream import tokenize_vcf_streaming as jax_stream

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.bgzf import EOF_BLOCK, _compress_block
from haplohyped_tpu_torch.hostio.tabix import build_index
from haplohyped_tpu_torch.ops.vcf_stream import _lines_from_newlines, tokenize_vcf_streaming
from haplohyped_tpu_torch.ops.vcf_tokenize import tokenize_vcf_device

from tests.test_torch_tokenize import assert_columns_equal


def write_small_blocks(path, text: bytes, payload: int) -> str:
    """``text`` as BGZF blocks of ``payload`` bytes (many blocks from little
    text, so a small file streams in many chunks)."""
    with open(path, "wb") as f:
        for lo in range(0, len(text), payload):
            f.write(_compress_block(text[lo:lo + payload], 6))
        f.write(EOF_BLOCK)
    return str(path)


@pytest.fixture(scope="module")
def growing(tmp_path_factory):
    """Three chromosomes' records whose lines grow along the file: short,
    then ~200-byte INFO, then ~700-byte INFO (W 128 -> 256 -> 1024), with
    CRLF endings on some lines, in BGZF blocks of 2,000 bytes."""
    rng = np.random.default_rng(4)
    samples = ["a", "b", "c"]
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./.", "0/1", "1"])
    rows = []
    for i, chrom in enumerate(["chr1"] * 120 + ["chr2"] * 100 + ["chr3"] * 60):
        info = "." if chrom == "chr1" else "I=" + "x" * int(
            rng.integers(150, 250) if chrom == "chr2" else rng.integers(600, 800))
        ref, alt = rng.choice(list("ACGT"), 2, replace=False)
        rows.append(f"{chrom}\t{1000 + 37 * i}\t.\t{ref}\t{alt}\t.\tPASS\t{info}\tGT\t"
                    + "\t".join(rng.choice(gts, 3)) + ("\r" if i % 11 == 0 else ""))
    text = ("##fileformat=VCFv4.2\n##contig=<ID=chr1>\n##contig=<ID=chr2>\n##contig=<ID=chr3>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(samples)
            + "\n" + "\n".join(rows) + "\n").encode()
    d = tmp_path_factory.mktemp("stream")
    path = write_small_blocks(d / "grow.vcf.gz", text, 2000)
    build_index(path)
    return path, samples, text


def stream_both(path, sample, **kw):
    stats = {}
    got = tokenize_vcf_streaming(path, sample, device="cpu", stats=stats, **kw)
    assert_columns_equal(got, jax_stream(path, sample, **kw), f"{sample} {kw}")
    return got, stats


#: one chunk, and chunks of 3 blocks: the first holds only short lines
CHUNKS = {"one": 1 << 24, "many": 6_000}


@pytest.mark.parametrize("chunks,sample", [("one", None), ("one", "a"), ("many", "c")])
def test_streaming_matches_jax_and_whole_file(growing, chunks, sample):
    path = growing[0]
    got, stats = stream_both(path, sample, chunk_bytes=CHUNKS[chunks])
    assert stats["W"] == 1024 and (stats["chunks"] == 1) == (chunks == "one")
    with native.vcf_text(path) as vt:
        whole = tokenize_vcf_device(vt, sample, device="cpu")
    if chunks == "one":  # one window for the file: every column equal
        assert_columns_equal(got, whole, "whole file")
        return
    assert stats["chunks"] >= 8
    # the window grew from 128: rows tokenized at a narrower W differ from
    # the whole file's only where the window's origin shows (reads for
    # empty fields), never in what the converter keeps
    assert got["long_line"].sum() == whole["long_line"].sum() == 0
    keep = got["valid"]
    np.testing.assert_array_equal(keep, whole["valid"])
    for k in ("start", "stop", "phase1", "phase2", "snp_mask", "chrom", "ref_char", "alt_char"):
        np.testing.assert_array_equal(got[k][keep], whole[k][keep], k)


@pytest.mark.parametrize("region", [("chr2", 6000, 7000), ("chr3", 9000, -1), ("chr1", 0, 3000)])
def test_streaming_region_matches_jax(growing, region):
    """A region read: the seek through the ``.tbi`` and the early stop.  In
    the first contig the region's first record shares the header's block;
    the JAX function then looks for the header past the seek and raises, the
    port reads the header on its own (and its columns are the unseeked
    read's rows from the first record on)."""
    path = growing[0]
    full = tokenize_vcf_streaming(path, "b", chunk_bytes=6_000, device="cpu")
    if region[0] == "chr1":
        with pytest.raises(RuntimeError, match="no #CHROM"):
            jax_stream(path, "b", chunk_bytes=6_000, region=region)
        got = tokenize_vcf_streaming(path, "b", chunk_bytes=6_000, region=region, device="cpu")
        assert_columns_equal(got, {k: v[: got["start"].shape[0]] for k, v in full.items()})
    else:
        got, _ = stream_both(path, "b", chunk_bytes=6_000, region=region)
    assert 0 < got["start"].shape[0] < full["start"].shape[0]


def test_streaming_of_a_corpus_matches_jax(test_data_dir):
    path = str(test_data_dir / "chr22.filtered.vcf.gz")
    got, stats = stream_both(path, native.vcf_samples(path)[1], chunk_bytes=30_000)
    assert stats["chunks"] > 1 and got["valid"].all()


def test_streaming_without_a_final_newline(growing, tmp_path):
    """A last line without a newline is a line.  The JAX function raises
    there (it copies ``consumed`` bytes, one past the chunk's text); the
    port's columns equal the whole-file tokenizer's, the JAX one's too."""
    from haplohyped_tpu.hostio import native as jax_native
    from haplohyped_tpu.ops.vcf_tokenize import tokenize_vcf_device as jax_device

    path = write_small_blocks(tmp_path / "nonl.vcf.gz", growing[2].rstrip(b"\n"), 2000)
    with pytest.raises(ValueError, match="broadcast"):
        jax_stream(path, "a", chunk_bytes=1 << 24)
    got = tokenize_vcf_streaming(path, "a", chunk_bytes=1 << 24, device="cpu")
    jvt = jax_native.vcf_text(path)
    try:
        assert_columns_equal(got, {k: np.asarray(v) for k, v in jax_device(jvt, "a").items()})
    finally:
        jvt.close()
    assert got["start"].shape == (280,) and got["valid"][-1]


def test_streaming_unknown_sample_raises(growing):
    path = growing[0]
    for region in (None, ("chr2", 6000, 7000)):
        with pytest.raises(RuntimeError, match="sample not found"):
            tokenize_vcf_streaming(path, "ghost", chunk_bytes=6_000, region=region, device="cpu")


def test_streaming_without_data_lines(tmp_path):
    path = write_small_blocks(tmp_path / "h.vcf.gz", b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\t"
                              b"REF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n", 30)
    got, stats = stream_both(path, "s1", chunk_bytes=100)
    assert got["start"].shape == (0,) and stats["chunks"] == 0


def test_lines_from_newlines_matches_jax():
    from haplohyped_tpu.ops.vcf_stream import _lines_from_newlines as jax_lines

    text = np.frombuffer(b"#h\nab\r\n\ncd\n#x\nefg\r\nhi", np.uint8)
    nl = np.flatnonzero(text == 10).astype(np.int64)
    for start_from in (0, 3):
        got, want = _lines_from_newlines(text, nl, start_from), jax_lines(text, nl, start_from)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_gzip_input_is_refused(tmp_path):
    """A plain gzip file is no BGZF: the block reader raises, as in JAX."""
    path = tmp_path / "plain.vcf.gz"
    with gzip.open(path, "wb") as f:
        f.write(b"#CHROM\tPOS\n" * 5000)
    for stream in (jax_stream, lambda p, s: tokenize_vcf_streaming(p, s, device="cpu")):
        with pytest.raises(RuntimeError, match="BGZF"):
            stream(str(path), None)
