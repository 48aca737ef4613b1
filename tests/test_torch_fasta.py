"""The port's FASTA readers and faidx index against the JAX package's.

``build_fai`` must write the same bytes, reject the same inputs, and every
reader (faidx seek-fetch, the native whole-file reader, ``_PyFasta``) must
serve the same names, lengths and bases as the JAX ``FastaReader``.
"""

import gzip
import os
import shutil
import time

import numpy as np
import pytest

from haplohyped_tpu.hostio.fai import build_fai as jax_build_fai
from haplohyped_tpu.hostio.fasta import FastaReader as JaxFastaReader
from haplohyped_tpu_torch.hostio.fai import FaidxFasta, build_fai, read_fai
from haplohyped_tpu_torch.hostio.fasta import FastaReader, _PyFasta
from haplohyped_tpu_torch.hostio.native import NativeFasta

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture()
def fasta(tmp_path):
    """Three records at 60 bases a line: N and lowercase runs, one record
    shorter than a line (the fixture of ``tests/test_fai.py``, widened)."""
    rng = np.random.default_rng(0)
    seqs = {
        "chr1": bytes(np.frombuffer(b"ACGTNacgtn", np.uint8)[rng.integers(0, 10, 1000)]),
        "chr2": bytes(np.frombuffer(b"ACGTRYKM", np.uint8)[rng.integers(0, 8, 357)]),
        "chrM": b"ACGT",
    }
    p = tmp_path / "g.fa"
    with open(p, "wb") as f:
        for name, seq in seqs.items():
            f.write(b">" + name.encode() + b" description ignored\n")
            for lo in range(0, len(seq), 60):
                f.write(seq[lo : lo + 60] + b"\n")
    return str(p), seqs


@pytest.fixture()
def chr22(tmp_path):
    """A copy of the bundled chr22 FASTA, so an index written beside it
    stays out of ``tests/data``."""
    dst = tmp_path / "chr22.fasta"
    shutil.copy(os.path.join(DATA, "chr22.fasta"), dst)
    return str(dst)


def test_build_fai_byte_equal_to_jax(fasta, tmp_path):
    path, seqs = fasta
    recs = build_fai(path, str(tmp_path / "port.fai"))
    jax_recs = jax_build_fai(path, str(tmp_path / "jax.fai"))
    assert (tmp_path / "port.fai").read_bytes() == (tmp_path / "jax.fai").read_bytes()
    assert (tmp_path / "port.fai").read_text().splitlines()[0] == "chr1\t1000\t26\t60\t61"
    assert list(recs) == list(jax_recs) == list(seqs)
    for name, r in read_fai(str(tmp_path / "port.fai")).items():
        j = jax_recs[name]
        assert (r.length, r.offset, r.linebases, r.linewidth) == (
            j.length, j.offset, j.linebases, j.linewidth)


def test_build_fai_on_chr22_byte_equal_to_jax(chr22, tmp_path):
    build_fai(chr22, str(tmp_path / "port.fai"))
    jax_build_fai(chr22, str(tmp_path / "jax.fai"))
    assert (tmp_path / "port.fai").read_bytes() == (tmp_path / "jax.fai").read_bytes()


#: the strictness cases of ``tests/test_fai.py``: input, and the error both
#: packages raise (None: indexed, with these lengths)
STRICTNESS = {
    "gzip": (gzip.compress(b">c\nACGT\n"), "uncompressed"),
    "irregular_lines": (b">c\nACGT\nAC\nGGGG\n", "irregular"),
    "long_final_line": (b">c\nACGT\nACGTACGT\n", "final line"),
    "blank_interior_line": (b">c\nACGT\n\nGGTT\n", "blank line"),
    "blank_after_header": (b">c\n\nACGT\n", "blank line"),
    "trailing_blank_lines": (b">c\nACGT\nAC\n\n\n>d\nGGGG\n", {"c": 6, "d": 4}),
    "short_final_line": (b">c\nACGT\nAC\n", {"c": 6}),
    "crlf": (b">c x\r\nACGT\r\nAC\r\n", {"c": 6}),
}


@pytest.mark.parametrize("case", list(STRICTNESS))
def test_strictness_matches_jax(case, tmp_path):
    data, want = STRICTNESS[case]
    p = tmp_path / "in.fa"
    p.write_bytes(data)
    if isinstance(want, str):
        for fn in (build_fai, jax_build_fai):
            with pytest.raises(ValueError, match=want):
                fn(str(p), str(tmp_path / "x.fai"))
        return
    recs = build_fai(str(p), str(tmp_path / "port.fai"))
    jax_build_fai(str(p), str(tmp_path / "jax.fai"))
    assert (tmp_path / "port.fai").read_bytes() == (tmp_path / "jax.fai").read_bytes()
    assert {k: r.length for k, r in recs.items()} == want
    with FaidxFasta(str(p), str(tmp_path / "port.fai")) as fx:
        assert fx.fetch("c", 0, 6) == b"ACGTAC"


def test_faidx_fetch_ranges_match_jax(fasta):
    path, seqs = fasta
    with FaidxFasta(path) as fx, JaxFastaReader(path) as jx:  # both read the new index
        assert fx.names() == jx.names() == list(seqs)
        for name, seq in seqs.items():
            assert fx.length(name) == jx.length(name) == len(seq)
            for lo, hi in ((0, len(seq)), (3, 7), (59, 61), (0, 0), (-5, 10_000), (60, 120)):
                assert fx.fetch(name, lo, hi) == jx.fetch(name, lo, hi) == seq[max(lo, 0):hi]


def test_stale_index_falls_back(tmp_path):
    p = tmp_path / "s.fa"
    p.write_bytes(b">c\n" + b"A" * 60 + b"\n" + b"C" * 60 + b"\n")
    build_fai(str(p))
    time.sleep(0.01)
    p.write_bytes(b">c\n" + b"G" * 30 + b"\n")  # shorter: the indexed end passes the file
    os.utime(str(p) + ".fai", (0, 0))
    for use_native in (True, False):
        with FastaReader(str(p), use_native=use_native) as r:
            assert not isinstance(r._impl, FaidxFasta)
            assert r.fetch("c", 0, 30) == b"G" * 30 and r.length("c") == 30


def test_fresh_index_preferred_and_older_index_refused(fasta):
    path, seqs = fasta
    build_fai(path)
    with FastaReader(path) as r:
        assert isinstance(r._impl, FaidxFasta)
        assert r.fetch("chr1", 10, 50) == seqs["chr1"][10:50]
    os.utime(path + ".fai", (0, 0))  # the FASTA is now newer than its index
    with FastaReader(path) as r:
        assert isinstance(r._impl, NativeFasta)


@pytest.mark.parametrize("impl", ["faidx", "native", "python"])
def test_reader_matches_jax_on_chr22(chr22, impl):
    if impl == "faidx":
        build_fai(chr22)
    with FastaReader(chr22, use_native=impl != "python") as r, JaxFastaReader(chr22) as j:
        want_impl = {"faidx": FaidxFasta, "native": NativeFasta, "python": _PyFasta}[impl]
        assert isinstance(r._impl, want_impl)
        assert r.names() == j.names() == ["chr22"]
        n = r.length("chr22")
        assert n == j.length("chr22") == 400_000
        assert r.fetch("chr22") == j.fetch("chr22")
        for lo, hi in ((n - 5, n + 100), (-10, 5), (12_345, 67_890), (5, 5)):
            assert r.fetch("chr22", lo, hi) == j.fetch("chr22", lo, hi)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_multirecord_matches_jax(tmp_path, gz, use_native):
    text = b">a desc\nACGTAC\nGTAC\n>b\tx\nttTT\nGG\n>c\n"
    p = tmp_path / ("multi.fa.gz" if gz else "multi.fa")
    p.write_bytes(gzip.compress(text) if gz else text)
    with FastaReader(str(p), use_native=use_native) as r, \
            JaxFastaReader(str(p), use_native=use_native) as j:
        assert r.names() == j.names() == ["a", "b", "c"]
        for name in ("a", "b", "c"):
            assert r.length(name) == j.length(name)
            assert r.fetch(name) == j.fetch(name)
            assert r.fetch(name, 2, 8) == j.fetch(name, 2, 8)
        assert r.fetch("a", 2, 8) == b"GTACGT" and r.fetch("b") == b"ttTTGG"


def test_gzip_with_index_beside_it_reads_whole_file(tmp_path):
    p = tmp_path / "g.fa.gz"
    p.write_bytes(gzip.compress(b">c\nACGT\n"))
    (tmp_path / "g.fa.gz.fai").write_text("c\t4\t3\t4\t5\n")
    with FastaReader(str(p)) as r:
        assert isinstance(r._impl, NativeFasta) and r.fetch("c") == b"ACGT"


def test_native_fasta_errors(tmp_path, fasta):
    path, _ = fasta
    with NativeFasta(path) as nf:
        with pytest.raises(KeyError):
            nf.length("chrX")
        with pytest.raises(KeyError):
            nf.fetch("chrX", 0, 4)
        assert nf.fetch("chrM", 2, 100) == b"GT"
    with pytest.raises(RuntimeError):
        NativeFasta(str(tmp_path / "missing.fa"))
    bad = tmp_path / "bad.fa"
    bad.write_bytes(b"ACGT\n")
    with pytest.raises(RuntimeError, match="malformed"):
        NativeFasta(str(bad))
