"""The port's BGZF, VCF and BCF writers against the JAX package's.

Both packages compress with this process's zlib, so every file the port
writes must be byte-identical to the JAX writer's: ``bgzf_compress`` at
each level and thread count, ``BgzfWriter`` with its virtual offsets, and
``VcfWriter``/``BcfWriter`` in the modes ``w``, ``z``, ``b`` and ``bu``.
The port's own readers then read the files back, and ``VcfHeader``'s
queries answer as the JAX header's do.
"""

import gzip
import os

import numpy as np
import pytest

from haplohyped_tpu.hostio import bgzf as jax_bgzf
from haplohyped_tpu.hostio import writer as jax_writer

from haplohyped_tpu_torch.hostio import bgzf, writer
from haplohyped_tpu_torch.hostio.bcf import bcf_decoded_columns, is_bcf
from haplohyped_tpu_torch.hostio.tabix import build_index, region_virtual_offset
from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.ops.vcf_decode import decode_frames_numpy

from tests.test_writer import RECORDS

PAIRS = {"port": (bgzf, writer), "jax": (jax_bgzf, jax_writer)}


def demo_header(w, samples=("s1", "s2")):
    h = w.VcfHeader("VCF4.2")
    h.add_contig("chr22", length=50_000)
    h.add_contig("chrX")
    h.add_filter("PASS", "All filters passed")
    h.add_filter("q10", "Quality below 10")
    h.add_info("AC", "A", "Integer", "Allele count")
    h.add_info("AF", "A", "Float", "Allele frequency")
    h.add_info("DB", "0", "Flag", "dbSNP membership")
    h.add_info("GENE", "1", "String", "Gene name")
    h.add_format("GT", "1", "String", "Genotype")
    h.add_format("DP", "1", "Integer", "Depth")
    h.set_samples(list(samples))
    return h


LINES = [
    "chr22\t50\trs9\tA\tC\t.\tq10\tAC=1;GENE=TP53\tGT:DP\t0|1:7\t1/1:3",
    "chr22\t60\t.\tC\t.\t.\t.\t.\tGT\t0\t1",  # REF-only, haploid calls
    "chrX\t70\t.\tG\tA\t3.25\tPASS;q10\tDB\tDP:GT\t4:1|0\t9:./.",
]


def write(pkg: str, path: str, mode=None) -> str:
    """Every record of the writer tests and ``LINES`` through ``pkg``'s writer."""
    _, w = PAIRS[pkg]
    with w.VcfWriter(path, header=demo_header(w), mode=mode) as out:
        for chrom, pos, ref, alt, vid, qual, filt, info, gts, ph in RECORDS:
            out.write_record(chrom, pos, ref, alt, id=vid, qual=qual, filters=filt,
                             info=info, gts=np.array(gts), phased=ph)
        for line in LINES:
            out.write_line(line)
    return path


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("threads", [1, 4])
def test_bgzf_compress_matches_jax(level, threads):
    rng = np.random.default_rng(level)
    data = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes() + b"ACGT\t" * 40_000
    got = bgzf.bgzf_compress(data, level=level, threads=threads)
    assert got == jax_bgzf.bgzf_compress(data, level=level, threads=threads)
    assert gzip.decompress(got) == data and got.endswith(bgzf.EOF_BLOCK)


def test_bgzf_constants_and_empty_input(tmp_path):
    assert bgzf.EOF_BLOCK == jax_bgzf.EOF_BLOCK and len(bgzf.EOF_BLOCK) == 28
    assert bgzf.BLOCK_PAYLOAD == jax_bgzf.BLOCK_PAYLOAD == 0xFF00
    assert bgzf.bgzf_compress(b"") == jax_bgzf.bgzf_compress(b"") == bgzf.EOF_BLOCK
    bgzf.bgzf_write(str(tmp_path / "a.gz"), b"hello\n" * 999, level=3)
    jax_bgzf.bgzf_write(str(tmp_path / "b.gz"), b"hello\n" * 999, level=3)
    assert (tmp_path / "a.gz").read_bytes() == (tmp_path / "b.gz").read_bytes()


def test_bgzf_writer_matches_jax_with_virtual_offsets(tmp_path):
    payload = b"".join(f"line{i}\n".encode() for i in range(40_000))
    cuts = [0, 7, 65_279, 65_280, 100_000, len(payload)]
    offs = {}
    for pkg, (b, _) in PAIRS.items():
        offs[pkg] = []
        with b.BgzfWriter(str(tmp_path / pkg), level=1) as w:
            for lo, hi in zip(cuts, cuts[1:]):
                offs[pkg].append(w.tell_virtual())
                w.write(payload[lo:hi])
            offs[pkg].append(w.tell_virtual())
    assert offs["port"] == offs["jax"] and offs["port"][0] == 0
    raw = (tmp_path / "port").read_bytes()
    assert raw == (tmp_path / "jax").read_bytes()
    assert gzip.decompress(raw) == payload
    for v in offs["port"][1:]:
        assert raw[v >> 16:(v >> 16) + 2] == b"\x1f\x8b"


@pytest.mark.parametrize("mode,suffix", [("w", "vcf"), ("z", "vcf.gz"), ("b", "bcf"),
                                         ("bu", "bcf"), (None, "vcf"), (None, "vcf.gz"),
                                         (None, "bcf"), ("wz", "vcf.gz")])
def test_writer_bytes_match_jax(tmp_path, mode, suffix):
    got = write("port", str(tmp_path / f"p.{suffix}"), mode)
    want = write("jax", str(tmp_path / f"j.{suffix}"), mode)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert is_bcf(got) == (suffix == "bcf")


def test_bcf_writer_matches_jax_and_reads_back(tmp_path):
    for mode in ("b", "bu"):
        paths = {}
        for pkg, (_, w) in PAIRS.items():
            paths[pkg] = str(tmp_path / f"{pkg}_{mode}.bcf")
            with w.BcfWriter(paths[pkg], header=demo_header(w), mode=mode) as out:
                for line in LINES:
                    out.write_line(line)
                out.write_record("chr22", 412, "TA", "T", gts=np.array([[0, 1], [1, 1]]))
        assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
        cols = bcf_decoded_columns(paths["port"], "s1")
        np.testing.assert_array_equal(cols["start"], [49, 59, 69, 411])
        np.testing.assert_array_equal(cols["stop"], [50, 60, 70, 413])
    with pytest.raises(ValueError, match="'b' or 'bu'"):
        writer.BcfWriter(str(tmp_path / "x.bcf"), mode="z")


@pytest.mark.parametrize("suffix", ["vcf", "vcf.gz", "bcf"])
def test_written_files_read_back_through_the_port(tmp_path, suffix):
    """Every record the writer took comes back through the port's readers,
    the frames of the text file's numpy decode equal to the BCF parse."""
    path = write("port", str(tmp_path / f"t.{suffix}"))
    text = write("port", str(tmp_path / "ref.vcf"))
    want = decode_frames_numpy(VCFSource(text).frame(sample="s2").records)
    if suffix == "bcf":
        got = bcf_decoded_columns(path, "s2")
    else:
        got = decode_frames_numpy(VCFSource(path).frame(sample="s2").records)
        assert VCFSource(path).samples() == ["s1", "s2"]
        assert VCFSource(path).seqnames() == ["chr22", "chrX"]
    for k in ("start", "stop", "snp_mask"):
        np.testing.assert_array_equal(got[k], want[k], k)
    keep = want["snp_mask"]
    for k in ("phase1", "phase2"):
        np.testing.assert_array_equal(got[k][keep], want[k][keep], k)
    assert len(got["start"]) == len(RECORDS) + len(LINES)


def test_bgzf_vcf_is_indexable(tmp_path):
    path = write("port", str(tmp_path / "t.vcf.gz"))
    idx = build_index(path)
    assert os.path.exists(idx) and region_virtual_offset(path, "chrX", 0) > 0


def test_header_queries_match_jax(tmp_path):
    h, jh = demo_header(writer), demo_header(jax_writer)
    for q in ("get_samples", "get_seqnames", "as_string", "bcf_dict", "bcf_contig_dict"):
        assert getattr(h, q)() == getattr(jh, q)(), q
    for tag in ("AC", "AF", "DB", "GENE", "NOPE"):
        assert h.info_type(tag) == jh.info_type(tag)
    assert h.bcf_dict()["PASS"] == 0 and h.info_type("AF") == "Float"
    for hh in (h, jh):
        hh.set_version("VCF4.3")
        hh.remove_contig("chrX")
        hh.remove_info("DB")
        hh.remove_format("DP")
        hh.remove_filter("q10")
        hh.add_line("##source=test")
    assert h.as_string() == jh.as_string() and h.get_seqnames() == ["chr22"]
    text = h.as_string()
    assert writer.VcfHeader.from_text(text).lines == jax_writer.VcfHeader.from_text(text).lines
    path = write("port", str(tmp_path / "h.vcf.gz"), "z")
    got, want = writer.VcfHeader.from_file(path), jax_writer.VcfHeader.from_file(path)
    assert got.lines == want.lines and got.samples == want.samples == ["s1", "s2"]
    with pytest.raises(ValueError, match="not a meta line"):
        h.add_line("#CHROM")


def test_writer_refusals(tmp_path):
    w = writer.VcfWriter(str(tmp_path / "x.vcf"), header=demo_header(writer))
    with pytest.raises(RuntimeError, match="contig id chr9 not found"):
        w.write_line("chr9\t10\t.\tA\tG\t.\tPASS\t.")
    with pytest.raises(RuntimeError, match="error parsing"):
        w.write_line("chr22\t10\t.\tA")
    w.close()
    with pytest.raises(ValueError, match="bad mode"):
        writer.VcfWriter(str(tmp_path / "y.vcf"), mode="q")
    b = writer.VcfWriter(str(tmp_path / "y.bcf"), header=demo_header(writer))
    with pytest.raises(RuntimeError, match="INFO tag XX not found"):
        b.write_line("chr22\t10\t.\tA\tG\t.\tPASS\tXX=1\tGT\t0|1\t1|1")
    b.close()
    p = str(tmp_path / "empty.vcf")
    writer.VcfWriter(p, header=demo_header(writer)).close()
    assert open(p).read() == demo_header(writer).as_string()
