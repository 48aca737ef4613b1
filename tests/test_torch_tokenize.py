"""The port's raw-text tokenizer against the JAX package's.

``tokenize_lines`` runs as torch ops on the CPU here and must give the JAX
tokenizer's 15 columns, in its dtypes, bit for bit on every row: hand-made
edge lines at every window width (lines with too few fields, an empty ALT,
POS 0 and past uint32, CRLF, haploid last fields, missing genotypes, a
FORMAT without GT first, long chromosome names, lines longer than the
window), random bytes at random offsets, and whole corpora through
``tokenize_vcf_device``.  The converter's tokenizer branch must give the JAX
converter's structs and the port's 64-byte route's.  One ``cuda``-marked
test holds the card against the CPU.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haplohyped_tpu.hostio import native as jax_native
from haplohyped_tpu.ops import vcf_tokenize as jax_tok
from haplohyped_tpu.pipeline import vcf_to_h5 as jax_vcf_to_h5
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter as JaxConverter

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.ops import vcf_tokenize as tok
from haplohyped_tpu_torch.pipeline import vcf_to_h5
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import VCFtoHDF5Converter

from tests.synth import make_corpus
from tests.test_vcf_decode import corpus_samples

HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\n"

#: one edge case a line (space-separated fields, "~" an empty field)
EDGE_ROWS = """\
chr1 100 . A G . PASS . GT 0|1 1|0
chr1 200 . A G
chr1 210 . A
chr1 300 . A ~ . PASS . GT 0|1 1|1
chr1 0 . A G . PASS . GT 1|1 0|0
chr1 4294967296 . C T . PASS . GT 0|1 0|1
chr1 9999999999 . C T . PASS . GT 1|0 0|1
chr1 12345678901 . C T . PASS . GT 0|1 1|1
chr1 ~ . C T . PASS . GT 0|1 1|1
chr1 5x7 . C T . PASS . GT 0|1 1|1
chr1 600 . T A . PASS . GT ./. .|1
chr1 610 . T A . PASS . GT 1|. 0/.
chr1 620 . T A . PASS . GT 1 0/1
chr1 700 . A C . PASS . DP:GT 3:0|1 4:1|1
chr1 710 . A C . PASS . GTX 0|1 1|1
chr1 720 . A C . PASS . GT:DP 0|1:3 1/1:4
chr1 730 . A C . PASS . GT 0|1
chr1 740 . AC C . PASS . GT 0|1 1|0
chr1 750 . a c . PASS . GT 0|1 1|0
chr1 760 . A * . PASS . GT 0|1 1|0
chromosome_22_long 800 . A G . PASS . GT 0|1 1|0
chrUn_KI270302v1 810 . A G . PASS . GT 1|1 1|0
chr1 900 . A G . PASS LONG GT 0|1 1|0
chr1 910 . A G . PASS . GT 0|1 1|0 extra
chr1 920 . A G . PASS . ~ 0|1 1|0
chr1 930 . A G . PASS . GT ~ 1|0"""
CRLF_ROWS = (0, 5, 10, 20)


def edge_vcf(long_len: int, last_field: str = "1", newline: bool = True) -> str:
    """The edge rows with a LONG INFO of ``long_len`` bytes, CRLF endings on
    ``CRLF_ROWS``, and a last line whose last field is the haploid
    ``last_field``, with or without a final newline."""
    lines = []
    for i, row in enumerate(EDGE_ROWS.splitlines()):
        line = "\t".join("" if f == "~" else f for f in row.split(" "))
        lines.append(line.replace("LONG", "X" * long_len) + ("\r" if i in CRLF_ROWS else ""))
    lines.append(f"chr1\t1000\t.\tA\tG\t.\tPASS\t.\tGT\t0|1\t{last_field}")
    return HEADER + "\n".join(lines) + ("\n" if newline else "")


def jax_lines(text, offs, lens, W, sample_col, with_sample):
    out = jax_tok.tokenize_lines(jnp.asarray(text), jnp.asarray(offs), jnp.asarray(lens), W=W,
                                 sample_col=sample_col, with_sample=with_sample)
    return {k: np.asarray(v) for k, v in out.items()}


def port_lines(text, offs, lens, W, sample_col, with_sample):
    out = tok.tokenize_lines(torch.from_numpy(text), torch.from_numpy(offs),
                             torch.from_numpy(lens), W=W, sample_col=sample_col,
                             with_sample=with_sample)
    return {k: v.numpy() for k, v in out.items()}


def assert_columns_equal(got: dict, want: dict, what=""):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {k}: {g.dtype}{g.shape}"
        bad = np.flatnonzero((g != w).reshape(g.shape[0], -1).any(axis=1)) if g.size else []
        assert len(bad) == 0, f"{what} {k}: rows {list(bad)[:8]}"


def padded(text: np.ndarray, W: int) -> np.ndarray:
    """JAX's whole-file layout: whole rows of W plus one zero row."""
    out = np.zeros((-(-text.shape[0] // W) + 1) * W, np.uint8)
    out[: text.shape[0]] = text
    return out


@pytest.mark.parametrize("W", [128, 256, 1024, 4096])
@pytest.mark.parametrize("last", ["0", "1"])
def test_edge_lines_match_jax(tmp_path, W, last):
    """Every column of every edge row, at each window width, for both
    samples: the long row's INFO W - 20 bytes (the line past W) and the last
    line ending in a haploid call."""
    path = tmp_path / "edge.vcf"
    path.write_text(edge_vcf(W - 20, last_field=last, newline=last == "1"))
    with native.vcf_text(str(path)) as vt:
        text = padded(vt.text, W)
        offs = vt.line_offsets.astype(np.int32)
        lens = vt.line_lengths.copy()
    assert (lens > W).sum() == 1 and lens.shape[0] == len(EDGE_ROWS.splitlines()) + 1
    for sample_col in (0, 1):
        got = port_lines(text, offs, lens, W, sample_col, True)
        assert_columns_equal(got, jax_lines(text, offs, lens, W, sample_col, True),
                             f"W={W} sample {sample_col}")
    assert got["long_line"].sum() == 1 and not got["valid"][1]


def test_edge_lines_without_a_sample_match_jax(tmp_path):
    path = tmp_path / "edge.vcf"
    path.write_text(edge_vcf(200))
    with native.vcf_text(str(path)) as vt:
        text, offs, lens = padded(vt.text, 128), vt.line_offsets.astype(np.int32), vt.line_lengths.copy()
    for sample_col, with_sample in ((-1, True), (0, False)):
        assert_columns_equal(port_lines(text, offs, lens, 128, sample_col, with_sample),
                             jax_lines(text, offs, lens, 128, sample_col, with_sample))


@pytest.mark.parametrize("W", [128, 256])
def test_random_bytes_at_random_offsets_match_jax(W):
    """Lines of VCF-ish random bytes cut at random offsets and lengths
    (past the window, past the text, empty), so every field boundary case
    and the row clamp at the text's end are met."""
    rng = np.random.default_rng(W)
    alphabet = np.frombuffer(b"\t\t\t\t0123456789||//..::GTACgtN*,\r\nchr", np.uint8)
    text = padded(rng.choice(alphabet, 20 * W), W)
    n = 2048
    offs = rng.integers(0, text.shape[0] + 2 * W, n).astype(np.int32)
    lens = rng.integers(0, 3 * W, n).astype(np.int32)
    lens[::7] = rng.integers(0, 40, lens[::7].shape[0])
    for sample_col in (0, 3):
        assert_columns_equal(port_lines(text, offs, lens, W, sample_col, True),
                             jax_lines(text, offs, lens, W, sample_col, True), f"col {sample_col}")


def test_no_lines():
    text = np.zeros(256, np.uint8)
    got = port_lines(text, np.zeros(0, np.int32), np.zeros(0, np.int32), 128, 0, True)
    assert_columns_equal(got, jax_lines(text, np.zeros(0, np.int32), np.zeros(0, np.int32),
                                        128, 0, True))


@pytest.mark.parametrize("n,cap,want", [(0, 4096, 128), (90, 4096, 128), (128, 4096, 128),
                                        (129, 4096, 256), (1025, 4096, 2048),
                                        (100_000, 4096, 4096), (5000, 1024, 1024)])
def test_choose_window(n, cap, want):
    assert tok.choose_window(n, cap) == jax_tok.choose_window(n, cap) == want


def whole_file(path, sample, **kw):
    with native.vcf_text(path, threads=2) as vt:
        got = tok.tokenize_vcf_device(vt, sample, device="cpu", **kw)
    jvt = jax_native.vcf_text(path, threads=2)
    try:
        want = {k: np.asarray(v) for k, v in jax_tok.tokenize_vcf_device(jvt, sample, **kw).items()}
    finally:
        jvt.close()
    assert_columns_equal(got, want, f"{path} {sample}")
    return got


def wide_vcf(path, n_samples=200, n_var=300, seed=9) -> list[str]:
    """A 200-sample VCF (~0.9 kB lines: W=1024)."""
    rng = np.random.default_rng(seed)
    samples = [f"s{i:03d}" for i in range(n_samples)]
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./.", "0/1", "1"])
    with gzip.open(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        for i in range(n_var):
            row = "\t".join(rng.choice(gts, n_samples))
            f.write(f"chr9\t{1000 + i * 7}\trs{i}\tA\tG\t.\tPASS\t.\tGT\t{row}\n")
    return samples


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("tok")), n_variants=500, n_samples=4,
                       missing_rate=0.05, indel_rate=0.1)


def test_device_synth_corpus_matches_jax(corpus):
    for sample in [None] + corpus["samples"]:
        whole_file(corpus["vcf"], sample)
    # chunks of lines change nothing
    whole_file(corpus["vcf"], corpus["samples"][1], chunk_lines=77)


def test_device_reference_corpus_matches_jax(test_data_dir):
    path = str(test_data_dir / "chr22.filtered.vcf.gz")
    for sample in [None] + corpus_samples(test_data_dir):
        got = whole_file(path, sample)
    assert got["valid"].all() and got["start"].shape == (1000,)


def test_device_wide_corpus_matches_jax(tmp_path):
    path = str(tmp_path / "wide.vcf.gz")
    samples = wide_vcf(path)
    for sample in (samples[0], samples[97], samples[199]):
        got = whole_file(path, sample)
    assert not got["long_line"].any()
    got = whole_file(path, samples[5], window_cap=512)  # every line past the window
    assert got["long_line"].all() and not got["valid"].any()


def test_device_unknown_sample_and_empty_file(corpus, tmp_path):
    with native.vcf_text(corpus["vcf"]) as vt:
        with pytest.raises(RuntimeError, match="sample not found"):
            tok.tokenize_vcf_device(vt, "ghost", device="cpu")
    path = tmp_path / "empty.vcf"
    path.write_text(HEADER)
    got = whole_file(str(path), "s1")
    assert got["start"].shape == (0,) and got["chrom"].shape == (0, 8)


def test_device_refuses_offsets_past_int32():
    class Huge:  # the offsets of a > 2 GiB text, without its bytes
        samples = ["s1"]
        n_lines = 2
        line_offsets = np.array([0, 2**31 - 100], np.int64)
        line_lengths = np.array([50, 50], np.int32)
        text = np.zeros(0, np.uint8)

    with pytest.raises(ValueError, match="tokenize_vcf_streaming"):
        tok.tokenize_vcf_device(Huge(), "s1", device="cpu")


@pytest.fixture(scope="module")
def many_contigs(tmp_path_factory):
    """chr1.filtered.vcf.gz: 300 contigs, 3 donors, SNVs, indels and
    missing genotypes; one line longer than the tokenizer's window in a
    sibling directory."""
    d = tmp_path_factory.mktemp("ctg300")
    rng = np.random.default_rng(11)
    donors = ["d0", "d1", "d2"]
    head = ["##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(donors)]
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./.", "0/1", "1"])
    rows = []
    for i in range(1200):
        chrom = "chr1" if i % 4 == 0 else f"c{i % 299:03d}"  # distinct in S5
        ref, alt = rng.choice(list("ACGT"), 2, replace=False)
        alt = alt if i % 9 else "AT"
        rows.append(f"{chrom}\t{1000 + 10 * i}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t"
                    + "\t".join(rng.choice(gts, 3)))
    for sub, extra in (("short", []), ("long", [f"chr1\t5\t.\tA\tG\t.\tPASS\t{'X' * 5000}\tGT"
                                                "\t0|1\t1|0\t1|1"])):
        (d / sub).mkdir()
        with gzip.open(d / sub / "chr1.filtered.vcf.gz", "wt") as f:
            f.write("\n".join(head + extra + rows) + "\n")
        (d / sub / "samples.txt").write_text("\n".join(donors) + "\n")
    return d


#: the converter's decode-kernel wrappers, which the tests count
WRAPPERS = {name: getattr(vcf_to_h5, name)
            for name in ("decode_frames_kernel", "decode_frames12_kernel")}


def _parse(many_contigs, sub, donor, region, monkeypatch, **kw):
    """The port's parse_snps with the decode kernels' wrappers counted."""
    calls = []
    for name, wrapped in WRAPPERS.items():
        monkeypatch.setattr(vcf_to_h5, name,
                            lambda *a, _w=wrapped, _n=name, **k: calls.append(_n) or _w(*a, **k))
    d = many_contigs / sub
    conv = VCFtoHDF5Converter("co", str(d), str(d / "out"), str(d / "samples.txt"), 1, 1,
                              single_pass=False, device="cpu", **kw)
    return conv.parse_snps(str(d / "chr1.filtered.vcf.gz"), donor, region), calls


@pytest.mark.parametrize("sub", ["short", "long"])
@pytest.mark.parametrize("donor", ["d0", "d2"])
def test_parse_snps_tokenizer_branch_matches_jax(many_contigs, monkeypatch, sub, donor):
    """A > 255-contig file without a region: the 12-byte framer refuses and
    the tokenizer runs (no decode kernel); a line past the window sends the
    file on to the 64-byte route, as in the JAX package.  Structs byte-equal
    to the JAX converter's tokenizer branch and to the port's 64-byte route."""
    (got, n), calls = _parse(many_contigs, sub, donor, None, monkeypatch, use_tokenizer=True)
    assert calls == ([] if sub == "short" else ["decode_frames_kernel"])
    (want64, n64), calls64 = _parse(many_contigs, sub, donor, None, monkeypatch)
    assert calls64 == ["decode_frames_kernel"]
    monkeypatch.setattr(jax_vcf_to_h5, "_device_transfer_healthy", lambda **kw: True)
    d = many_contigs / sub
    jconv = JaxConverter("co", str(d), str(d / "jout"), str(d / "samples.txt"), 1, 1,
                         single_pass=False)
    jconv.config = jconv.config.replace(use_tokenizer=True)
    want, jn = jconv._parse_snps(str(d / "chr1.filtered.vcf.gz"), donor, None)
    assert n == n64 == jn == 1200 + (sub == "long")
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes() == want64.tobytes()
    assert len(got) > 600 and len(set(got["chrom"])) > 255


def test_parse_snps_with_a_region_keeps_the_12_byte_route(many_contigs, monkeypatch):
    (got, _), calls = _parse(many_contigs, "short", "d1", "chr1", monkeypatch, use_tokenizer=True)
    (want, _), _ = _parse(many_contigs, "short", "d1", "chr1", monkeypatch)
    assert calls == ["decode_frames12_kernel"] and got.tobytes() == want.tobytes()


@pytest.mark.cuda
def test_card_matches_cpu(corpus, tmp_path):
    """tokenize_vcf_device on the card, bit-equal to the CPU, on the corpus,
    the edge lines and the wide corpus."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    path = tmp_path / "edge.vcf"
    path.write_text(edge_vcf(1000))
    wide = str(tmp_path / "wide.vcf.gz")
    wide_vcf(wide)
    for p, sample in ((corpus["vcf"], corpus["samples"][0]), (str(path), "s2"), (wide, "s150")):
        with native.vcf_text(p) as vt:
            cpu = tok.tokenize_vcf_device(vt, sample, device="cpu")
            card = tok.tokenize_vcf_device(vt, sample, device="cuda")
        assert_columns_equal(card, cpu, p)
